// Gated one-to-all block convolution for Hopper (sm_90a) on the paper's
// bitmask-compressed weights, decoded inside the kernel, on the int8
// tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/gated_one_to_all.py
// (gated_one_to_all_pallas, body _kernel): the unfused kernel executor's
// conv (core/plan.py), run wherever the fused chain is off -- the layers
// that pool their drive before the LIF (pool_drive), and every encode and
// 3x3 layer when the tdBN drives are recorded (taps=).
//
//   out[m, y, x, k] = sum over live taps (dy, dx) and channels c of
//                     x[m, clamp(y+dy), clamp(x+dx), c] * W[tap, c, k]
//
// with the neighbour coordinates clamped into the pixel's bh x bw block
// (block convolution), u8 inputs (binary spikes, or the encode layer's u8
// pixels) times int8 weights into int32: exact in any order (the largest
// |sum| is 255*127*49*C < 2^31 for C <= 512).
//
// The conv is igemm_conv.cuh's, the fused kernel's conv of one time step,
// with the M images in place of the time steps and the int32 sums written
// out in place of the LIF epilogue:
//  * a GEMM per image on mma.sync m16n8k32 u8 x s8 -> s32: rows = a pixel
//    tile, columns = a tile of 16, 32 or 64 output channels, K-dim = the
//    live taps x C, padded to 32. The M images fold into the pixel tiles,
//    one image per pass, so that every map fills the card with persistent
//    blocks (batching 4 images per pass, sharing the B fragments as the
//    fused kernel batches time steps, measured no faster at any shape of
//    the detector and slower at stage2-4, PERF.md);
//  * the B operand is the compressed weights: only maskp, vals and tap_any
//    are read, as the TPU kernel does. Each persistent block lists the taps
//    alive in any K-block its channel tile touches (tap_any; a tap dead in
//    one of those K-blocks has zero weights there, so the sum is the same:
//    the TPU kernel's pl.when(tap_any > 0) at tile granularity), ranks
//    those K-blocks' mask rows and decodes its tile over the live K-dim
//    into shared memory once (common.cuh's rank walk; value indices clipped
//    to VPAD - 1 like the TPU gather), then walks its pixel tiles and
//    images with it. A tile whose decoded K-dim does not fit is decoded one
//    K-dim segment at a time, each segment's sums added into the output;
//  * the A operand: a clamped halo tile read by ldmatrix at each tap's
//    shift wherever it fits (C % 32 == 0, and C == 16 with two taps'
//    16-byte rows per k-step: Params::kHalo = kHaloAny), else im2col
//    cp.async gathers (1x1 kernels, C of 8 or 24 ..., K-dim segments);
//  * the int32 sums of each image pass through shared memory, so that each
//    warp writes whole lines of (M, H, W, kout) with 16-byte stores
//    (element by element where kout % 4 != 0).
//
// What bounds it on this card: bytes. The int32 output dominates (4 bytes
// per output value against 1 byte per input pixel-channel and a few KB of
// compressed weights); the int8 products of the live taps take a fraction
// of that at the tensor cores' rate.
//
// Layouts (all contiguous):
//  x       (M, H, W, C)           uint8, C % 8 == 0
//  maskp   (KB, kh*kw, C/8, KBLK) uint8, KBLK % 4 == 0
//  vals    (KB, VPAD)             int8
//  tap_any (KB, kh*kw)            int32
//  out     (M, H, W, kout)        int32, kout <= KB*KBLK
//
// One image's H*W must stay below 2^31 (the loop's pixel indices are 32
// bit); the launch refuses larger images (such an image's input alone is
// 16 GB at C = 8).
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "igemm_conv.cuh"

namespace {

using namespace igemm;

struct Params : Conv {
  static constexpr int kHalo = kHaloAny;  // halo tiles wherever they fit
  const int* tap_any;
  int* out;
};

// The tiles ask for 2 blocks per SM (at most 128 registers a thread; 3
// and 85 for the 16-channel tile, as in the fused kernel): their items are
// short, and a second block hides one block's barriers.
template <int NI, int WM, int WN>
__global__ void __launch_bounds__(kThreads, WN * 8 * NI == 16 ? 3 : 2)
    gated_one_to_all_kernel(const Params p) {
  using T = Tile<1, NI, WM, WN>;  // one image per pass
  constexpr int BP = T::BP, BN = T::BN;
  extern __shared__ __align__(16) uint8_t smem[];
  int* stage = reinterpret_cast<int*>(smem + p.off_stage);  // [BP][SF] int32
  int* live_n = reinterpret_cast<int*>(smem + p.off_extra);
  int* tdh = reinterpret_cast<int*>(smem + p.off_taps);  // [kMaxTaps] x 3
  int* tdw = tdh + kMaxTaps;
  int* toff = tdw + kMaxTaps;
  int* units = reinterpret_cast<int*>(smem + p.off_units);
  const int tid = threadIdx.x;
  const int n0 = blockIdx.y * BN;
  const bool halo = p.halo;

  // the taps alive in any K-block the channel tile touches, in tap order
  if (tid == 0) {
    const int kb0 = n0 / p.kblk, kb1 = (min(n0 + BN, p.kp) - 1) / p.kblk;
    int n = 0;
    for (int t = 0; t < p.taps_total; ++t) {
      bool any = false;
      for (int kb = kb0; kb <= kb1; ++kb) any |= __ldg(p.tap_any + kb * p.taps_total + t) != 0;
      if (any) {
        tdh[n] = t / p.kw - p.pad;
        tdw[n] = t % p.kw - p.pad;
        ++n;
      }
    }
    *live_n = n;
  }
  __syncthreads();
  const int n_live = *live_n, kreal = n_live * p.c;
  const int kpad = round_up(kreal > 0 ? kreal : 32, 32);  // all dead: one k-step of zeros

  // an image's int32 sums of a pass -> out, through the staging tile;
  // ``add``: a later K-dim segment, added to the earlier ones' sums (each
  // thread reads back only what it wrote itself)
  auto store = [&](const int (&acc)[T::NI][4], int t, const int* rp, bool add) {
#pragma unroll
    for (int ni = 0; ni < T::NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; e += 2)
        *reinterpret_cast<int2*>(stage + T::row(e) * T::SF + T::col(ni, e)) =
            make_int2(acc[ni][e], acc[ni][e + 1]);
    __syncthreads();
    int* dst = p.out + (long long)t * p.npix * p.kout;
    const bool vec = p.kout % 4 == 0;
    for (int e = tid; e < BP * BN / 4; e += kThreads) {
      const int r = e / (BN / 4), c = (e % (BN / 4)) * 4;
      const int pix = rp[r];
      if (pix < 0 || n0 + c >= p.kout) continue;
      int4 val = *reinterpret_cast<const int4*>(stage + r * T::SF + c);
      int* d = dst + (long long)pix * p.kout + n0 + c;
      if (vec) {
        if (add) {
          const int4 o = *reinterpret_cast<const int4*>(d);
          val = make_int4(val.x + o.x, val.y + o.y, val.z + o.z, val.w + o.w);
        }
        *reinterpret_cast<int4*>(d) = val;
      } else {
        const int v4[4] = {val.x, val.y, val.z, val.w};
        for (int j = 0; j < 4 && n0 + c + j < p.kout; ++j) d[j] = add ? d[j] + v4[j] : v4[j];
      }
    }
    __syncthreads();
  };

  for (int kbase = 0; kbase < kpad; kbase += p.kseg) {  // one segment unless it does not fit
    const int klen = min(p.kseg, kpad - kbase);
    const Geo gm{n_live, kreal, kbase, klen, halo ? p.c / p.cc : (klen + p.kc - 1) / p.kc};
    __syncthreads();  // the previous segment's tables and weights are no longer read
    fill_tables(p, gm, halo, tdh, tdw, toff, units);
    decode_weights<BN>(p, gm, smem, n0, tdh, tdw, reinterpret_cast<int*>(smem + p.off_rows),
                       reinterpret_cast<int*>(smem + p.off_partial));
    const bool add = kbase > 0;
    conv_tiles<T>(p, gm, smem, n0, [&](int (&acc)[1][T::NI][4], int ps, int, const int* rp) {
      store(acc[0], ps, rp, add);
    });
  }
}

// The plan of the last launch, for diagnostics (launch_persistent).
int g_last_plan[kPlanInts];

template <int NI, int WM, int WN>
int launch_tile(Params& p, cudaStream_t s) {
  using T = Tile<1, NI, WM, WN>;
  const int smem = plan_smem(p, 1, T::BP, T::BN, true, 16, true);
  return launch_persistent<T>(gated_one_to_all_kernel<NI, WM, WN>, p, smem, s, g_last_plan);
}

// Tiles by shape, as the fused kernel's launch() chooses them for one step
// per pass: 128 pixels x 16 or 32 channels for narrow layers, 64 x 64 for
// wide ones, or 32 x 64 where 64-pixel tiles would leave SMs idle.
int launch(Params& p, int m, cudaStream_t s) {
  const long long hw = p.npix;
  if (hw * m < 0x7fffffffLL) {  // (M, H, W) as one step of M images
    p.t_in = 1;
    p.npix = hw * m;
  } else {
    p.t_in = m;
  }
  if (p.kout <= 16) return launch_tile<2, 8, 1>(p, s);
  if (p.kout <= 32) return launch_tile<4, 8, 1>(p, s);
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long blocks64 = ((hw * m + 63) / 64) * ((p.kout + 63) / 64);
  if (blocks64 >= (sms > 0 ? sms : 132)) return launch_tile<4, 4, 2>(p, s);
  return launch_tile<2, 2, 4>(p, s);
}

}  // namespace

extern "C" int gated_one_to_all_launch(
    const void* x, const void* maskp, const void* vals, const void* tap_any,
    void* out, int m, int h, int w, int c, int kout, int kb_total, int kblk,
    int vpad, int kh, int kw, int bh, int bw, void* stream) {
  if (m < 0 || h < 1 || w < 1 || c < 8 || c % 8 != 0 || c > 0xffff || kblk < 4 ||
      kblk % 4 != 0 || kb_total < 1 || kout < 1 || kout > kb_total * kblk || vpad < 1 ||
      kh != kw || kh % 2 != 1 || kh * kw > kMaxTaps || bh < 1 || bw < 1 || h % bh != 0 ||
      w % bw != 0 || (long long)h * w >= 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  Params p{};
  p.x = static_cast<const uint8_t*>(x);
  p.maskp = static_cast<const uint8_t*>(maskp);
  p.vals = static_cast<const int8_t*>(vals);
  p.tap_any = static_cast<const int*>(tap_any);
  p.out = static_cast<int*>(out);
  p.npix = (long long)h * w;  // one image; launch() folds M in
  p.h = h;
  p.w_ = w;
  p.c = c;
  p.kout = kout;
  p.kp = kb_total * kblk;
  p.kw = kw;
  p.pad = (kh - 1) / 2;
  p.bh = bh;
  p.bw = bw;
  p.kblk = kblk;
  p.vpad = vpad;
  p.taps_total = kh * kw;
  p.n_live = kh * kw;  // the plan's bound: each block narrows to its tile's live taps
  for (int t = 0; t < kh * kw; ++t) p.taps[t] = t;
  return launch(p, m, static_cast<cudaStream_t>(stream));
}

// The tiling of the last launch: see launch_persistent.
extern "C" void gated_one_to_all_last_plan(int* out) {
  std::copy(g_last_plan, g_last_plan + kPlanInts, out);
}
