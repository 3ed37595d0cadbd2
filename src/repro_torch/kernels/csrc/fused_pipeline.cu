// Fused layer pipeline for Hopper (sm_90a): block conv over the live taps
// -> FXP rescale -> tdBN inference affine -> LIF over t_out steps, the
// membrane kept in registers across the time loop.
//
// Replaces the TPU kernel src/repro/kernels/fused_pipeline.py
// (fused_pipeline_pallas, body _kernel) in both its weight modes:
//  * predecoded (the serving path): the live taps' dense int8 weights,
//    decoded once per plan on the host;
//  * packed: the paper's bitmask-compressed weights (maskp bits + packed
//    nonzero values per K-block), decoded inside the kernel with the rank
//    walk of common.cuh.
// The two differ only in how a block's weights reach shared memory; the
// main loop is the same.
//
// The conv of one time step is a GEMM: M = the block's pixel tile, N = its
// output-channel tile, K-dim = live taps x C (zero-padded to a multiple of
// 32). It runs on the tensor cores, mma.sync m16n8k32 u8 x s8 -> s32:
// binary spikes, or the encode layer's u8 pixels (the exact fold of its 8
// bit-serial planes), times int8 weights. Integer sums are exact in any
// order: the largest |acc| at the detector's widths is 2304*255*127 < 2^31.
//
// What bounds it on this card: the byte bound (the f32 membrane and the
// spikes it writes) is 6-40x below its times (PERF.md). What it waits on
// instead, from clock64 phase counts on the card: the A operand's gathers
// from L2 (im2col mode), the chains of dependent mma.sync per warp, the
// 148 KB weight copy per block at the 3x3 256-channel layers, and the
// epilogue's stores. The design (the conv machinery below lives in
// igemm_conv.cuh, shared with gated_one_to_all.cu; this file adds the
// predecoded weight copy and the drive/LIF epilogue):
//  * weights resident: each block copies (predecoded, 16-byte loads) or
//    decodes (packed) its output-channel tile of the weights over the
//    whole K-dim into shared memory once, [channel][K-dim] bytes, and
//    reuses it across every time step and every pixel tile of a
//    persistent block. A slice that does not fit (a 7x7 layer at C = 256:
//    784 KB) is streamed in K-chunks beside the inputs through a ring of
//    B buffers: copied (predecoded), or decoded there chunk by chunk by
//    the block's threads as they issue the chunk (packed), from byte-row
//    ranks of the tile's K-blocks computed once per block. The gated
//    kernel's K-dim segments would not do here: they add partial sums
//    into an int32 output, and the LIF step needs the whole sum;
//  * the A operand, two ways, in a ring of three shared-memory buffers so
//    that two items are in flight while the tensor cores run one:
//    - im2col: a block-clamped im2col chunk per item, built by cp.async
//      gathers of 16, 8 or 4 bytes per (pixel, live tap) as C allows;
//    - halo (time-batched tiles with C % 32 == 0 and a kernel wider than
//      1x1): the pixel tile is a rectangle inside one block-conv block,
//      and an item copies cc channels of its (th+2p) x (tw+2p) halo, each
//      halo pixel already clamped to the block; ldmatrix then reads each
//      tap's A rows straight from the halo at the tap's shift, so every
//      input byte is fetched once per tile instead of once per tap;
//  * one T loop for any T: t_in == 1 runs one conv and t_out LIF steps on
//    its drive; t_in == t_out runs the steps in passes, each pass's convs
//    into fresh accumulator fragments, then the drive and the LIF step on
//    the fragment elements. Small maps batch 4 steps per pass (A rows =
//    4 x the pixel tile), so a warp has 4 independent accumulator chains
//    per n8 tile sharing its B fragments. The membrane stays in registers
//    in the accumulator fragment layout across all T (every step's
//    fragment has the same element ownership);
//  * spikes (per step), the final membrane and the warm membrane v0 pass
//    through shared memory so that global loads and stores are coalesced
//    16-byte accesses (element-wise where Kout does not allow them);
//  * tiles by shape (launch()): one step per pass over 128 pixels x 16 or
//    32 channels, or 64 (32 where 64 leaves SMs idle) x 64 channels; four
//    steps per pass over 64 x 32 or 32 x 64 for the maps of <= 8192 pixels.
//    A caller may name one of these six tiles instead (launch_named: the
//    tile a plan's autotune cache chose).
//
// Semantics kept from the TPU kernel:
//  * block convolution: each bh x bw block sees replicate padding at its
//    own border -- neighbour coordinates are clamped to the block, which
//    is the same as convolving edge-padded independent blocks;
//  * the float chain op for op on each accumulator element, every product
//    rounded on its own (__fmul_rn/__fadd_rn/__fsub_rn, and the file is
//    built -fmad=false):
//      y = float(acc)*scale; xh = (y-mean)*rinv; d = (bn_scale*xh)*gamma+beta
//      v = v*leak + d; s = v >= thr; hard: v = s ? 0 : v, soft: v = s ? v-thr : v
//    which is exactly what the plain PyTorch version computes, one eager
//    op at a time.
//
// Layouts (all contiguous):
//  x      (t_in, N, H, W, C)   uint8, C % 4 == 0 (C % 8 == 0 when packed)
//  w      (L, C/4, Kp, 4)      int8: live tap l, channel quad, out channel,
//                              the quad's 4 channel weights
//  maskp  (KB, kh*kw, C/8, KBLK) uint8: bit c%8 of byte c/8 marks w != 0
//  vals   (KB, VPAD)           int8: each K-block's nonzeros in (tap, c, k) order
//  affine (5, Kp)              f32 rows: scale, mean, rsqrt(var+eps), gamma, beta
//  v0     (N, H, W, Kout)      f32, or null for a cold start at v_init
//  spk    (t_out, N, H, W, Kout) uint8 {0,1}
//  mem    (N, H, W, Kout)      f32 final membrane
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "igemm_conv.cuh"

namespace {

using namespace igemm;

constexpr long long kTimeBatchPix = 8192;  // the largest map batched over time

struct Params : Conv {
  static constexpr int kHalo = kHaloBatched;  // halo tiles for the time-batched tiles only
  const float* affine;
  const float* v0;
  uint8_t* spk;
  float* mem;
  int t_out;
  float bn_scale, threshold, leak, v_init;
  int soft_reset;
};

// Copy the block's channel tile of the predecoded weights into shared
// memory: byte (n, l*C + c) is w[l, c/4, n0+n, c%4]; the K-dim padding is
// zero. Each 16-byte load brings one channel quad's 4 weight words (4
// batched per thread, all in flight), stored to the 4 channel rows.
template <int BN>
__device__ void load_weights(const Params& p, uint8_t* wsm, int n0) {
  constexpr int kQuads = BN / 4;  // channel quads of the tile
  const int total = p.n_live * (p.c / 4) * kQuads;
  for (int e0 = threadIdx.x; e0 < total; e0 += 4 * kThreads) {
    uint4 v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = e0 + i * kThreads, nq = e % kQuads, q = e / kQuads;
      v[i] = make_uint4(0u, 0u, 0u, 0u);
      if (e < total && n0 + 4 * nq < p.kp)
        v[i] = __ldg(reinterpret_cast<const uint4*>(p.w + ((long long)q * p.kp + n0 + 4 * nq) * 4));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = e0 + i * kThreads, nq = e % kQuads, q = e / kQuads;
      if (e >= total) continue;
      uint8_t* d = wsm + 4 * nq * p.w_stride + q * 4;
      *reinterpret_cast<uint32_t*>(d) = v[i].x;
      *reinterpret_cast<uint32_t*>(d + p.w_stride) = v[i].y;
      *reinterpret_cast<uint32_t*>(d + 2 * p.w_stride) = v[i].z;
      *reinterpret_cast<uint32_t*>(d + 3 * p.w_stride) = v[i].w;
    }
  }
  const int pad4 = (p.kpad - p.kreal) / 4;
  for (int e = threadIdx.x; e < pad4 * BN; e += kThreads) {
    const int n = e / pad4, q = e % pad4;
    *reinterpret_cast<uint32_t*>(wsm + n * p.w_stride + p.kreal + q * 4) = 0u;
  }
}

// The 16-channel one-step tile asks for 3 blocks per SM (at most 85
// registers a thread): its maps are the largest, and the extra block
// hides the gathers' and the stores' latency.
// kStream: packed weights that do not fit, decoded K-chunk by K-chunk into
// the streamed B ring (one tile instantiates it, see launch_tile).
template <int TB, int NI, int WM, int WN, bool kStream>
__global__ void __launch_bounds__(kThreads, (TB == 1 && WN * 8 * NI == 16) ? 3 : 1)
    fused_pipeline_kernel(const Params p) {
  using T = Tile<TB, NI, WM, WN>;
  constexpr int BP = T::BP, BN = T::BN;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* wsm = smem;  // resident weights, or kStages streamed B chunks
  float* stage_f = reinterpret_cast<float*>(smem + p.off_stage);
  uint8_t* stage_b = smem + p.off_stage;
  float* aff = reinterpret_cast<float*>(smem + p.off_extra);  // [5][BN]
  int* tdh = reinterpret_cast<int*>(smem + p.off_taps);       // [kMaxTaps] x 3
  int* tdw = tdh + kMaxTaps;
  int* toff = tdw + kMaxTaps;  // halo mode: a tap's byte offset in the halo
  int* units = reinterpret_cast<int*>(smem + p.off_units);  // [kpad / g]

  const int tid = threadIdx.x;
  const int n0 = blockIdx.y * BN;
  const bool halo = TB > 1 && p.halo;  // only time-batched tiles use halo mode
  const Geo gm{p.n_live, p.kreal, 0, p.kpad, p.nch};

  // per-block set-up: tap offsets, gather units, the affine rows, the weights
  for (int l = tid; l < p.n_live; l += kThreads) {
    tdh[l] = p.taps[l] / p.kw - p.pad;
    tdw[l] = p.taps[l] % p.kw - p.pad;
  }
  __syncthreads();
  fill_tables(p, gm, halo, tdh, tdw, toff, units);
  for (int e = tid; e < 5 * BN; e += kThreads) {
    const int row = e / BN, n = e % BN;
    aff[e] = n0 + n < p.kp ? __ldg(p.affine + (long long)row * p.kp + n0 + n) : 0.f;
  }
  if (p.resident) {
    if (p.maskp != nullptr)
      decode_weights<BN>(p, gm, wsm, n0, tdh, tdw, reinterpret_cast<int*>(smem + p.off_rows),
                         reinterpret_cast<int*>(smem + p.off_partial));
    else
      load_weights<BN>(p, wsm, n0);
  } else if (kStream) {
    // streamed packed weights: the byte-row ranks of each K-block the
    // channel tile touches, for the producer's chunk decode (decode_chunk)
    const int per_kb = p.taps_total * (p.c / 8), n_end = min(n0 + BN, p.kp);
    int* rank8 = reinterpret_cast<int*>(smem + p.off_rows);
    for (int kb = n0 / p.kblk; kb * p.kblk < n_end; ++kb)
      kblock_byte_row_ranks<kThreads>(p.maskp + (long long)kb * per_kb * p.kblk, per_kb, p.kblk,
                                      rank8 + (kb - n0 / p.kblk) * per_kb,
                                      reinterpret_cast<int*>(smem + p.off_partial));
  }
  __syncthreads();

  const int passes = (p.t_in + TB - 1) / TB;
  float v[T::NI][4];  // the membrane, in the accumulator fragment layout

  // f32 [BP][BN] tile of a (npix, Kout) array <-> staging, coalesced; rp:
  // each row's pixel (-1: none)
  auto tile_f32_in = [&](const float* src, const int* rp) {
    const bool vec = p.kout % 4 == 0;
    for (int e = tid; e < BP * BN / 4; e += kThreads) {
      const int r = e / (BN / 4), c = (e % (BN / 4)) * 4;
      const int pix = rp[r];
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (pix >= 0) {
        const float* s = src + (long long)pix * p.kout + n0 + c;
        if (vec) {
          if (n0 + c < p.kout) val = __ldg(reinterpret_cast<const float4*>(s));
        } else {
          if (n0 + c < p.kout) val.x = s[0];
          if (n0 + c + 1 < p.kout) val.y = s[1];
          if (n0 + c + 2 < p.kout) val.z = s[2];
          if (n0 + c + 3 < p.kout) val.w = s[3];
        }
      }
      *reinterpret_cast<float4*>(stage_f + r * T::SF + c) = val;
    }
  };
  auto tile_f32_out = [&](float* dst, const int* rp) {
    const bool vec = p.kout % 4 == 0;
    for (int e = tid; e < BP * BN / 4; e += kThreads) {
      const int r = e / (BN / 4), c = (e % (BN / 4)) * 4;
      const int pix = rp[r];
      if (pix < 0 || n0 + c >= p.kout) continue;
      const float4 val = *reinterpret_cast<const float4*>(stage_f + r * T::SF + c);
      float* d = dst + (long long)pix * p.kout + n0 + c;
      if (vec) {
        *reinterpret_cast<float4*>(d) = val;
      } else {
        d[0] = val.x;
        if (n0 + c + 1 < p.kout) d[1] = val.y;
        if (n0 + c + 2 < p.kout) d[2] = val.z;
        if (n0 + c + 3 < p.kout) d[3] = val.w;
      }
    }
  };
  auto spikes_out = [&](uint8_t* dst, const int* rp) {
    const bool vec = p.kout % 16 == 0;
    for (int e = tid; e < BP * BN / 16; e += kThreads) {
      const int r = e / (BN / 16), c = (e % (BN / 16)) * 16;
      const int pix = rp[r];
      if (pix < 0 || n0 + c >= p.kout) continue;
      const uint8_t* s = stage_b + r * T::SB + c;
      uint8_t* d = dst + (long long)pix * p.kout + n0 + c;
      if (vec) {
        *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
      } else {
        for (int j = 0; j < 16 && n0 + c + j < p.kout; ++j) d[j] = s[j];
      }
    }
  };

  // one LIF step on the drive d (f32 bits); its spikes to step t of spk
  auto lif_step = [&](const int (&d)[T::NI][4], int t, const int* rp) {
#pragma unroll
    for (int ni = 0; ni < T::NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        uint32_t s2 = 0;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float& vv = v[ni][e + j];
          vv = __fadd_rn(__fmul_rn(vv, p.leak), __int_as_float(d[ni][e + j]));
          const bool s = vv >= p.threshold;
          if (s) vv = p.soft_reset ? __fsub_rn(vv, p.threshold) : 0.0f;
          s2 |= (uint32_t)s << (8 * j);
        }
        *reinterpret_cast<uint16_t*>(stage_b + T::row(e) * T::SB + T::col(ni, e)) =
            (uint16_t)s2;
      }
    __syncthreads();
    spikes_out(p.spk + (long long)t * p.npix * p.kout, rp);
    __syncthreads();
  };

  // a pass's convs are complete: drives, then LIF; the membrane stays in
  // registers across all passes of a tile
  auto epilogue = [&](int (&acc)[TB][T::NI][4], int ps, int ntb, const int* rp) {
#pragma unroll
    for (int tb = 0; tb < TB; ++tb)
#pragma unroll
      for (int ni = 0; ni < T::NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = T::col(ni, e);
          const float y = __fmul_rn(__int2float_rn(acc[tb][ni][e]), aff[c]);
          const float xh = __fmul_rn(__fsub_rn(y, aff[BN + c]), aff[2 * BN + c]);
          const float d = __fadd_rn(__fmul_rn(__fmul_rn(p.bn_scale, xh), aff[3 * BN + c]),
                                    aff[4 * BN + c]);
          acc[tb][ni][e] = __float_as_int(d);
        }
    if (ps == 0) {  // the tile's starting membrane
      if (p.v0 == nullptr) {
#pragma unroll
        for (int ni = 0; ni < T::NI; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) v[ni][e] = p.v_init;
      } else {
        tile_f32_in(p.v0, rp);
        __syncthreads();
#pragma unroll
        for (int ni = 0; ni < T::NI; ++ni)
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            const float2 f =
                *reinterpret_cast<const float2*>(stage_f + T::row(e) * T::SF + T::col(ni, e));
            v[ni][e] = f.x;
            v[ni][e + 1] = f.y;
          }
        __syncthreads();
      }
    }
    if (p.t_in == 1) {  // one drive for every step
      for (int t = 0; t < p.t_out; ++t) lif_step(acc[0], t, rp);
    } else {
#pragma unroll
      for (int tb = 0; tb < TB; ++tb)
        if (tb < ntb) lif_step(acc[tb], ps * TB + tb, rp);
    }
    if (ps == passes - 1) {  // the tile's final membrane
#pragma unroll
      for (int ni = 0; ni < T::NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; e += 2)
          *reinterpret_cast<float2*>(stage_f + T::row(e) * T::SF + T::col(ni, e)) =
              make_float2(v[ni][e], v[ni][e + 1]);
      __syncthreads();
      tile_f32_out(p.mem, rp);
    }
  };
  conv_tiles<T, kStream>(p, gm, smem, n0, epilogue);
}

bool fill_params(Params& p, const void* x, const void* affine, const void* v0, void* spk,
                 void* mem, int t_in, int t_out, int n, int h, int w_, int c, int kout, int kp,
                 int kh, int kw, int bh, int bw, const int* taps, int n_live, float bn_scale,
                 float threshold, float leak, float v_init, int soft_reset) {
  if (t_in < 1 || t_out < 1 || (t_in != 1 && t_in != t_out) || n_live < 0 ||
      n_live > kMaxTaps || (long long)n * h * w_ >= 0x7fffffffLL ||
      c > 0xffff || c < 4 || c % 4 != 0 || kp % 4 != 0 || kout < 1 || kout > kp ||
      kh != kw || kh % 2 != 1 || bh < 1 || bw < 1 || h % bh != 0 || w_ % bw != 0)
    return false;
  p = Params{};
  p.x = static_cast<const uint8_t*>(x);
  p.affine = static_cast<const float*>(affine);
  p.v0 = static_cast<const float*>(v0);
  p.spk = static_cast<uint8_t*>(spk);
  p.mem = static_cast<float*>(mem);
  p.npix = (long long)n * h * w_;
  p.h = h;
  p.w_ = w_;
  p.c = c;
  p.kout = kout;
  p.kp = kp;
  p.kw = kw;
  p.pad = (kh - 1) / 2;
  p.bh = bh;
  p.bw = bw;
  p.t_in = t_in;
  p.t_out = t_out;
  p.n_live = n_live;
  for (int i = 0; i < n_live; ++i) {
    if (taps[i] < 0 || taps[i] >= kh * kw) return false;
    p.taps[i] = taps[i];
  }
  p.bn_scale = bn_scale;
  p.threshold = threshold;
  p.leak = leak;
  p.v_init = v_init;
  p.soft_reset = soft_reset;
  return true;
}

// The plan of the last launch, for diagnostics (launch_persistent).
int g_last_plan[kPlanInts];

// Packed weights that do not fit in shared memory go to one tile built to
// decode the streamed chunks (kStream): 32 pixels x 64 channels, 4 steps a
// pass, so a chunk is decoded once per 4 steps of a tile.
// ``named``: the caller chose this tile (launch_named), which then runs as
// it is or not at all.
template <int TB, int NI, int WM, int WN, bool kStream = false>
int launch_tile(Params& p, bool packed, cudaStream_t s, bool named = false) {
  using T = Tile<TB, NI, WM, WN>;
  const int smem = plan_smem(p, TB, T::BP, T::BN, packed, 5 * T::BN * 4, false);
  if constexpr (!kStream) {
    if (packed && smem >= 0 && !p.resident) {
      if (named) return (int)cudaErrorInvalidValue;
      return launch_tile<4, 2, 2, 4, true>(p, packed, s);
    }
  }
  return launch_persistent<T>(fused_pipeline_kernel<TB, NI, WM, WN, kStream>, p, smem, s,
                              g_last_plan);
}

// Tiles by shape, from the chip runs that PERF.md records. Large maps, or
// one conv (t_in == 1): one step per pass, 128 pixels x 16 or 32 channels
// for narrow layers; 64 x 64 for wide ones, or 32 x 64 where 64-pixel
// tiles would leave SMs idle. Small maps with a conv per step (t_in ==
// t_out > 1, npix <= kTimeBatchPix): 4 steps at once over 64 pixels x 32
// channels, or 32 x 64 for wide layers, where too few tiles leave the
// tensor cores waiting on single accumulator chains.
int launch(Params& p, bool packed, cudaStream_t s) {
  if (p.t_in > 1 && p.npix <= kTimeBatchPix) {
    if (p.kout <= 32) return launch_tile<4, 2, 4, 2>(p, packed, s);
    return launch_tile<4, 2, 2, 4>(p, packed, s);
  }
  if (p.kout <= 16) return launch_tile<1, 2, 8, 1>(p, packed, s);
  if (p.kout <= 32) return launch_tile<1, 4, 8, 1>(p, packed, s);
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long blocks64 = ((p.npix + 63) / 64) * ((p.kout + 63) / 64);
  if (blocks64 >= (sms > 0 ? sms : 132)) return launch_tile<1, 4, 4, 2>(p, packed, s);
  return launch_tile<1, 2, 2, 4>(p, packed, s);
}

// A tile named by its index in the table below (the autotuner's choice,
// repro_torch/kernels/fused_pipeline.py TILES), or -1 for launch()'s shape
// rule. A named tile that cannot run this layer is refused, never
// replaced: four steps a pass where there is one conv (t_in == 1), a
// plan that does not fit in shared memory, or packed weights that would
// have to stream (the stream tile is launch()'s own choice).
int launch_named(Params& p, bool packed, int tile, cudaStream_t s) {
  constexpr int kTb[] = {4, 4, 1, 1, 1, 1};
  if (tile == -1) return launch(p, packed, s);
  if (tile < 0 || tile > 5 || (kTb[tile] == 4 && p.t_in == 1))
    return (int)cudaErrorInvalidValue;
  switch (tile) {
    case 0: return launch_tile<4, 2, 4, 2>(p, packed, s, true);
    case 1: return launch_tile<4, 2, 2, 4>(p, packed, s, true);
    case 2: return launch_tile<1, 2, 8, 1>(p, packed, s, true);
    case 3: return launch_tile<1, 4, 8, 1>(p, packed, s, true);
    case 4: return launch_tile<1, 4, 4, 2>(p, packed, s, true);
    default: return launch_tile<1, 2, 2, 4>(p, packed, s, true);
  }
}

// The shared-memory plan of a named tile, without a launch (plan_tile).
template <int TB, int NI, int WM, int WN>
int tile_smem(Params& p, bool packed) {
  using T = Tile<TB, NI, WM, WN>;
  return plan_smem(p, TB, T::BP, T::BN, packed, 5 * T::BN * 4, false);
}

}  // namespace

// The plan launch_named would give tile ``tile`` (an index of its table)
// for a layer of c input channels, kp padded output channels and n_live
// live taps of a kh x kh kernel in bh x bw blocks, without launching: the
// dynamic shared memory in bytes (-1: the tile cannot run the layer; -2:
// the arguments describe no layer), and in *resident whether the weights
// stay resident in shared memory (a named tile refuses packed weights that
// would stream). repro_torch/kernels/fused_pipeline.py check_tile asks it
// before a named tile's first launch.
extern "C" int fused_pipeline_tile_plan(int tile, int c, int kp, int kh, int bh, int bw,
                                        int n_live, int packed, int kblk, int* resident) {
  if (tile < 0 || tile > 5 || c < 4 || c % 4 != 0 || kp < 4 || kp % 4 != 0 || kh < 1 ||
      kh % 2 != 1 || bh < 1 || bw < 1 || n_live < 0 || n_live > kMaxTaps ||
      (packed && (c % 8 != 0 || kblk < 8 || kblk % 8 != 0)))
    return -2;
  Params p{};
  p.c = c;
  p.kp = kp;
  p.pad = (kh - 1) / 2;
  p.bh = bh;
  p.bw = bw;
  p.n_live = n_live;
  p.taps_total = kh * kh;
  p.kblk = kblk;
  int smem;
  switch (tile) {
    case 0: smem = tile_smem<4, 2, 4, 2>(p, packed); break;
    case 1: smem = tile_smem<4, 2, 2, 4>(p, packed); break;
    case 2: smem = tile_smem<1, 2, 8, 1>(p, packed); break;
    case 3: smem = tile_smem<1, 4, 8, 1>(p, packed); break;
    case 4: smem = tile_smem<1, 4, 4, 2>(p, packed); break;
    default: smem = tile_smem<1, 2, 2, 4>(p, packed); break;
  }
  *resident = p.resident;
  return smem;
}

extern "C" int fused_pipeline_launch(const void* x, const void* w, const void* affine,
                                     const void* v0, void* spk, void* mem, int t_in, int t_out,
                                     int n, int h, int w_, int c, int kout, int kp, int kh,
                                     int kw, int bh, int bw, const int* taps, int n_live,
                                     float bn_scale, float threshold, float leak,
                                     float v_init, int soft_reset, int tile, void* stream) {
  Params p;
  if (!fill_params(p, x, affine, v0, spk, mem, t_in, t_out, n, h, w_, c, kout, kp, kh, kw, bh,
                   bw, taps, n_live, bn_scale, threshold, leak, v_init, soft_reset))
    return (int)cudaErrorInvalidValue;
  p.w = static_cast<const uint8_t*>(w);
  if (p.npix == 0) return 0;
  return launch_named(p, false, tile, static_cast<cudaStream_t>(stream));
}

extern "C" int fused_pipeline_packed_launch(
    const void* x, const void* maskp, const void* vals, const void* affine, const void* v0,
    void* spk, void* mem, int t_in, int t_out, int n, int h, int w_, int c, int kout,
    int kb_total, int kblk, int vpad, int kh, int kw, int bh, int bw, const int* taps,
    int n_live, float bn_scale, float threshold, float leak, float v_init, int soft_reset,
    int tile, void* stream) {
  Params p;
  if (c % 8 != 0 || kblk % 8 != 0 || kb_total < 1 || vpad < 1 ||
      !fill_params(p, x, affine, v0, spk, mem, t_in, t_out, n, h, w_, c, kout,
                   kb_total * kblk, kh, kw, bh, bw, taps, n_live, bn_scale, threshold, leak,
                   v_init, soft_reset))
    return (int)cudaErrorInvalidValue;
  p.maskp = static_cast<const uint8_t*>(maskp);
  p.vals = static_cast<const int8_t*>(vals);
  p.kblk = kblk;
  p.vpad = vpad;
  p.taps_total = kh * kw;
  if (p.npix == 0) return 0;
  return launch_named(p, true, tile, static_cast<cudaStream_t>(stream));
}

extern "C" void fused_pipeline_last_plan(int* out) {
  std::copy(g_last_plan, g_last_plan + kPlanInts, out);
}
