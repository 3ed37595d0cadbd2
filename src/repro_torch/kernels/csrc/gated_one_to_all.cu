// Gated one-to-all block convolution for Hopper (sm_90a) on the paper's
// bitmask-compressed weights, decoded inside the kernel.
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
// (block convolution: each block replicate-padded at its own border), u8
// inputs (binary spikes, or the encode layer's u8 pixels, the exact fold of
// its 8 bit-serial planes) times int8 weights into int32 with dp4a: exact.
//
// The weights stay compressed in device memory: maskp (one bit per weight)
// and the packed nonzero values of each K-block, in (tap, c, k) order. Each
// block owns one slice of up to 32 output channels of one K-block. It
//  1. lists the K-block's live taps (tap_any[kb, tap] != 0; a dead tap is
//     skipped, as the TPU kernel's pl.when skips it),
//  2. ranks every (tap, channel) row of the K-block's mask (common.cuh),
//  3. decodes its slice of the live taps into shared memory once,
//  4. walks pixel tiles gridDim.x apart with that slice: one thread per
//     4 output channels of kPix pixels, its accumulators in registers.
// The grid is one wave of resident blocks (by the occupancy the launch
// reports), so no block waits on a second wave.
// The TPU kernel decodes a whole K-block into VMEM scratch; at C=256 and
// KBLK=128 a 3x3 K-block is 288 KB, more than a block's 227 KB of shared
// memory, hence the slices.
//
// What bounds it on this card: bytes. The int32 output dominates (4 bytes
// per output value against 1 byte per input pixel-channel, and a few KB of
// compressed weights); the int8 products take microseconds at the card's
// peak. This first kernel does the products with scalar dp4a and no tensor
// cores, and writes each output once, coalesced along the channels.
//
// Layouts (all contiguous):
//  x       (M, H, W, C)          uint8, C % 8 == 0
//  maskp   (KB, kh*kw, C/8, KBLK) uint8, KBLK % 4 == 0
//  vals    (KB, VPAD)            int8
//  tap_any (KB, kh*kw)           int32
//  out     (M, H, W, kout)       int32, kout <= KB*KBLK
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTaps = 49;
constexpr int kMaxSlice = 32;  // output channels a block decodes and owns
constexpr int kPix = 4;        // pixels a thread accumulates at once

struct Params {
  const uint32_t* x;
  const uint8_t* maskp;
  const int8_t* vals;
  const int* tap_any;
  int* out;
  long long npix;  // M*H*W
  int h, w, c, kout, kblk, vpad;
  int kw, pad, bh, bw, taps;
  int kc;             // output channels per slice: a multiple of 4, <= 32
  int slices_per_kb;  // ceil(KBLK / kc)
};

__global__ void __launch_bounds__(kThreads) gated_one_to_all_kernel(const Params p) {
  extern __shared__ int4 smem4[];
  __shared__ int partial[kThreads];
  __shared__ int live[kMaxTaps];
  __shared__ int n_live;
  const int c = p.c, c4 = c / 4, c8 = c / 8;
  const int kb = blockIdx.y / p.slices_per_kb;
  const int kin0 = (blockIdx.y % p.slices_per_kb) * p.kc;  // slice offset in its K-block
  const int kc = min(p.kc, p.kblk - kin0);  // the last slice of a K-block may be short
  const uint8_t* mk = p.maskp + (long long)kb * p.taps * c8 * p.kblk;
  // shared memory: the decoded slice (taps, C/4, kc, 4) int8 (live taps
  // first), then one int per (tap, channel) row of the K-block
  int8_t* wsm = reinterpret_cast<int8_t*>(smem4);
  int* rows = reinterpret_cast<int*>(wsm + p.taps * c * p.kc);

  // 1. the K-block's live taps, in tap order
  if (threadIdx.x == 0) {
    int n = 0;
    for (int t = 0; t < p.taps; ++t)
      if (__ldg(p.tap_any + kb * p.taps + t) != 0) live[n++] = t;
    n_live = n;
  }
  // 2. the value index of every (tap, channel) row's first nonzero
  kblock_row_ranks<kThreads>(mk, p.taps, c, p.kblk, rows, partial);
  // 3. decode the slice: a set bit's value index is its rank in the
  //    K-block's (tap, channel, k) order; channels past the slice are 0
  const int8_t* vk = p.vals + (long long)kb * p.vpad;
  for (int e = threadIdx.x; e < n_live * c; e += kThreads) {
    const int l = e / c, ch = e % c, bit = ch & 7;
    const int tp = live[l];
    const uint32_t* row =
        reinterpret_cast<const uint32_t*>(mk + ((long long)tp * c8 + ch / 8) * p.kblk);
    int idx = rows[tp * c + ch];
    for (int q4 = 0; q4 < kin0 / 4; ++q4)  // set bits of the row before the slice
      idx += __popc((__ldg(row + q4) >> bit) & 0x01010101u);
    int8_t* dst = wsm + (l * c4 + ch / 4) * p.kc * 4 + (ch & 3);
    for (int kk = 0; kk < p.kc; kk += 4) {
      const uint32_t word = kk < kc ? __ldg(row + (kin0 + kk) / 4) >> bit : 0u;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        int8_t wv = 0;
        if ((word >> (8 * b)) & 1) {
          wv = __ldg(vk + min(idx, p.vpad - 1));  // clipped like the TPU gather
          ++idx;
        }
        dst[(kk + b) * 4] = wv;
      }
    }
  }
  __syncthreads();

  // 4. the block's pixel tiles: q threads per pixel lane, 4 channels each,
  //    kPix pixels per thread (lanes apart, so a warp's stores stay
  //    contiguous): every weight word read from shared memory feeds kPix
  //    independent dp4a chains
  const int q = p.kc / 4;
  const int lanes = kThreads / q;  // pixel lanes per block
  const int lane = threadIdx.x / q, quad = threadIdx.x % q;
  const long long k0 = (long long)kb * p.kblk + kin0 + 4 * quad;
  if (lane >= lanes || 4 * quad >= kc || k0 >= p.kout) return;
  const bool full = (p.kout % 4 == 0);  // all 4 channels exist: one int4 store
  const long long ppt = (long long)lanes * kPix;  // pixels per tile
  const long long ntiles = (p.npix + ppt - 1) / ppt;
  const int4* wq = smem4 + quad;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long pix0 = tile * ppt + lane;
    if (pix0 >= p.npix) break;
    const uint32_t* img[kPix];  // the pixel's image
    int hi[kPix], wi[kPix], h_lo[kPix], w_lo[kPix];
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      const long long pix = min(pix0 + (long long)j * lanes, p.npix - 1);
      wi[j] = (int)(pix % p.w);
      hi[j] = (int)((pix / p.w) % p.h);
      img[j] = p.x + (pix / ((long long)p.w * p.h)) * p.h * p.w * c4;
      h_lo[j] = (hi[j] / p.bh) * p.bh;
      w_lo[j] = (wi[j] / p.bw) * p.bw;
    }
    int acc[kPix][4];
#pragma unroll
    for (int j = 0; j < kPix; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0;
    for (int l = 0; l < n_live; ++l) {
      const int tap = live[l];
      const int dy = tap / p.kw - p.pad, dx = tap % p.kw - p.pad;
      const uint32_t* xp[kPix];
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        const int hh = min(max(hi[j] + dy, h_lo[j]), h_lo[j] + p.bh - 1);
        const int ww = min(max(wi[j] + dx, w_lo[j]), w_lo[j] + p.bw - 1);
        xp[j] = img[j] + ((long long)hh * p.w + ww) * c4;
      }
      const int4* wp = wq + l * c4 * q;
      for (int cq = 0; cq < c4; ++cq) {
        const int4 wv = wp[cq * q];
#pragma unroll
        for (int j = 0; j < kPix; ++j) {
          const uint32_t xv = __ldg(xp[j] + cq);
          acc[j][0] = dp4a_us(xv, wv.x, acc[j][0]);
          acc[j][1] = dp4a_us(xv, wv.y, acc[j][1]);
          acc[j][2] = dp4a_us(xv, wv.z, acc[j][2]);
          acc[j][3] = dp4a_us(xv, wv.w, acc[j][3]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      const long long pix = pix0 + (long long)j * lanes;
      if (pix >= p.npix) break;
      int* o = p.out + pix * p.kout + k0;
      if (full) {
        *reinterpret_cast<int4*>(o) = make_int4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (4 * quad + i < kc && k0 + i < p.kout) o[i] = acc[j][i];
      }
    }
  }
}

}  // namespace

extern "C" int gated_one_to_all_launch(
    const void* x, const void* maskp, const void* vals, const void* tap_any,
    void* out, int m, int h, int w, int c, int kout, int kb_total, int kblk,
    int vpad, int kh, int kw, int bh, int bw, void* stream) {
  if (m < 0 || h < 1 || w < 1 || c < 8 || c % 8 != 0 || kblk < 4 || kblk % 4 != 0 ||
      kb_total < 1 || kout < 1 || kout > kb_total * kblk || vpad < 1 || kh != kw ||
      kh % 2 != 1 || kh * kw > kMaxTaps || bh < 1 || bw < 1 || h % bh != 0 ||
      w % bw != 0)
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.x = static_cast<const uint32_t*>(x);
  p.maskp = static_cast<const uint8_t*>(maskp);
  p.vals = static_cast<const int8_t*>(vals);
  p.tap_any = static_cast<const int*>(tap_any);
  p.out = static_cast<int*>(out);
  p.npix = (long long)m * h * w;
  p.h = h;
  p.w = w;
  p.c = c;
  p.kout = kout;
  p.kblk = kblk;
  p.vpad = vpad;
  p.kw = kw;
  p.pad = (kh - 1) / 2;
  p.bh = bh;
  p.bw = bw;
  p.taps = kh * kw;
  if (p.npix == 0) return 0;

  // the slice width: 32 channels, narrower where the K-block is or where
  // the decoded slice would crowd shared memory (>= 3 blocks per SM)
  int kc = kblk < kMaxSlice ? kblk : kMaxSlice;
  auto smem_for = [&](int k) {
    return (size_t)p.taps * c * k + (size_t)p.taps * c * sizeof(int);
  };
  while (kc > 4 && kc % 8 == 0 && smem_for(kc) > 72 * 1024) kc /= 2;
  const size_t smem = smem_for(kc);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  p.kc = kc;
  p.slices_per_kb = (kblk + kc - 1) / kc;
  // slices holding at least one of the kout channels (K-blocks are
  // padded past kout)
  int slices = 0;
  for (int kbi = 0; kbi < kb_total; ++kbi)
    for (int s = 0; s < p.slices_per_kb; ++s)
      if (kbi * kblk + s * kc < kout) slices = kbi * p.slices_per_kb + s + 1;

  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gated_one_to_all_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gated_one_to_all_kernel, kThreads,
                                                smem);
  const long long ppt = (long long)(kThreads / (kc / 4)) * kPix;
  const long long tiles = (p.npix + ppt - 1) / ppt;
  // one wave of resident blocks in all, each decoding its slice once and
  // then walking its share of the pixel tiles
  long long bx = ((long long)(per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 132) + slices - 1) /
                 slices;
  if (bx > tiles) bx = tiles;
  if (bx > 65535) bx = 65535;
  dim3 grid((unsigned)bx, (unsigned)slices);
  gated_one_to_all_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
