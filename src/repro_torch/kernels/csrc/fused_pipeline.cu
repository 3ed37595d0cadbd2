// Fused layer pipeline for Hopper (sm_90a): block conv over the live taps
// -> FXP rescale -> tdBN inference affine -> LIF over t_out steps, the
// membrane kept in registers across the time loop.
//
// Replaces the TPU kernel src/repro/kernels/fused_pipeline.py
// (fused_pipeline_pallas, body _kernel) in both its weight modes:
//  * predecoded (the serving path): the live taps' dense int8 weights,
//    decoded once per plan on the host, read through the read-only cache;
//  * packed: the paper's bitmask-compressed weights (maskp bits + packed
//    nonzero values per K-block), decoded inside the kernel. Each block
//    decodes the 8 output channels it owns into shared memory once -- a
//    rank of every set bit from per-(tap, channel) row counts and a
//    block-wide prefix sum -- then walks the pixel tiles with that slice,
//    as the TPU kernel decodes once per K-block and reuses it across the
//    spatial grid.
//
// What bounds it on this card: bytes. At the detector's widths the f32
// membrane it writes (and reads, when warm) dominates; the int8 products
// are a few hundred MACs per output value against ~8 bytes of traffic.
// The design therefore keeps every per-element value in registers (all
// t_in accumulators, the drives and the membrane), reads each membrane
// once and writes each output once, and spends nothing on the arithmetic
// beyond plain dp4a: one thread owns one pixel and 4 output channels, and
// the lanes of a warp run along the output channels, so weight loads are
// 16-byte coalesced vectors, input loads are warp-wide broadcasts, and
// membrane/spike stores are coalesced. No shared memory, no tensor cores:
// those come in a later tuning pass.
//
// Semantics kept from the TPU kernel:
//  * block convolution: each bh x bw block sees replicate padding at its
//    own border -- neighbour coordinates are clamped to the block, which
//    is the same as convolving edge-padded independent blocks;
//  * integer accumulation: uint8 inputs (binary spikes, or the encode
//    layer's u8 pixels, the exact fold of its 8 bit-serial planes) times
//    int8 weights into int32 -- exact;
//  * mixed time: t_in == 1 computes one conv drive and reuses it for
//    every LIF step; t_in == t_out <= 4 keeps every step's accumulator in
//    registers, and t_in == t_out > 4 streams the steps (conv, drive, LIF
//    step, spikes for step t, then t+1), so T has no cap, as in the TPU
//    kernel, which unrolls any T;
//  * the float chain op for op, every product rounded on its own
//    (__fmul_rn/__fadd_rn/__fsub_rn, and the file is built -fmad=false):
//      y = float(acc)*scale; xh = (y-mean)*rinv; d = (bn_scale*xh)*gamma+beta
//      v = v*leak + d; s = v >= thr; hard: v = s ? 0 : v, soft: v = s ? v-thr : v
//    which is exactly what the plain PyTorch version computes, one eager
//    op at a time.
//
// Layouts (all contiguous):
//  x      (t_in, N, H, W, C)   uint8, C % 4 == 0 (C % 8 == 0 when packed)
//  w      (L, C/4, Kp, 4)      int8: live tap l, channel quad, out channel,
//                              the quad's 4 channel weights (one dp4a word)
//  maskp  (KB, kh*kw, C/8, KBLK) uint8: bit c%8 of byte c/8 marks w != 0
//  vals   (KB, VPAD)           int8: each K-block's nonzeros in (tap, c, k) order
//  affine (5, Kp)              f32 rows: scale, mean, rsqrt(var+eps), gamma, beta
//  v0     (N, H, W, Kout)      f32, or null for a cold start at v_init
//  spk    (t_out, N, H, W, Kout) uint8 {0,1}
//  mem    (N, H, W, Kout)      f32 final membrane
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kMaxTaps = 49;
constexpr int kThreads = 256;
constexpr int kMaxKGroups = 64;  // 4-channel groups per block: 256 channels

struct Params {
  const uint32_t* x;
  const int4* wt;  // the weights
  const float* affine;
  const float* v0;
  uint8_t* spk;
  float* mem;
  long long npix;  // N*H*W
  int h, w, c4, kout, kp;
  int kw, pad, bh, bw;
  int t_out;
  int kg_block;  // 4-channel groups per block, a power of two
  int n_live;
  int taps[kMaxTaps];
  float bn_scale, threshold, leak, v_init;
  int soft_reset;
  // packed mode only
  const uint8_t* maskp;
  const int8_t* vals;
  int kblk, vpad, taps_total;
};

__device__ __forceinline__ float elem(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// The conv of TIN consecutive time steps from step t0, for one pixel and
// output channels k0..k0+3, into acc. ``w`` holds rows of ``kq`` int4 per
// (live tap, channel quad); this thread's group sits at int4 column ``wcol``
// of each row. SMEM_W: ``w`` is in shared memory.
template <int TIN, bool SMEM_W>
__device__ __forceinline__ void conv_acc(const Params& p, const int4* w, int kq,
                                         int wcol, long long ni, int hi, int wi,
                                         int t0, int (&acc)[TIN][4]) {
  const int h_lo = (hi / p.bh) * p.bh, w_lo = (wi / p.bw) * p.bw;
  const int h_hi = h_lo + p.bh - 1, w_hi = w_lo + p.bw - 1;
#pragma unroll
  for (int t = 0; t < TIN; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[t][j] = 0;

  const long long t_stride = p.npix * p.c4;  // x words per time step
  for (int l = 0; l < p.n_live; ++l) {
    const int tap = p.taps[l];
    const int hh = min(max(hi + tap / p.kw - p.pad, h_lo), h_hi);
    const int ww = min(max(wi + tap % p.kw - p.pad, w_lo), w_hi);
    const uint32_t* xp = p.x + t0 * t_stride + ((ni * p.h + hh) * p.w + ww) * p.c4;
    const int4* wp = w + (long long)l * p.c4 * kq + wcol;
    for (int cq = 0; cq < p.c4; ++cq) {
      const int4 wv = SMEM_W ? wp[cq * kq] : __ldg(wp + (long long)cq * kq);
#pragma unroll
      for (int t = 0; t < TIN; ++t) {
        const uint32_t xv = __ldg(xp + t * t_stride + cq);
        acc[t][0] = dp4a_us(xv, wv.x, acc[t][0]);
        acc[t][1] = dp4a_us(xv, wv.y, acc[t][1]);
        acc[t][2] = dp4a_us(xv, wv.z, acc[t][2]);
        acc[t][3] = dp4a_us(xv, wv.w, acc[t][3]);
      }
    }
  }
}

// The layer's five affine rows for channels k0..k0+3.
struct Affine4 {
  float4 sc, mu, ri, ga, be;
};

__device__ __forceinline__ Affine4 load_affine(const Params& p, int k0) {
  const float4* a = reinterpret_cast<const float4*>(p.affine + k0);
  const int row = p.kp / 4;
  return {__ldg(a), __ldg(a + row), __ldg(a + 2 * row), __ldg(a + 3 * row),
          __ldg(a + 4 * row)};
}

// FXP rescale and tdBN affine: y = float(acc)*scale; xh = (y-mean)*rinv;
// d = (bn_scale*xh)*gamma + beta, each op rounded on its own.
__device__ __forceinline__ void to_drive(const Params& p, const Affine4& a,
                                         const int (&acc)[4], float (&d)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float y = __fmul_rn(__int2float_rn(acc[j]), elem(a.sc, j));
    const float xh = __fmul_rn(__fsub_rn(y, elem(a.mu, j)), elem(a.ri, j));
    d[j] = __fadd_rn(__fmul_rn(__fmul_rn(p.bn_scale, xh), elem(a.ga, j)), elem(a.be, j));
  }
}

// One LIF step of channels k0..k0+3 (v = v*leak + d, fire, reset), its
// spikes written to step t of the output.
__device__ __forceinline__ void lif_step(const Params& p, float (&v)[4],
                                         const float (&d)[4], int t,
                                         long long base, int k0, bool full) {
  uint32_t word = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[j] = __fadd_rn(__fmul_rn(v[j], p.leak), d[j]);
    const bool s = v[j] >= p.threshold;
    if (s) v[j] = p.soft_reset ? __fsub_rn(v[j], p.threshold) : 0.0f;
    word |= (uint32_t)s << (8 * j);
  }
  uint8_t* out = p.spk + (long long)t * p.npix * p.kout + base;
  if (full) {
    *reinterpret_cast<uint32_t*>(out) = word;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (k0 + j < p.kout) out[j] = (word >> (8 * j)) & 1;
  }
}

// The whole pipeline for one pixel and output channels k0..k0+3.
//  TIN = 1:     one conv drive feeds every one of the t_out LIF steps;
//  TIN = 2..4:  t_in == t_out == TIN, every step's accumulator in registers;
//  TIN = 0:     t_in == t_out > 4, streamed: step t's conv, drive, LIF step
//               and spikes, one step at a time (any T; the weights are
//               re-read per step, the membrane stays in registers).
template <int TIN, bool SMEM_W>
__device__ __forceinline__ void pixel_pipeline(const Params& p, const int4* w,
                                               int kq, int wcol, long long pix,
                                               int k0) {
  const int wi = (int)(pix % p.w);
  const int hi = (int)((pix / p.w) % p.h);
  const long long ni = pix / ((long long)p.w * p.h);
  const bool full = (p.kout % 4 == 0);  // whole 4-channel groups: vector I/O
  const long long base = pix * p.kout + k0;

  float v[4];
  if (p.v0 == nullptr) {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = p.v_init;
  } else if (full) {
    const float4 vv = __ldg(reinterpret_cast<const float4*>(p.v0 + base));
    v[0] = vv.x; v[1] = vv.y; v[2] = vv.z; v[3] = vv.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = (k0 + j < p.kout) ? p.v0[base + j] : 0.0f;
  }

  if constexpr (TIN == 0) {
    const Affine4 a = load_affine(p, k0);
    for (int t = 0; t < p.t_out; ++t) {
      int acc[1][4];
      float d[4];
      conv_acc<1, SMEM_W>(p, w, kq, wcol, ni, hi, wi, t, acc);
      to_drive(p, a, acc[0], d);
      lif_step(p, v, d, t, base, k0, full);
    }
  } else {
    int acc[TIN][4];
    float d[TIN][4];
    conv_acc<TIN, SMEM_W>(p, w, kq, wcol, ni, hi, wi, 0, acc);
    const Affine4 a = load_affine(p, k0);
#pragma unroll
    for (int t = 0; t < TIN; ++t) to_drive(p, a, acc[t], d[t]);
    if constexpr (TIN == 1) {
      for (int t = 0; t < p.t_out; ++t) lif_step(p, v, d[0], t, base, k0, full);
    } else {
#pragma unroll
      for (int t = 0; t < TIN; ++t) lif_step(p, v, d[t], t, base, k0, full);
    }
  }
  if (full) {
    *reinterpret_cast<float4*>(p.mem + base) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (k0 + j < p.kout) p.mem[base + j] = v[j];
  }
}

// Predecoded weights: one thread per (pixel, 4 output channels).
template <int TIN>
__global__ void __launch_bounds__(kThreads) fused_pipeline_kernel(const Params p) {
  const int kg_local = threadIdx.x & (p.kg_block - 1);
  const long long pix =
      (long long)blockIdx.x * (kThreads / p.kg_block) + threadIdx.x / p.kg_block;
  const int k0 = (blockIdx.y * p.kg_block + kg_local) * 4;
  if (pix >= p.npix || k0 >= p.kout) return;
  pixel_pipeline<TIN, false>(p, p.wt, p.kp / 4, k0 / 4, pix, k0);
}

constexpr int kPackedKC = 8;  // output channels a packed-mode block decodes

// Packed weights: block (x, y) decodes output channels 8y..8y+7 of every
// live tap into shared memory, then runs pixel tiles x, x + gridDim.x, ...
// Shared memory: the decoded slice (L, C/4, 8, 4) int8, then one int per
// (tap, channel) row of the K-block.
template <int TIN>
__global__ void __launch_bounds__(kThreads) fused_pipeline_packed_kernel(const Params p) {
  extern __shared__ int4 smem4[];
  __shared__ int partial[kThreads];
  const int c = p.c4 * 4, c8 = c / 8;
  int8_t* wsm = reinterpret_cast<int8_t*>(smem4);
  int* rows = reinterpret_cast<int*>(wsm + p.n_live * c * kPackedKC);
  const int chunk0 = blockIdx.y * kPackedKC;
  const int kb = chunk0 / p.kblk;
  const int kin0 = chunk0 - kb * p.kblk;  // the slice's offset in its K-block
  const uint8_t* mk = p.maskp + (long long)kb * p.taps_total * c8 * p.kblk;

  // 1. the value index of every (tap, channel) row's first nonzero
  kblock_row_ranks<kThreads>(mk, p.taps_total, c, p.kblk, rows, partial);
  // 2. decode the slice: a set bit's value index is its rank in the
  //    K-block's (tap, channel, k) order
  const int8_t* vk = p.vals + (long long)kb * p.vpad;
  for (int e = threadIdx.x; e < p.n_live * c; e += kThreads) {
    const int l = e / c, ch = e % c;
    const int tp = p.taps[l];
    const uint8_t* row = mk + ((long long)tp * c8 + ch / 8) * p.kblk;
    int idx = rows[tp * c + ch];
    for (int k = 0; k < kin0; ++k) idx += (__ldg(row + k) >> (ch & 7)) & 1;
    for (int kk = 0; kk < kPackedKC; ++kk) {
      int8_t wv = 0;
      if ((__ldg(row + kin0 + kk) >> (ch & 7)) & 1) {
        wv = __ldg(vk + min(idx, p.vpad - 1));  // clipped like the TPU gather
        ++idx;
      }
      wsm[((l * p.c4 + ch / 4) * kPackedKC + kk) * 4 + (ch & 3)] = wv;
    }
  }
  __syncthreads();
  // 3. the pipeline over this block's pixel tiles, two 4-channel groups each
  const int g = threadIdx.x & 1;
  const int k0 = chunk0 + 4 * g;
  const int ppb = kThreads / 2;
  const long long ntiles = (p.npix + ppb - 1) / ppb;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long pix = tile * ppb + threadIdx.x / 2;
    if (pix < p.npix && k0 < p.kout)
      pixel_pipeline<TIN, true>(p, smem4, kPackedKC / 4, g, pix, k0);
  }
}

bool fill_params(Params& p, const void* x, const void* affine, const void* v0,
                 void* spk, void* mem, int t_in, int t_out, int n, int h, int w_,
                 int c, int kout, int kp, int kh, int kw, int bh, int bw,
                 const int* taps, int n_live, float bn_scale, float threshold,
                 float leak, float v_init, int soft_reset) {
  if (t_in < 1 || t_out < 1 || (t_in != 1 && t_in != t_out) || n_live < 0 || n_live > kMaxTaps ||
      c % 4 != 0 || kp % 4 != 0 || kout > kp || kh != kw || kh % 2 != 1 ||
      bh < 1 || bw < 1 || h % bh != 0 || w_ % bw != 0)
    return false;
  p = Params{};
  p.x = static_cast<const uint32_t*>(x);
  p.affine = static_cast<const float*>(affine);
  p.v0 = static_cast<const float*>(v0);
  p.spk = static_cast<uint8_t*>(spk);
  p.mem = static_cast<float*>(mem);
  p.npix = (long long)n * h * w_;
  p.h = h;
  p.w = w_;
  p.c4 = c / 4;
  p.kout = kout;
  p.kp = kp;
  p.kw = kw;
  p.pad = (kh - 1) / 2;
  p.bh = bh;
  p.bw = bw;
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

}  // namespace

extern "C" int fused_pipeline_launch(
    const void* x, const void* w, const void* affine, const void* v0,
    void* spk, void* mem, int t_in, int t_out, int n, int h, int w_, int c,
    int kout, int kp, int kh, int kw, int bh, int bw, const int* taps,
    int n_live, float bn_scale, float threshold, float leak, float v_init,
    int soft_reset, void* stream) {
  Params p;
  if (!fill_params(p, x, affine, v0, spk, mem, t_in, t_out, n, h, w_, c, kout,
                   kp, kh, kw, bh, bw, taps, n_live, bn_scale, threshold, leak,
                   v_init, soft_reset))
    return (int)cudaErrorInvalidValue;
  p.wt = static_cast<const int4*>(w);

  const int groups = (kout + 3) / 4;
  int kg = 1;
  while (kg < groups && kg < kMaxKGroups) kg *= 2;
  p.kg_block = kg;
  const long long pix_per_block = kThreads / kg;
  dim3 grid((unsigned)((p.npix + pix_per_block - 1) / pix_per_block),
            (unsigned)((groups + kg - 1) / kg));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (t_in) {
    case 1: fused_pipeline_kernel<1><<<grid, kThreads, 0, s>>>(p); break;
    case 2: fused_pipeline_kernel<2><<<grid, kThreads, 0, s>>>(p); break;
    case 3: fused_pipeline_kernel<3><<<grid, kThreads, 0, s>>>(p); break;
    case 4: fused_pipeline_kernel<4><<<grid, kThreads, 0, s>>>(p); break;
    default: fused_pipeline_kernel<0><<<grid, kThreads, 0, s>>>(p); break;
  }
  return (int)cudaGetLastError();
}

template <int TIN>
static int launch_packed(const Params& p, dim3 grid, size_t smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_pipeline_packed_kernel<TIN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fused_pipeline_packed_kernel<TIN><<<grid, kThreads, smem, s>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int fused_pipeline_packed_launch(
    const void* x, const void* maskp, const void* vals, const void* affine,
    const void* v0, void* spk, void* mem, int t_in, int t_out, int n, int h,
    int w_, int c, int kout, int kb_total, int kblk, int vpad, int kh, int kw,
    int bh, int bw, const int* taps, int n_live, float bn_scale,
    float threshold, float leak, float v_init, int soft_reset, void* stream) {
  Params p;
  if (c % 8 != 0 || kblk % kPackedKC != 0 || kb_total < 1 || vpad < 1 ||
      !fill_params(p, x, affine, v0, spk, mem, t_in, t_out, n, h, w_, c, kout,
                   kb_total * kblk, kh, kw, bh, bw, taps, n_live, bn_scale,
                   threshold, leak, v_init, soft_reset))
    return (int)cudaErrorInvalidValue;
  p.maskp = static_cast<const uint8_t*>(maskp);
  p.vals = static_cast<const int8_t*>(vals);
  p.kblk = kblk;
  p.vpad = vpad;
  p.taps_total = kh * kw;

  const size_t smem = (size_t)n_live * c * kPackedKC + (size_t)kh * kw * c * sizeof(int);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long tiles = (p.npix + kThreads / 2 - 1) / (kThreads / 2);
  const long long chunks = (kout + kPackedKC - 1) / kPackedKC;
  // enough blocks to fill the card twice over, each decoding its slice once
  long long bx = (2LL * (sms > 0 ? sms : 132) + chunks - 1) / chunks;
  if (bx > tiles) bx = tiles;
  dim3 grid((unsigned)bx, (unsigned)chunks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (t_in) {
    case 1: return launch_packed<1>(p, grid, smem, s);
    case 2: return launch_packed<2>(p, grid, smem, s);
    case 3: return launch_packed<3>(p, grid, smem, s);
    case 4: return launch_packed<4>(p, grid, smem, s);
    default: return launch_packed<0>(p, grid, smem, s);
  }
}
