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
// epilogue's stores. The design:
//  * weights resident: each block copies (predecoded, 16-byte loads) or
//    decodes (packed) its output-channel tile of the weights over the
//    whole K-dim into shared memory once, [channel][K-dim] bytes, and
//    reuses it across every time step and every pixel tile of a
//    persistent block. A slice that does not fit is streamed in K-chunks
//    beside the inputs (predecoded mode only);
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

#include "common.cuh"

namespace {

constexpr int kMaxTaps = 49;
constexpr int kThreads = 256;  // 8 warps
constexpr int kSmemMax = 227 * 1024;
constexpr int kAChunkBytes = 16384;  // the most bytes of one A chunk (rows x KC)
constexpr int kStages = 3;           // A chunks in shared memory: 2 in flight
constexpr long long kTimeBatchPix = 8192;  // the largest map batched over time

struct Params {
  const uint8_t* x;
  const uint8_t* w;  // predecoded weights
  const float* affine;
  const float* v0;
  uint8_t* spk;
  float* mem;
  long long npix;  // N*H*W
  int h, w_, c, kout, kp;
  int kw, pad, bh, bw;
  int t_in, t_out;
  int n_live;
  int taps[kMaxTaps];
  float bn_scale, threshold, leak, v_init;
  int soft_reset;
  // packed mode only
  const uint8_t* maskp;
  const int8_t* vals;
  int kblk, vpad, taps_total;
  // the GEMM and shared-memory plan (set by the launcher)
  int kreal, kpad;   // live taps x C, and rounded up to 32
  int kc, nch;       // A chunk width (bytes of K-dim) and chunks per pass
  int g;             // gather width: 16, 8 or 4 bytes
  int resident;      // weights resident (else streamed per chunk)
  int w_stride;      // bytes per channel row of the weight buffer
  int a_stride;      // bytes per A row (im2col) or halo pixel
  int a_buf;         // bytes of one A buffer
  long long ptiles;  // pixel tiles
  // halo mode (time-batched, C % 32 == 0, weights resident): each item is a channel
  // chunk of cc channels of the pixel tile's halo, TB steps of it
  int halo, th, tw, hwid, halo_px, cc, tyb, txb;
  int off_a, off_stage, off_aff, off_taps, off_units, off_rowinfo, off_rowpix, off_rows,
      off_partial;
};

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src), "n"(N),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>  // wait until at most N groups are pending
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* ptr) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(ptr);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma_u8s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The tile: WM x WN warps over BP pixels x BN channels, each warp 16
// pixels x 8*NI channels, for TB time steps at once. The A tile has TB x BP
// rows, (step, pixel); a warp's TB x NI accumulators share its B fragments
// and are independent, and the membrane of its 16 x 8*NI elements is one
// set of registers for all steps.
template <int TB, int NI, int WM, int WN>
struct Tile {
  static_assert(WM * WN * 32 == kThreads, "8 warps");
  static_assert(NI % 2 == 0, "B fragments load two n8 tiles at a time");
  static_assert(TB == 1 || TB == 4, "one step, or four, per pass");
  static constexpr int BP = WM * 16;      // pixels
  static constexpr int BN = WN * 8 * NI;  // output channels
  static constexpr int ROWS = TB * BP;    // A rows
  static constexpr int SF = BN + 8;       // staging row, f32 membrane (floats)
  static constexpr int SB = BN + 16;      // staging row, spikes (bytes)
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

// One A row's gathers of a chunk (im2col mode): units uu = j0, j0 + tpr,
// ... of the chunk, G bytes each, from the live tap and channel ``units``
// names; the block-clamped source pixel is recomputed only when the tap
// changes. Rows past the image or the last step, and the K-dim padding,
// are zero-filled.
template <int G>
__device__ __forceinline__ void gather_row(const Params& p, uint8_t* arow, const int* units,
                                           int upr, int j0, int tpr, int4 info, int t,
                                           const int* tdh, const int* tdw) {
  int last_l = -1;
  const uint8_t* base = p.x;
  const bool live = info.x >= 0 && t < p.t_in;
  for (int uu = j0; uu < upr; uu += tpr) {
    const int unit = units[uu];
    const uint8_t* src = p.x;
    int bytes = 0;
    if (live && unit >= 0) {
      const int l = unit >> 16;
      if (l != last_l) {
        last_l = l;
        const int hlo = info.w >> 16, wlo = info.w & 0xffff;
        const int hh = min(max(info.y + tdh[l], hlo), hlo + p.bh - 1);
        const int ww = min(max(info.z + tdw[l], wlo), wlo + p.bw - 1);
        base = p.x + ((long long)t * p.npix + info.x + hh * p.w_ + ww) * p.c;
      }
      src = base + (unit & 0xffff);
      bytes = G;
    }
    cp_async<G>(arow + uu * G, src, bytes);
  }
}

// Decode the block's channel tile of the packed weights into the same
// layout: per K-block that the tile touches, the rank walk of
// common.cuh gives every (tap, channel) row's first value index; then one
// thread per live (tap, channel) row counts the row's set bits left of the
// tile and walks the tile's channels 8 mask bytes at a time.
template <int BN>
__device__ void decode_weights(const Params& p, uint8_t* wsm, int n0, int* rows, int* partial) {
  const int c8 = p.c / 8;
  for (int e = threadIdx.x; e < BN * p.w_stride / 4; e += kThreads)
    reinterpret_cast<uint32_t*>(wsm)[e] = 0u;
  const int n_end = min(n0 + BN, p.kp);
  for (int kb = n0 / p.kblk; kb * p.kblk < n_end; ++kb) {
    const uint8_t* mk = p.maskp + (long long)kb * p.taps_total * c8 * p.kblk;
    __syncthreads();  // the previous K-block's ranks are no longer read
    kblock_row_ranks<kThreads>(mk, p.taps_total, p.c, p.kblk, rows, partial);
    const int ks = max(n0, kb * p.kblk) - kb * p.kblk;  // the tile's span in this K-block
    const int ke = min(n_end, (kb + 1) * p.kblk) - kb * p.kblk;
    const int8_t* vk = p.vals + (long long)kb * p.vpad;
    for (int r = threadIdx.x; r < p.n_live * p.c; r += kThreads) {
      const int l = r / p.c, ch = r - l * p.c;
      const int tap = p.taps[l];
      const uint8_t* row = mk + ((long long)tap * c8 + ch / 8) * p.kblk;
      const int sh = ch & 7;
      int idx = rows[tap * p.c + ch];
      for (int q = 0; q < ks; q += 8) {
        const uint2 wv = __ldg(reinterpret_cast<const uint2*>(row + q));
        idx += __popc((wv.x >> sh) & 0x01010101u) + __popc((wv.y >> sh) & 0x01010101u);
      }
      for (int q = ks; q < ke; q += 8) {
        const uint2 wv = __ldg(reinterpret_cast<const uint2*>(row + q));
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t word = j < 4 ? wv.x : wv.y;
          if ((word >> (8 * (j & 3) + sh)) & 1u) {
            const int n = kb * p.kblk + q + j - n0;
            wsm[n * p.w_stride + r] = (uint8_t)__ldg(vk + min(idx, p.vpad - 1));  // clipped
            ++idx;                                                                 // like the TPU
          }
        }
      }
    }
  }
  __syncthreads();
}

// The 16-channel one-step tile asks for 3 blocks per SM (at most 85
// registers a thread): its maps are the largest, and the extra block
// hides the gathers' and the stores' latency.
template <int TB, int NI, int WM, int WN>
__global__ void __launch_bounds__(kThreads, (TB == 1 && WN * 8 * NI == 16) ? 3 : 1)
    fused_pipeline_kernel(const Params p) {
  using T = Tile<TB, NI, WM, WN>;
  constexpr int BP = T::BP, BN = T::BN, ROWS = T::ROWS;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* wsm = smem;  // resident weights, or kStages streamed B chunks
  float* stage_f = reinterpret_cast<float*>(smem + p.off_stage);
  uint8_t* stage_b = smem + p.off_stage;
  float* aff = reinterpret_cast<float*>(smem + p.off_aff);  // [5][BN]
  int* tdh = reinterpret_cast<int*>(smem + p.off_taps);     // [kMaxTaps] x 3
  int* tdw = tdh + kMaxTaps;
  int* toff = tdw + kMaxTaps;  // halo mode: a tap's byte offset in the halo
  int* units = reinterpret_cast<int*>(smem + p.off_units);        // [kpad / g]
  int4* rowinfo = reinterpret_cast<int4*>(smem + p.off_rowinfo);  // [BP]
  int* rowpix = reinterpret_cast<int*>(smem + p.off_rowpix);      // [kStages][BP]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = (warp / WN) * 16, wn = (warp % WN) * 8 * NI;
  const int n0 = blockIdx.y * BN;
  const bool halo = TB > 1 && p.halo;  // only time-batched tiles use halo mode

  // per-block set-up: tap offsets, gather units, the affine rows, the weights
  for (int l = tid; l < p.n_live; l += kThreads) {
    tdh[l] = p.taps[l] / p.kw - p.pad;
    tdw[l] = p.taps[l] % p.kw - p.pad;
    toff[l] = (tdh[l] * p.hwid + tdw[l]) * p.a_stride;
  }
  // im2col mode: every gather unit of the K-dim, its live tap and first
  // channel (-1: padding)
  if (!halo)
    for (int u = tid; u < p.kpad / p.g; u += kThreads) {
      const int kq = u * p.g, l = kq / p.c;
      units[u] = kq < p.kreal ? (l << 16) | (kq - l * p.c) : -1;
    }
  for (int e = tid; e < 5 * BN; e += kThreads) {
    const int row = e / BN, n = e % BN;
    aff[e] = n0 + n < p.kp ? __ldg(p.affine + (long long)row * p.kp + n0 + n) : 0.f;
  }
  if (p.resident) {
    if (p.maskp != nullptr)
      decode_weights<BN>(p, wsm, n0, reinterpret_cast<int*>(smem + p.off_rows),
                         reinterpret_cast<int*>(smem + p.off_partial));
    else
      load_weights<BN>(p, wsm, n0);
  }
  __syncthreads();

  // Items: chunk ch (of the K-dim, or of the channels in halo mode) of pass
  // ps (steps ps*TB ...) of the block's pixel tile tl (its blockIdx.x +
  // tl * gridDim.x-th), in (tl, ps, ch) order.
  const long long my_tiles =
      blockIdx.x < p.ptiles ? (p.ptiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int passes = (p.t_in + TB - 1) / TB;
  const long long n_items = my_tiles * passes * p.nch;
  struct Item {
    int tl, ps, ch;
  };
  auto advance = [&](Item& c) {
    if (++c.ch == p.nch) {
      c.ch = 0;
      if (++c.ps == passes) {
        c.ps = 0;
        ++c.tl;
      }
    }
  };
  // halo mode: tile gt is sub-tile (sy, sx) of block-conv block (by, bx) of
  // image n; its first pixel (y0, x0) and its block's corner (by0, bx0)
  struct Origin {
    int n, y0, x0, by0, bx0;
  };
  auto origin = [&](long long gt) {
    const int per_blk = p.tyb * p.txb, nbx = p.w_ / p.bw, nby = p.h / p.bh;
    const long long blk = gt / per_blk;
    const int st = (int)(gt - blk * per_blk), sy = st / p.txb, sx = st - sy * p.txb;
    const int n = (int)(blk / (nby * nbx)), rb = (int)(blk - (long long)n * nby * nbx);
    const int by0 = (rb / nbx) * p.bh, bx0 = (rb % nbx) * p.bw;
    return Origin{n, by0 + sy * p.th, bx0 + sx * p.tw, by0, bx0};
  };

  // the loads of item c -> A buffer ``buf`` (and, streamed, B)
  auto issue = [&](const Item& c, int buf) {
    const long long gt = blockIdx.x + (long long)c.tl * gridDim.x;
    uint8_t* a = smem + p.off_a + buf * p.a_buf;
    if (c.ps == 0 && c.ch == 0) {  // a new pixel tile: each row's output pixel (-1: none)
      int* rp = rowpix + (c.tl % kStages) * BP;
      if (halo) {
        const Origin o = origin(gt);
        for (int r = tid; r < BP; r += kThreads) {
          const int py = r / p.tw, px = r - py * p.tw;
          const bool in = o.y0 + py < o.by0 + p.bh && o.x0 + px < o.bx0 + p.bw;
          rp[r] = in ? ((o.n * p.h + o.y0 + py) * p.w_ + o.x0 + px) : -1;
        }
      } else {  // and each row's image, coordinates and block corner
        for (int r = tid; r < BP; r += kThreads) {
          int4 info = make_int4(-1, 0, 0, 0);
          const long long pix = gt * BP + r;
          if (pix < p.npix) {
            const int pi = (int)pix;  // npix < 2^31 (checked at launch)
            const int wi = pi % p.w_, q = pi / p.w_;
            const int hi = q % p.h, ni = q / p.h;
            info = make_int4(ni * p.h * p.w_, hi, wi, ((hi / p.bh) * p.bh << 16) | (wi / p.bw) * p.bw);
          }
          rowinfo[r] = info;
          rp[r] = pix < p.npix ? (int)pix : -1;
        }
      }
      __syncthreads();
    }
    if (halo) {  // TB steps x the halo's pixels x cc channels, 16 bytes a copy
      const Origin o = origin(gt);
      const int per_px = p.cc / 16, per_t = p.halo_px * per_px;
      for (int e = tid; e < TB * per_t; e += kThreads) {
        const int tb = e / per_t, rem = e - tb * per_t;
        const int hp = rem / per_px, u = rem - hp * per_px;
        const int hy = hp / p.hwid, hx = hp - hy * p.hwid;
        const int y = min(max(o.y0 - p.pad + hy, o.by0), o.by0 + p.bh - 1);
        const int x = min(max(o.x0 - p.pad + hx, o.bx0), o.bx0 + p.bw - 1);
        const int t = c.ps * TB + tb;
        const uint8_t* src = p.x;
        int bytes = 0;
        if (t < p.t_in) {
          src = p.x + ((long long)t * p.npix + ((long long)o.n * p.h + y) * p.w_ + x) * p.c +
                c.ch * p.cc + u * 16;
          bytes = 16;
        }
        cp_async<16>(a + (tb * p.halo_px + hp) * p.a_stride + u * 16, src, bytes);
      }
    } else {
      const int k0 = c.ch * p.kc, klen = min(p.kc, p.kpad - k0);
      constexpr int kTpr = kThreads / ROWS;  // threads per A row (step tb, pixel r)
      const int row = tid / kTpr, j0 = tid % kTpr;
      const int upr = klen / p.g;  // gather units per row
      const int* ku = units + k0 / p.g;
      uint8_t* arow = a + row * p.a_stride;
      const int4 info = rowinfo[row % BP];
      const int t = c.ps * TB + row / BP;
      if (p.g == 16)
        gather_row<16>(p, arow, ku, upr, j0, kTpr, info, t, tdh, tdw);
      else if (p.g == 8)
        gather_row<8>(p, arow, ku, upr, j0, kTpr, info, t, tdh, tdw);
      else
        gather_row<4>(p, arow, ku, upr, j0, kTpr, info, t, tdh, tdw);
      if (!p.resident) {  // the chunk's weights, channel rows of klen bytes
        uint8_t* B = wsm + buf * BN * p.w_stride;
        const int c4 = p.c / 4;
        const int wpr = klen / 4;
        for (int e = tid; e < BN * wpr; e += kThreads) {
          const int n = e % BN, kq = k0 + (e / BN) * 4;
          const uint8_t* src = p.w;
          int bytes = 0;
          if (n0 + n < p.kout && kq < p.kreal) {
            const int l = kq / p.c, cq = (kq - l * p.c) / 4;
            src = p.w + (((long long)l * c4 + cq) * p.kp + n0 + n) * 4;
            bytes = 4;
          }
          cp_async<4>(B + n * p.w_stride + (kq - k0), src, bytes);
        }
      }
    }
    cp_async_commit();
  };

  int acc[TB][NI][4];  // int32 sums per step; after a pass, the drives' f32 bits
  float v[NI][4];      // the membrane, in the accumulator fragment layout

  // fragment element (ni, e) <-> tile pixel row / channel column
  auto frag_row = [&](int e) { return wm + g + (e >> 1) * 8; };
  auto frag_col = [&](int ni, int e) { return wn + ni * 8 + 2 * tig + (e & 1); };

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
  auto lif_step = [&](const int (&d)[NI][4], int t, const int* rp) {
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
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
        *reinterpret_cast<uint16_t*>(stage_b + frag_row(e) * T::SB + frag_col(ni, e)) =
            (uint16_t)s2;
      }
    __syncthreads();
    spikes_out(p.spk + (long long)t * p.npix * p.kout, rp);
    __syncthreads();
  };

  // this lane's A row (a tile pixel): its byte offset in an A buffer, and
  // the offset from one step's rows to the next
  const int arow = wm + (lane & 15);
  const int a_lane = (halo ? ((arow / p.tw + p.pad) * p.hwid + arow % p.tw + p.pad) * p.a_stride
                          : arow * p.a_stride) + (lane >> 4) * 16;
  const int a_step = halo ? p.halo_px * p.a_stride : BP * p.a_stride;

  // a ring of kStages A buffers: item it + kStages - 1 is issued while
  // item it is multiplied; every iteration commits one group (maybe empty)
  Item next{0, 0, 0}, cur{0, 0, 0};
  long long issued = 0;
  int ibuf = 0, buf = 0;
  auto issue_next = [&]() {
    if (issued < n_items) {
      issue(next, ibuf);
      advance(next);
      ++issued;
      ibuf = ibuf + 1 == kStages ? 0 : ibuf + 1;
    } else {
      cp_async_commit();
    }
  };
  for (int st = 0; st < kStages - 1; ++st) issue_next();
  for (long long it = 0; it < n_items; ++it, advance(cur), buf = buf + 1 == kStages ? 0 : buf + 1) {
    const int ps = cur.ps, ch = cur.ch;
    const int ntb = min(TB, p.t_in - ps * TB);  // steps in this pass
    const int* rp = rowpix + (cur.tl % kStages) * BP;
    issue_next();
    cp_async_wait<kStages - 1>();  // item it has landed
    __syncthreads();

    if (ch == 0) {
#pragma unroll
      for (int tb = 0; tb < TB; ++tb)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[tb][ni][e] = 0;
    }
    // the tensor-core products of this item's k-steps
    {
      const uint8_t* a_ptr = smem + p.off_a + buf * p.a_buf + a_lane;
      const int k0 = ch * p.kc;
      // B: the resident weights, or the streamed chunk (k from the chunk's start)
      const uint8_t* B = p.resident ? wsm : wsm + buf * BN * p.w_stride - k0;
      const uint8_t* b_ptr =
          B + (wn + (lane & 7) + (lane >> 4) * 8) * p.w_stride + ((lane >> 3) & 1) * 16;
      // k-steps: the chunk's 32-byte columns, or in the halo each live tap's
      // cc channels 32 at a time
      const int nks = halo ? p.n_live * (p.cc / 32) : min(p.kc, p.kpad - k0) / 32;
      // the next k-step to load: its A offset (in the halo: the tap's shift
      // plus the channels) and its weights' K-dim offset, kept incrementally
      int ld_l = 0, ld_cj = 0, ld_ao = halo && nks > 0 ? toff[0] : 0, ld_bo = halo ? ch * p.cc : k0;
      auto load = [&](uint32_t (&a)[TB][4], uint32_t (&b)[NI / 2][4]) {
#pragma unroll
        for (int tb = 0; tb < TB; ++tb)
          if (tb < ntb) ldsm_x4(a[tb], a_ptr + tb * a_step + ld_ao);
#pragma unroll
        for (int nj = 0; nj < NI / 2; ++nj) ldsm_x4(b[nj], b_ptr + nj * 16 * p.w_stride + ld_bo);
        ld_ao += 32;
        ld_bo += 32;
        if (halo && (ld_cj += 32) == p.cc) {  // the next live tap
          ld_cj = 0;
          if (++ld_l < p.n_live) {
            ld_ao = toff[ld_l];
            ld_bo = ld_l * p.c + ch * p.cc;
          }
        }
      };
      auto mul = [&](const uint32_t (&a)[TB][4], const uint32_t (&b)[NI / 2][4]) {
#pragma unroll
        for (int tb = 0; tb < TB; ++tb)
          if (tb < ntb) {
#pragma unroll
            for (int nj = 0; nj < NI / 2; ++nj) {
              mma_u8s8(acc[tb][2 * nj], a[tb], b[nj][0], b[nj][1]);
              mma_u8s8(acc[tb][2 * nj + 1], a[tb], b[nj][2], b[nj][3]);
            }
          }
      };
      uint32_t a0[TB][4], b0[NI / 2][4], a1[TB][4], b1[NI / 2][4];
      if constexpr (TB > 1) {
        // three register sets: fragments load two k-steps ahead of the products
        uint32_t a2[TB][4], b2[NI / 2][4];
        if (nks > 0) load(a0, b0);
        if (nks > 1) load(a1, b1);
        for (int ks = 0; ks < nks; ks += 3) {
          if (ks + 2 < nks) load(a2, b2);
          mul(a0, b0);
          if (ks + 3 < nks) load(a0, b0);
          if (ks + 1 < nks) mul(a1, b1);
          if (ks + 4 < nks) load(a1, b1);
          if (ks + 2 < nks) mul(a2, b2);
        }
      } else {  // two sets, one k-step ahead: fewer registers, more blocks per SM
        if (nks > 0) load(a0, b0);
        for (int ks = 0; ks < nks; ks += 2) {
          if (ks + 1 < nks) load(a1, b1);
          mul(a0, b0);
          if (ks + 2 < nks) load(a0, b0);
          if (ks + 1 < nks) mul(a1, b1);
        }
      }
    }

    if (ch == p.nch - 1) {  // the pass's convs are complete: drives, then LIF
#pragma unroll
      for (int tb = 0; tb < TB; ++tb)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = frag_col(ni, e);
            const float y = __fmul_rn(__int2float_rn(acc[tb][ni][e]), aff[c]);
            const float xh = __fmul_rn(__fsub_rn(y, aff[BN + c]), aff[2 * BN + c]);
            const float d = __fadd_rn(__fmul_rn(__fmul_rn(p.bn_scale, xh), aff[3 * BN + c]),
                                      aff[4 * BN + c]);
            acc[tb][ni][e] = __float_as_int(d);
          }
      if (ps == 0) {  // the tile's starting membrane
        if (p.v0 == nullptr) {
#pragma unroll
          for (int ni = 0; ni < NI; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) v[ni][e] = p.v_init;
        } else {
          tile_f32_in(p.v0, rp);
          __syncthreads();
#pragma unroll
          for (int ni = 0; ni < NI; ++ni)
#pragma unroll
            for (int e = 0; e < 4; e += 2) {
              const float2 f =
                  *reinterpret_cast<const float2*>(stage_f + frag_row(e) * T::SF + frag_col(ni, e));
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
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int e = 0; e < 4; e += 2)
            *reinterpret_cast<float2*>(stage_f + frag_row(e) * T::SF + frag_col(ni, e)) =
                make_float2(v[ni][e], v[ni][e + 1]);
        __syncthreads();
        tile_f32_out(p.mem, rp);
      }
    }
    __syncthreads();  // this item's buffer is free for item it + kStages
  }
}

bool fill_params(Params& p, const void* x, const void* affine, const void* v0, void* spk,
                 void* mem, int t_in, int t_out, int n, int h, int w_, int c, int kout, int kp,
                 int kh, int kw, int bh, int bw, const int* taps, int n_live, float bn_scale,
                 float threshold, float leak, float v_init, int soft_reset) {
  if (t_in < 1 || t_out < 1 || (t_in != 1 && t_in != t_out) || n_live < 0 ||
      n_live > kMaxTaps || (long long)n * h * w_ >= 0x7fffffffLL || h > 0x7fff ||
      w_ > 0xffff || c > 0xffff || c < 4 || c % 4 != 0 || kp % 4 != 0 || kout < 1 || kout > kp ||
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

int round_up(int a, int b) { return (a + b - 1) / b * b; }

// The shared-memory plan for a tile of ``rows`` A rows (im2col), TB
// steps, ``bp`` pixels and ``bn`` channels; returns the bytes, or -1 when
// even a streamed plan does not fit (or packed weights would not be
// resident). Halo mode for the time-batched tiles where C % 32 == 0, the
// kernel is wider than 1x1 (a 1x1's im2col rows are contiguous already)
// and the weights are resident:
// the pixel tile is a th x tw rectangle inside one block-conv block (the
// shape that wastes the fewest rows at the block's edges), and a channel
// chunk of cc channels (the widest that fits) of its halo is one item.
int plan_smem(Params& p, int tb, int bp, int bn, bool packed) {
  const int rows = tb * bp;
  p.kreal = p.n_live * p.c;
  p.kpad = round_up(p.kreal > 0 ? p.kreal : 32, 32);
  p.g = p.c % 16 == 0 ? 16 : p.c % 8 == 0 ? 8 : 4;
  const int stage = std::max(bp * (bn + 8) * 4, bp * (bn + 16));
  const int aff = 5 * bn * 4;
  const int taps = round_up(3 * kMaxTaps * 4, 16);
  const int units = round_up(p.kpad / p.g * 4, 16);
  const int rowinfo = bp * 16;
  const int rowpix = kStages * bp * 4;
  const int rows_b = packed ? round_up(p.taps_total * p.c * 4, 16) + kThreads * 4 : 0;
  const int fixed = stage + aff + taps + units + rowinfo + rowpix + rows_b;
  const int wres = bn * (p.kpad + 16);
  p.halo = 0;
  if (tb > 1 && p.c % 32 == 0 && p.n_live > 0 && p.pad > 0) {
    int best = -1;  // the tile shape: fewest padded pixels per block, then the smallest halo
    for (int tw = 8; tw <= bp; tw *= 2) {
      const int th = bp / tw;
      const int tyb = (p.bh + th - 1) / th, txb = (p.bw + tw - 1) / tw;
      const int cells = tyb * txb * bp, hpx = (th + 2 * p.pad) * (tw + 2 * p.pad);
      if (best < 0 || cells < best || (cells == best && hpx < p.halo_px)) {
        best = cells;
        p.th = th;
        p.tw = tw;
        p.tyb = tyb;
        p.txb = txb;
        p.halo_px = hpx;
      }
    }
    p.hwid = p.tw + 2 * p.pad;
    for (int cc = p.c; cc >= 32; cc -= 32) {
      if (p.c % cc != 0) continue;
      const int stride = cc + 16;  // an odd multiple of 16: conflict-free ldmatrix rows
      const int a_buf = tb * p.halo_px * stride;
      if (wres + kStages * a_buf + fixed <= kSmemMax) {
        p.halo = 1;
        p.cc = cc;
        p.nch = p.c / cc;
        p.a_stride = stride;
        p.a_buf = a_buf;
        break;
      }
    }
  }
  if (p.halo) {
    p.resident = 1;
    p.kc = p.kpad;
  } else {
    // resident weights if they fit beside the smallest A ring
    p.resident = wres + kStages * rows * (32 + 16) + fixed <= kSmemMax;
    if (!p.resident && packed) return -1;
    // the A chunk: as wide as the bytes left allow, up to kAChunkBytes a stage
    const int per_col = p.resident ? kStages * rows : kStages * (rows + bn);
    const int left = kSmemMax - fixed - (p.resident ? wres : 0);
    const int kc_max = std::min(kAChunkBytes / rows, left / per_col - 16) / 32 * 32;
    if (kc_max < 32) return -1;
    p.nch = (p.kpad + kc_max - 1) / kc_max;
    p.kc = round_up((p.kpad + p.nch - 1) / p.nch, 32);  // balanced chunks
    p.a_stride = p.kc + 16;  // an odd multiple of 16: conflict-free ldmatrix rows
    p.a_buf = rows * p.a_stride;
    p.th = 1;
    p.tw = bp;
    p.hwid = bp;
  }
  p.w_stride = p.resident ? p.kpad + 16 : p.kc + 16;
  const int wbytes = p.resident ? bn * p.w_stride : kStages * bn * p.w_stride;
  p.off_a = wbytes;
  p.off_stage = p.off_a + kStages * p.a_buf;
  p.off_aff = p.off_stage + stage;
  p.off_taps = p.off_aff + aff;
  p.off_units = p.off_taps + taps;
  p.off_rowinfo = p.off_units + units;
  p.off_rowpix = p.off_rowinfo + rowinfo;
  p.off_rows = p.off_rowpix + rowpix;
  p.off_partial = p.off_rows + (packed ? round_up(p.taps_total * p.c * 4, 16) : 0);
  return p.off_rows + rows_b;
}

// The plan of the last launch, for diagnostics: dynamic shared memory,
// steps per pass, pixels and channels per tile, halo mode, the chunk (cc in
// halo mode, else kc bytes), chunks per pass, grid x and y, blocks per SM.
int g_last_plan[10];

template <int TB, int NI, int WM, int WN>
int launch_tile(Params& p, bool packed, cudaStream_t s) {
  using T = Tile<TB, NI, WM, WN>;
  const int smem = plan_smem(p, TB, T::BP, T::BN, packed);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  auto kernel = fused_pipeline_kernel<TB, NI, WM, WN>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int device = 0, sms = 0, occ = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (sms <= 0) sms = 132;
  if (occ <= 0) occ = 1;
  p.ptiles = p.halo ? p.npix / ((long long)p.bh * p.bw) * p.tyb * p.txb
                   : (p.npix + T::BP - 1) / T::BP;
  const long long ctiles = (p.kout + T::BN - 1) / T::BN;
  // persistent blocks: one wave of the card, each walking its pixel tiles
  // with the weights it loaded once
  long long bx = ((long long)sms * occ + ctiles - 1) / ctiles;
  if (bx > p.ptiles) bx = p.ptiles;
  if (bx < 1) bx = 1;
  if (ctiles > 65535 || bx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<dim3((unsigned)bx, (unsigned)ctiles), kThreads, smem, s>>>(p);
  const int plan[10] = {smem, TB, T::BP, T::BN, p.halo, p.halo ? p.cc : p.kc, p.nch, (int)bx,
                        (int)ctiles, occ};
  std::copy(plan, plan + 10, g_last_plan);
  return (int)cudaGetLastError();
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

}  // namespace

extern "C" int fused_pipeline_launch(const void* x, const void* w, const void* affine,
                                     const void* v0, void* spk, void* mem, int t_in, int t_out,
                                     int n, int h, int w_, int c, int kout, int kp, int kh,
                                     int kw, int bh, int bw, const int* taps, int n_live,
                                     float bn_scale, float threshold, float leak,
                                     float v_init, int soft_reset, void* stream) {
  Params p;
  if (!fill_params(p, x, affine, v0, spk, mem, t_in, t_out, n, h, w_, c, kout, kp, kh, kw, bh,
                   bw, taps, n_live, bn_scale, threshold, leak, v_init, soft_reset))
    return (int)cudaErrorInvalidValue;
  p.w = static_cast<const uint8_t*>(w);
  if (p.npix == 0) return 0;
  return launch(p, false, static_cast<cudaStream_t>(stream));
}

extern "C" int fused_pipeline_packed_launch(
    const void* x, const void* maskp, const void* vals, const void* affine, const void* v0,
    void* spk, void* mem, int t_in, int t_out, int n, int h, int w_, int c, int kout,
    int kb_total, int kblk, int vpad, int kh, int kw, int bh, int bw, const int* taps,
    int n_live, float bn_scale, float threshold, float leak, float v_init, int soft_reset,
    void* stream) {
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
  return launch(p, true, static_cast<cudaStream_t>(stream));
}

extern "C" void fused_pipeline_last_plan(int* out) { std::copy(g_last_plan, g_last_plan + 10, out); }
