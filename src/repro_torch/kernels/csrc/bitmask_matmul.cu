// Bitmask-compressed sparse-weight matmul for Hopper (sm_90a): the paper's
// weight format (§III-B.2) applied to a dense layer's weights.
//
// Replaces the TPU kernel src/repro/kernels/bitmask_matmul.py
// (bitmask_matmul_pallas, body _kernel):
//
//   out[m, n] = sum over k of x[m, k] * W[k, n]        (f32 result)
//
// with W (K, N) kept compressed in device memory as pack_weights stores it:
// per (KBLK, NBLK) block, one bit per weight packed over K (bit k%8 of byte
// [k/8, n] marks W[k, n] nonzero) and the block's nonzero values in
// row-major order, zero-padded to VPAD. Values are f32, bf16 or int8 and x
// is f32 or bf16. maskp, vals and x are all the kernel reads: W is decoded
// slice by slice into shared memory, never into a dense buffer in device
// memory.
//
// What bounds it on this card: at the FFN shapes (2048 tokens) the
// tensor-core work of the decoded slices, which include the zeros: three
// mma.sync per product, about half of a block's cycles by clock64 phase
// counts, the decode (value gathers, ballots, hi/lo stores) most of the
// rest, in the same warps between the same barriers. At a few tokens
// (decode steps) the per-K-block rank pass and the dependent gathers that
// decode the compressed weights. The design:
//  * products on the tensor cores: mma.sync m16n8k8 in TF32, in the 3xTF32
//    split: a = a_hi + a_lo with a_hi = cvt.rna.tf32(a), a_lo =
//    cvt.rna.tf32(a - a_hi); a_hi*b_hi + a_hi*b_lo + a_lo*b_hi in f32. The
//    split carries 22 of f32's 24 significand bits of each operand and the
//    dropped a_lo*b_lo is below 2^-22 of the product, so each product is
//    f32-accurate to a few ulp. The tensor core's f32 sums are not rounded
//    to nearest (summed over all of K = 2816 they erred 30x more, within
//    2x of the tolerance), so each 32-row slice's sums start from zero and
//    are added into a separate f32 register sum with __fadd_rn: no long
//    chain runs inside the tensor core, and the result stays within the
//    f32 kernel's tolerance 1e-5*(|x|@|W|) + 1e-6. Where x is bf16 and
//    the values bf16 or int8, every product of two bf16 is exact in f32,
//    so one bf16 mma.sync m16n8k16 pass per product does the same work;
//  * a 128 x 128 output tile: one rank and decode of a weight slice serves
//    128 rows of x, and one x slice serves 128 columns (x is re-read from
//    L2 once per 128 columns of W); 16 warps each own 32 x 32 of it;
//  * double buffering, software-pipelined: while the tensor cores multiply
//    slice s, slice s+1's decoded values are stored to the other buffer
//    and its x slice is in flight by cp.async, slice s+2's value gathers
//    are in flight into registers, and slice s+3's mask bytes are loaded;
//  * small M: when the output tiles fill less than half the SMs, the
//    slices are split across blocks (split-K) up to one block per SM; each
//    split writes its partial tile to a workspace and a second kernel sums
//    the splits in a fixed order, so the result is the same run to run.
// Ranks, per K-block: R threads share a mask byte row, counting its 8
// rows' set bits over 16-column chunks (16-byte loads) and reducing by
// shuffles; a warp scan turns byte-row totals into offsets. Per slice: a warp
// owns one byte row and 2 of its bits over the tile's 128 columns, and four
// ballots per row give each column its rank inside the tile. No derived
// table is stored.
//
// Layouts (all contiguous):
//  x      (M, K)               f32 or bf16 (K not padded)
//  maskp  (KB, NB, KBLK/8, NBLK) uint8
//  vals   (KB, NB, VPAD)       f32, bf16 or int8
//  out    (M, N)               f32, N <= NB*NBLK
//  ws     (splits, M, N)       f32 workspace, only when splits > 1
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 512;  // 16 warps, 4 x 4 over the tile, each 32 x 32
constexpr int BM = 128;  // output rows a block owns
constexpr int BN = 128;  // output columns a block owns (inside one n-block)
constexpr int BK = 32;   // weight rows decoded at a time: 4 mask byte rows
constexpr int kMaxKblk = 4096;
constexpr int kMaxSplits = 16;
constexpr unsigned kAll = 0xffffffffu;
constexpr int WS_STRIDE = BN + 8;  // decoded slice row, in elements: conflict-free B reads

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }

// A weight value's bits, loaded with a volatile asm so that the load is
// issued where it stands (a slice ahead of its use), and converted to f32
// only where it is stored.
__device__ __forceinline__ uint32_t ld_bits(const float* p) {
  uint32_t v;
  asm volatile("ld.global.nc.b32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ uint32_t ld_bits(const __nv_bfloat16* p) {
  unsigned short v;
  asm volatile("ld.global.nc.b16 %0, [%1];" : "=h"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ uint32_t ld_bits(const int8_t* p) {
  int v;
  asm volatile("ld.global.nc.s8 %0, [%1];" : "=r"(v) : "l"(p));
  return (uint32_t)v;
}
__device__ __forceinline__ float bits_f32(uint32_t v, float) { return __uint_as_float(v); }
__device__ __forceinline__ float bits_f32(uint32_t v, __nv_bfloat16) {
  return __bfloat162float(__ushort_as_bfloat16((unsigned short)v));
}
__device__ __forceinline__ float bits_f32(uint32_t v, int8_t) { return (float)(int)v; }

__device__ __forceinline__ uint32_t tf32(float f) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(f));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared; bytes past ``src_bytes`` are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

struct Params {
  const void* x;
  const uint8_t* maskp;
  const void* vals;
  float* out;  // (M, N), or the (splits, M, N) workspace
  int m, k, n;
  int kb_total, nb_total, kblk, nblk, vpad;
  int tiles_per_nb;     // ceil(NBLK / BN)
  int slices_per_kb;    // ceil(KBLK / BK)
  int slices_per_split;
  int x_vec;            // x rows are 16-byte aligned: cp.async
};

// bf16 mode: x bf16 and values bf16 or int8 -- one exact bf16 pass.
template <typename XT, typename VT>
struct Mode {
  static constexpr bool kBf16 = sizeof(XT) == 2 && sizeof(VT) <= 2;
};

template <typename XT>
struct XSlice {  // x slice [BM][BK + pad], k contiguous
  static constexpr int kStride = sizeof(XT) == 4 ? BK + 4 : BK + 8;
};

// Shared memory of one block: two x slices, two decoded weight slices
// (TF32: hi and lo planes of f32 words; bf16: one plane of bf16), then
// the per-K-block ranks (dynamic: KBLK + KBLK/8 ints).
template <typename XT, typename VT>
struct Smem {
  static constexpr int kX = BM * XSlice<XT>::kStride * (int)sizeof(XT);
  static constexpr int kW = Mode<XT, VT>::kBf16 ? BK * WS_STRIDE * 2 : 2 * BK * WS_STRIDE * 4;
  static constexpr int kFixed = 2 * kX + 2 * kW;
};

// Ranks of K-block ``mk``'s rows for the tile at column c0: rowbase[r] is
// the index of row r's first value at or after c0, counted from its byte
// row's first value; bytestart[u] the values before byte row u. R threads
// share a mask byte row, each counting the 8 rows' set bits over 16-column
// chunks (16-byte loads, all in flight), reduced by shuffles; a warp scan
// then turns byte-row totals into offsets. All threads call it (it
// synchronises).
__device__ void rank_kblock(const Params& p, const uint8_t* mk, int c0, int* rowbase,
                            int* bytestart) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k8 = p.kblk / 8;
  const int chunks = (p.nblk + 15) / 16;
  int r_per = 1;  // threads per byte row: a power of two up to a warp
  while (r_per < chunks && r_per < 32) r_per <<= 1;
  const int tt = threadIdx.x & (r_per - 1);
  const bool vec = p.nblk % 16 == 0;
  __syncthreads();  // the previous K-block's ranks are no longer read
  for (int u0 = 0; u0 < k8; u0 += kThreads / r_per) {
    const int u = u0 + threadIdx.x / r_per;
    int full[8], pre[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) full[j] = pre[j] = 0;
    if (u < k8) {
      const uint8_t* row = mk + (long long)u * p.nblk;
      for (int ch = tt; ch < chunks; ch += r_per) {
        const int col = ch * 16;
        uint32_t wv[4];
        if (vec) {
          const uint4 q = __ldg(reinterpret_cast<const uint4*>(row + col));
          wv[0] = q.x;
          wv[1] = q.y;
          wv[2] = q.z;
          wv[3] = q.w;
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            wv[i] = 0u;
#pragma unroll
            for (int b = 0; b < 4; ++b)
              if (col + 4 * i + b < p.nblk) wv[i] |= (uint32_t)__ldg(row + col + 4 * i + b) << (8 * b);
          }
        }
        const bool left = col < c0;  // c0 is a multiple of 64: the chunk is all left or not
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int cnt = __popc((wv[0] >> j) & 0x01010101u) + __popc((wv[1] >> j) & 0x01010101u) +
                          __popc((wv[2] >> j) & 0x01010101u) + __popc((wv[3] >> j) & 0x01010101u);
          full[j] += cnt;
          if (left) pre[j] += cnt;
        }
      }
    }
    for (int d = r_per / 2; d >= 1; d >>= 1) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        full[j] += __shfl_xor_sync(kAll, full[j], d);
        pre[j] += __shfl_xor_sync(kAll, pre[j], d);
      }
    }
    if (u < k8 && tt == 0) {
      int run = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        rowbase[u * 8 + j] = run + pre[j];
        run += full[j];
      }
      bytestart[u] = run;  // the byte row's total, scanned below
    }
  }
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the byte-row totals
    int carry = 0;
    for (int base = 0; base < k8; base += 32) {
      const int u = base + lane;
      const int v = u < k8 ? bytestart[u] : 0;
      int incl = v;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kAll, incl, d);
        if (lane >= d) incl += y;
      }
      if (u < k8) bytestart[u] = carry + incl - v;
      carry += __shfl_sync(kAll, incl, 31);
    }
  }
  __syncthreads();
}

template <typename XT, typename VT>
__global__ void __launch_bounds__(kThreads, 1) bitmask_matmul_kernel(const Params p) {
  constexpr bool kBf16 = Mode<XT, VT>::kBf16;
  constexpr int XS = XSlice<XT>::kStride;
  extern __shared__ __align__(16) unsigned char smem[];
  // buffer b of the x slices and of the decoded weight slices
  auto xs = [&](int b) { return reinterpret_cast<XT*>(smem + b * Smem<XT, VT>::kX); };
  auto wsb = [&](int b) { return smem + 2 * Smem<XT, VT>::kX + b * Smem<XT, VT>::kW; };
  int* rowbase = reinterpret_cast<int*>(smem + Smem<XT, VT>::kFixed);  // [KBLK]
  int* bytestart = rowbase + p.kblk;                                  // [KBLK/8]

  const XT* x = static_cast<const XT*>(p.x);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int nb = blockIdx.x / p.tiles_per_nb;
  const int c0 = (blockIdx.x % p.tiles_per_nb) * BN;  // tile's first column in the n-block
  const int m0 = blockIdx.y * BM;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 32;  // the warp's 32 x 32 sub-tile
  const int k8 = p.kblk / 8;
  const unsigned lanes_below = (1u << lane) - 1u;
  // decode: byte row du of the slice, bits dj0 and dj0+1, columns lane + 32*h
  const int du = warp & 3, dj0 = (warp >> 2) * 2;

  const int n_slices = p.kb_total * p.slices_per_kb;
  const int s_lo = blockIdx.z * p.slices_per_split;
  const int s_hi = min(n_slices, s_lo + p.slices_per_split);

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // x slice s -> xs[buf], zero past K, past the K-block and past M
  auto load_x = [&](int s, int buf) {
    const int kb = s / p.slices_per_kb;
    const int kin = (s % p.slices_per_kb) * BK;
    const long long kg0 = (long long)kb * p.kblk + kin;
    const int kend = (int)min((long long)BK, min((long long)p.kblk - kin, (long long)p.k - kg0));
    constexpr int kPer = 16 / (int)sizeof(XT);  // elements per 16-byte unit
    XT* dst = xs(buf);
    if (p.x_vec) {
      for (int e = tid; e < BM * (BK / kPer); e += kThreads) {
        const int i = e / (BK / kPer), q = (e % (BK / kPer)) * kPer;
        const int m = m0 + i;
        const int valid = m < p.m ? max(0, min(kPer, kend - q)) : 0;
        const XT* src = valid > 0 ? x + (long long)m * p.k + kg0 + q : x;
        cp_async16(dst + i * XS + q, src, valid * (int)sizeof(XT));
      }
      cp_async_commit();
    } else {
      for (int e = tid; e < BM * BK; e += kThreads) {
        const int i = e / BK, q = e % BK;
        const int m = m0 + i;
        dst[i * XS + q] = (m < p.m && q < kend) ? x[(long long)m * p.k + kg0 + q] : XT(0.f);
      }
    }
  };

  // the mask bytes of slice s this thread decodes: byte row du, columns
  // lane + 32*h of the tile
  auto load_mask = [&](int s, uint32_t (&b)[4]) {
    const int kb = s / p.slices_per_kb;
    const int u = (s % p.slices_per_kb) * (BK / 8) + du;
    const uint8_t* mk = p.maskp + ((long long)kb * p.nb_total + nb) * k8 * p.nblk;
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int col = c0 + lane + 32 * h;
      b[h] = (u < k8 && col < p.nblk) ? __ldg(mk + (long long)u * p.nblk + col) : 0u;
    }
  };

  // issue the value gathers of slice s from its mask bytes b: v[jj][h] is
  // the bits of W at (slice row du*8 + dj0 + jj, tile column lane + 32*h);
  // a value's rank in the tile's row is the set bits of the column groups
  // before it (ballot totals) and of the lanes below it in its group
  auto gather = [&](int s, const uint32_t (&b)[4], uint32_t (&v)[2][4]) {
    const int kb = s / p.slices_per_kb;
    const int u = (s % p.slices_per_kb) * (BK / 8) + du;
    const VT* vk = static_cast<const VT*>(p.vals) + ((long long)kb * p.nb_total + nb) * p.vpad;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int j = dj0 + jj;
      unsigned bal[4];
      unsigned any = 0u;
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        bal[h] = __ballot_sync(kAll, (b[h] >> j) & 1u);
        any |= bal[h];
      }
      int idx = any != 0u ? bytestart[u] + rowbase[u * 8 + j] : 0;
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int i = idx + __popc(bal[h] & lanes_below);
        v[jj][h] = ((b[h] >> j) & 1u) ? ld_bits(vk + min(i, p.vpad - 1)) : 0u;  // clipped
        idx += __popc(bal[h]);                                                  // like the TPU
      }
    }
  };

  auto store_w = [&](const uint32_t (&v)[2][4], int buf) {
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int r = du * 8 + dj0 + jj;
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int c = lane + 32 * h;
        const float f = bits_f32(v[jj][h], VT());
        if constexpr (kBf16) {
          reinterpret_cast<__nv_bfloat16*>(wsb(buf))[r * WS_STRIDE + c] = __float2bfloat16_rn(f);
        } else {
          const uint32_t hi = tf32(f);
          const uint32_t lo = tf32(__fsub_rn(f, __uint_as_float(hi)));
          uint32_t* w = reinterpret_cast<uint32_t*>(wsb(buf));
          w[r * WS_STRIDE + c] = hi;
          w[BK * WS_STRIDE + r * WS_STRIDE + c] = lo;
        }
      }
    }
  };

  // the tensor-core products of one slice into sacc
  auto multiply = [&](int buf, float (&sacc)[2][4][4]) {
    const XT* xa = xs(buf);
    if constexpr (kBf16) {
      const __nv_bfloat16* wb = reinterpret_cast<const __nv_bfloat16*>(wsb(buf));
      const unsigned short* wraw = reinterpret_cast<const unsigned short*>(wb);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const XT* r0 = xa + (wm + mi * 16 + g) * XS + kk + 2 * tig;
          const XT* r8 = r0 + 8 * XS;
          a[mi][0] = *reinterpret_cast<const uint32_t*>(r0);
          a[mi][1] = *reinterpret_cast<const uint32_t*>(r8);
          a[mi][2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
          a[mi][3] = *reinterpret_cast<const uint32_t*>(r8 + 8);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int c = wn + ni * 8 + g;
          const int k0 = kk + 2 * tig;
          const uint32_t b0 = (uint32_t)wraw[k0 * WS_STRIDE + c] |
                              ((uint32_t)wraw[(k0 + 1) * WS_STRIDE + c] << 16);
          const uint32_t b1 = (uint32_t)wraw[(k0 + 8) * WS_STRIDE + c] |
                              ((uint32_t)wraw[(k0 + 9) * WS_STRIDE + c] << 16);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) mma_bf16(sacc[mi][ni], a[mi], b0, b1);
        }
      }
    } else {
      const uint32_t* wh = reinterpret_cast<const uint32_t*>(wsb(buf));
      const uint32_t* wl = wh + BK * WS_STRIDE;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 8) {
        uint32_t ahi[2][4], alo[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = wm + mi * 16 + g + (e & 1) * 8, c = kk + tig + (e >> 1) * 4;
            const float f = to_f32(xa[r * XS + c]);
            ahi[mi][e] = tf32(f);
            alo[mi][e] = tf32(__fsub_rn(f, __uint_as_float(ahi[mi][e])));
          }
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int c = wn + ni * 8 + g;
          const uint32_t bh0 = wh[(kk + tig) * WS_STRIDE + c];
          const uint32_t bh1 = wh[(kk + tig + 4) * WS_STRIDE + c];
          const uint32_t bl0 = wl[(kk + tig) * WS_STRIDE + c];
          const uint32_t bl1 = wl[(kk + tig + 4) * WS_STRIDE + c];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma_tf32(sacc[mi][ni], alo[mi], bh0, bh1);
            mma_tf32(sacc[mi][ni], ahi[mi], bl0, bl1);
            mma_tf32(sacc[mi][ni], ahi[mi], bh0, bh1);
          }
        }
      }
    }
  };

  // Software pipeline over the slices: in iteration s the tensor cores
  // multiply slice s; slice s+1's values (gathered in iteration s-1) are
  // stored and its x slice is in flight; slice s+2's value gathers are
  // issued; slice s+3's mask bytes are loaded.
  if (s_lo < s_hi) {
    uint32_t v[2][4], mb[4];
    int cur_kb = s_lo / p.slices_per_kb;
    auto ranks_for = [&](int s) {  // the ranks of slice s's K-block, where they change
      const int kb = s / p.slices_per_kb;
      if (kb != cur_kb) {
        cur_kb = kb;
        rank_kblock(p, p.maskp + ((long long)kb * p.nb_total + nb) * k8 * p.nblk, c0, rowbase,
                    bytestart);
      }
    };
    rank_kblock(p, p.maskp + ((long long)cur_kb * p.nb_total + nb) * k8 * p.nblk, c0, rowbase,
                bytestart);
    load_x(s_lo, 0);
    load_mask(s_lo, mb);
    gather(s_lo, mb, v);
    store_w(v, 0);
    if (s_lo + 1 < s_hi) {
      ranks_for(s_lo + 1);
      load_mask(s_lo + 1, mb);
      gather(s_lo + 1, mb, v);
    }
    if (s_lo + 2 < s_hi) load_mask(s_lo + 2, mb);
    cp_async_wait_all();
    __syncthreads();
    for (int s = s_lo; s < s_hi; ++s) {
      const int cur = (s - s_lo) & 1;
      if (s + 1 < s_hi) {
        store_w(v, cur ^ 1);
        load_x(s + 1, cur ^ 1);
      }
      if (s + 2 < s_hi) {
        ranks_for(s + 2);
        gather(s + 2, mb, v);
        if (s + 3 < s_hi) load_mask(s + 3, mb);
      }
      float sacc[2][4][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sacc[i][j][e] = 0.f;
      multiply(cur, sacc);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = __fadd_rn(acc[i][j][e], sacc[i][j][e]);
      cp_async_wait_all();
      __syncthreads();
    }
  }

  // the tile out: C fragment element e at row g + 8*(e/2), column 2*tig + e%2
  float* out = p.out + (long long)blockIdx.z * p.m * p.n;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm + mi * 16 + g + (e >> 1) * 8;
        const int col = c0 + wn + ni * 8 + 2 * tig + (e & 1);
        const long long n = (long long)nb * p.nblk + col;
        if (m < p.m && col < p.nblk && n < p.n) out[(long long)m * p.n + n] = acc[mi][ni][e];
      }
}

// out[i] = ws[0][i] + ws[1][i] + ... in that order: a deterministic sum of
// the split-K partials
__global__ void __launch_bounds__(kThreads) split_sum_kernel(const float* ws, float* out,
                                                             long long count, int splits) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < count;
       i += (long long)gridDim.x * kThreads) {
    float s = ws[i];
    for (int z = 1; z < splits; ++z) s = __fadd_rn(s, ws[(long long)z * count + i]);
    out[i] = s;
  }
}

// The plan of the last launch, for diagnostics: dynamic shared memory,
// K-splits, grid x, y and z.
int g_last_plan[5];

template <typename XT, typename VT>
int launch(Params p, int splits, float* out, cudaStream_t stream) {
  const size_t smem = Smem<XT, VT>::kFixed + (size_t)(p.kblk + p.kblk / 8) * sizeof(int);
  const cudaError_t e = cudaFuncSetAttribute(
      bitmask_matmul_kernel<XT, VT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(p.nb_total * p.tiles_per_nb), (unsigned)((p.m + BM - 1) / BM),
                  (unsigned)splits);
  bitmask_matmul_kernel<XT, VT><<<grid, kThreads, smem, stream>>>(p);
  const int plan[5] = {(int)smem, splits, (int)grid.x, (int)grid.y, (int)grid.z};
  std::copy(plan, plan + 5, g_last_plan);
  if (splits > 1) {
    const long long count = (long long)p.m * p.n;
    const long long blocks = std::min((count + kThreads - 1) / kThreads, 132LL * 8);
    split_sum_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(p.out, out, count, splits);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The number of K-splits the kernel uses for these shapes (1: none), so
// the caller can size the (splits, M, N) f32 workspace.
extern "C" int bitmask_matmul_splits(int m, int k, int n, int kb_total, int nb_total, int kblk,
                                     int nblk) {
  (void)k;
  (void)n;
  if (m < 1 || kblk < 8 || nblk < 1) return 1;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (sms <= 0) sms = 132;
  const long long tiles = (long long)nb_total * ((nblk + BN - 1) / BN) * ((m + BM - 1) / BM);
  const long long n_slices = (long long)kb_total * ((kblk + BK - 1) / BK);
  // one block per SM: split only while the splits still fit in one wave
  long long splits = std::min((long long)sms / std::max(tiles, 1LL), (long long)kMaxSplits);
  if (splits <= 1) return 1;
  const long long per = (n_slices + splits - 1) / splits;  // at least one slice each
  return (int)((n_slices + per - 1) / per);
}

// x_dtype: 0 = float32, 1 = bfloat16; v_dtype: 0 = float32, 1 = bfloat16,
// 2 = int8. ``ws``: (splits, M, N) f32, splits from bitmask_matmul_splits
// (null when that is 1).
extern "C" int bitmask_matmul_launch(const void* x, const void* maskp, const void* vals,
                                     void* out, void* ws, int m, int k, int n, int kb_total,
                                     int nb_total, int kblk, int nblk, int vpad, int x_dtype,
                                     int v_dtype, void* stream) {
  if (m < 0 || k < 0 || n < 0 || kb_total < 1 || nb_total < 1 || kblk < 8 || kblk % 8 != 0 ||
      kblk > kMaxKblk || nblk < 1 || vpad < 1 || k > (long long)kb_total * kblk ||
      n > (long long)nb_total * nblk || x_dtype < 0 || x_dtype > 1 || v_dtype < 0 ||
      v_dtype > 2)
    return (int)cudaErrorInvalidValue;
  if (m == 0 || n == 0) return 0;
  const int splits = bitmask_matmul_splits(m, k, n, kb_total, nb_total, kblk, nblk);
  if (splits > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  Params p{};
  p.x = x;
  p.maskp = static_cast<const uint8_t*>(maskp);
  p.vals = vals;
  p.out = static_cast<float*>(splits > 1 ? ws : out);
  p.m = m;
  p.k = k;
  p.n = n;
  p.kb_total = kb_total;
  p.nb_total = nb_total;
  p.kblk = kblk;
  p.nblk = nblk;
  p.vpad = vpad;
  p.tiles_per_nb = (nblk + BN - 1) / BN;
  p.slices_per_kb = (kblk + BK - 1) / BK;
  const int n_slices = kb_total * p.slices_per_kb;
  p.slices_per_split = (n_slices + splits - 1) / splits;
  const int xsize = x_dtype == 0 ? 4 : 2;
  p.x_vec = ((long long)k * xsize) % 16 == 0 && (reinterpret_cast<uintptr_t>(x) % 16) == 0 &&
            (kblk * xsize) % 16 == 0;
  if ((long long)nb_total * p.tiles_per_nb > 0x7fffffffLL || (m + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (x_dtype == 0) {
    if (v_dtype == 0) return launch<float, float>(p, splits, o, s);
    if (v_dtype == 1) return launch<float, __nv_bfloat16>(p, splits, o, s);
    return launch<float, int8_t>(p, splits, o, s);
  }
  if (v_dtype == 0) return launch<__nv_bfloat16, float>(p, splits, o, s);
  if (v_dtype == 1) return launch<__nv_bfloat16, __nv_bfloat16>(p, splits, o, s);
  return launch<__nv_bfloat16, int8_t>(p, splits, o, s);
}

extern "C" void bitmask_matmul_last_plan(int* out) { std::copy(g_last_plan, g_last_plan + 5, out); }
