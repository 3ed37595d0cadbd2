// Bitmask-compressed sparse-weight matmul for Hopper (sm_90a): the paper's
// weight format (§III-B.2) applied to a dense layer's weights.
//
// Replaces the TPU kernel src/repro/kernels/bitmask_matmul.py
// (bitmask_matmul_pallas, body _kernel):
//
//   out[m, n] = sum over k of x[m, k] * W[k, n]        (f32, f32 accumulate)
//
// with W (K, N) kept compressed in device memory as pack_weights stores it:
// per (KBLK, NBLK) block, one bit per weight packed over K (bit k%8 of byte
// [k/8, n] marks W[k, n] nonzero) and the block's nonzero values in
// row-major order, zero-padded to VPAD. Values are f32, bf16 or int8 and x
// is f32 or bf16; each is converted to f32 on load, as the Pallas body does.
//
// Each block owns a BM x BN tile of the output inside one n-block and walks
// every K-block with an f32 accumulator in registers (the TPU kernel's k-
// innermost grid axis becomes that loop). Per K-block it
//  1. ranks the block's mask rows: one warp per mask byte row, ballots per
//     bit, giving for each of the KBLK rows the value index of its first
//     nonzero at or after the tile's first column (rows before it in
//     row-major order, plus that row's set bits left of the tile); a warp
//     scan turns byte-row totals into offsets. An all-zero block is skipped;
//  2. walks the K-block BK rows at a time: decodes the BK x BN weight slice
//     into shared memory (ballots give each column its rank inside the
//     tile), stages the matching x slice, and multiplies: each thread 4
//     rows x 8 columns, f32 fused multiply-adds (__fmaf_rn).
// A whole decoded 512 x 256 f32 block is 512 KB, past a block's 227 KB of
// shared memory; the slices keep a block at ~44 KB.
//
// Precision: f32 products and sums, no TF32. The sum order differs from any
// reference, so the kernel is held to a tolerance, not to bit-equality.
//
// What bounds it on this card: operations. It decodes W to dense slices and
// multiplies every weight, zero or not, on the f32 FMA units (no tensor
// cores: TF32 would be another function); 2*M*K*N flops against the
// 2*M*nnz the bound counts. The compressed weights are read once per
// output tile from L2.
//
// Layouts (all contiguous):
//  x      (M, K)               f32 or bf16 (K not padded)
//  maskp  (KB, NB, KBLK/8, NBLK) uint8
//  vals   (KB, NB, VPAD)       f32, bf16 or int8
//  out    (M, N)               f32, N <= NB*NBLK
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int BM = 64;   // output rows a block owns
constexpr int BN = 128;  // output columns a block owns (inside one n-block)
constexpr int BK = 32;   // weight rows decoded at a time: 4 mask byte rows
constexpr int kMaxKblk = 4096;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }

struct Params {
  const void* x;
  const uint8_t* maskp;
  const void* vals;
  float* out;
  int m, k, n;
  int kb_total, nb_total, kblk, nblk, vpad;
  int tiles_per_nb;  // ceil(NBLK / BN)
};

template <typename XT, typename VT>
__global__ void __launch_bounds__(kThreads) bitmask_matmul_kernel(const Params p) {
  __shared__ __align__(16) float xs[BK][BM + 4];  // x slice, k-major
  __shared__ __align__(16) float ws[BK][BN];      // decoded weight slice
  __shared__ int wtot[BK / 8][BN / 32][8];        // set bits per (byte row, warp, bit)
  __shared__ int block_nnz;
  extern __shared__ int dyn[];
  int* rowbase = dyn;             // [KBLK]: row's first value index, within its byte row
  int* bytestart = dyn + p.kblk;  // [KBLK/8]: values before the byte row

  const XT* x = static_cast<const XT*>(p.x);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = blockIdx.x / p.tiles_per_nb;
  const int c0 = (blockIdx.x % p.tiles_per_nb) * BN;  // tile's first column in the n-block
  const int m0 = blockIdx.y * BM;
  const int k8 = p.kblk / 8;
  const int tx = tid % 16, ty = tid / 16;  // columns tx*4+{0..3}, 64+tx*4+{0..3}; rows ty*4+{0..3}
  const int c = tid % BN, slot = tid / BN;  // decode: a column, and one of 2 byte rows
  const unsigned lanes_below = (1u << lane) - 1u;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int kb = 0; kb < p.kb_total; ++kb) {
    const long long blk = (long long)kb * p.nb_total + nb;
    const uint8_t* mk = p.maskp + blk * k8 * p.nblk;
    const VT* vk = static_cast<const VT*>(p.vals) + blk * p.vpad;

    // 1. ranks: per byte row u, each bit j's set count over the whole row
    //    and over the columns left of the tile
    for (int u = warp; u < k8; u += kThreads / 32) {
      const uint8_t* row = mk + (long long)u * p.nblk;
      int full[8], pre[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) full[j] = pre[j] = 0;
      for (int base = 0; base < p.nblk; base += 32) {
        const int col = base + lane;
        const unsigned b = col < p.nblk ? __ldg(row + col) : 0u;
        const unsigned left = __ballot_sync(kAll, col < c0);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const unsigned bal = __ballot_sync(kAll, (b >> j) & 1u);
          full[j] += __popc(bal);
          pre[j] += __popc(bal & left);
        }
      }
      if (lane == 0) {
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
      if (lane == 0) block_nnz = carry;
    }
    __syncthreads();
    if (block_nnz == 0) continue;  // an all-zero weight block adds nothing

    // 2. the K-block, BK rows at a time
    for (int u0 = 0; u0 < k8; u0 += BK / 8) {
      uint32_t bytes[2];
      int pfx[2][8];
#pragma unroll
      for (int ps = 0; ps < 2; ++ps) {
        const int r8 = ps * 2 + slot, u = u0 + r8, col = c0 + c;
        const uint32_t b =
            (u < k8 && col < p.nblk) ? __ldg(mk + (long long)u * p.nblk + col) : 0u;
        bytes[ps] = b;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const unsigned bal = __ballot_sync(kAll, (b >> j) & 1u);
          pfx[ps][j] = __popc(bal & lanes_below);
          if (lane == 0) wtot[r8][c / 32][j] = __popc(bal);
        }
      }
      for (int e = tid; e < BM * BK; e += kThreads) {
        const int i = e / BK, r = e % BK;  // consecutive threads: consecutive k
        const int kk = u0 * 8 + r;
        const long long kg = (long long)kb * p.kblk + kk;
        const int m = m0 + i;
        xs[r][i] = (kk < p.kblk && kg < p.k && m < p.m) ? to_f32(x[(long long)m * p.k + kg])
                                                          : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int ps = 0; ps < 2; ++ps) {
        const int r8 = ps * 2 + slot, u = u0 + r8;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float w = 0.f;
          if ((bytes[ps] >> j) & 1u) {
            int idx = bytestart[u] + rowbase[u * 8 + j] + pfx[ps][j];
            for (int q = 0; q < c / 32; ++q) idx += wtot[r8][q][j];
            w = to_f32(vk[min(idx, p.vpad - 1)]);  // clipped like the TPU gather
          }
          ws[r8 * 8 + j][c] = w;
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&ws[kk][64 + tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= p.m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      const long long n = (long long)nb * p.nblk + col;
      if (col < p.nblk && n < p.n) p.out[(long long)m * p.n + n] = acc[i][j];
    }
  }
}

template <typename XT, typename VT>
int launch(const Params& p, cudaStream_t stream) {
  const dim3 grid((unsigned)(p.nb_total * p.tiles_per_nb), (unsigned)((p.m + BM - 1) / BM));
  const size_t smem = (size_t)(p.kblk + p.kblk / 8) * sizeof(int);
  bitmask_matmul_kernel<XT, VT><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// x_dtype: 0 = float32, 1 = bfloat16; v_dtype: 0 = float32, 1 = bfloat16,
// 2 = int8.
extern "C" int bitmask_matmul_launch(const void* x, const void* maskp, const void* vals,
                                     void* out, int m, int k, int n, int kb_total,
                                     int nb_total, int kblk, int nblk, int vpad, int x_dtype,
                                     int v_dtype, void* stream) {
  if (m < 0 || k < 0 || n < 0 || kb_total < 1 || nb_total < 1 || kblk < 8 || kblk % 8 != 0 ||
      kblk > kMaxKblk || nblk < 1 || vpad < 1 || k > (long long)kb_total * kblk ||
      n > (long long)nb_total * nblk || x_dtype < 0 || x_dtype > 1 || v_dtype < 0 ||
      v_dtype > 2)
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.x = x;
  p.maskp = static_cast<const uint8_t*>(maskp);
  p.vals = vals;
  p.out = static_cast<float*>(out);
  p.m = m;
  p.k = k;
  p.n = n;
  p.kb_total = kb_total;
  p.nb_total = nb_total;
  p.kblk = kblk;
  p.nblk = nblk;
  p.vpad = vpad;
  p.tiles_per_nb = (nblk + BN - 1) / BN;
  if ((long long)nb_total * p.tiles_per_nb > 0x7fffffffLL || (m + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  if (m == 0 || n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) {
    if (v_dtype == 0) return launch<float, float>(p, s);
    if (v_dtype == 1) return launch<float, __nv_bfloat16>(p, s);
    return launch<float, int8_t>(p, s);
  }
  if (v_dtype == 0) return launch<__nv_bfloat16, float>(p, s);
  if (v_dtype == 1) return launch<__nv_bfloat16, __nv_bfloat16>(p, s);
  return launch<__nv_bfloat16, int8_t>(p, s);
}
