// Device helpers shared by the port's kernels (included by each .cu; the
// build key of every library covers this header, see backend.py).
#pragma once
#include <stdint.h>

// In-place exclusive prefix sum of vals[0, n) in shared memory: every
// thread sums a contiguous segment, warp shuffles scan the NT segment
// sums, then each thread rewrites its segment. ``partial``: NT ints of
// shared memory. Ends with a barrier.
template <int NT>
__device__ void block_exclusive_scan(int* vals, int n, int* partial) {
  const int seg = (n + NT - 1) / NT;
  const int r0 = min((int)threadIdx.x * seg, n), r1 = min(r0 + seg, n);
  int run = 0;
  for (int r = r0; r < r1; ++r) run += vals[r];
  // exclusive scan of the NT segment sums: within each warp by shuffles,
  // then over the warps' totals
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) partial[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int tot = lane < NT / 32 ? partial[lane] : 0;
    int wincl = tot;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, wincl, o);
      if (lane >= o) wincl += v;
    }
    if (lane < NT / 32) partial[NT / 32 + lane] = wincl - tot;
  }
  __syncthreads();
  run = partial[NT / 32 + warp] + incl - run;
  for (int r = r0; r < r1; ++r) {
    const int v = vals[r];
    vals[r] = run;
    run += v;
  }
  __syncthreads();
}

// The rank walk of the bitmask decode, shared by every packed-weight kernel.
//
// One K-block's mask ``mk`` is (taps, C/8, KBLK) bytes: bit c%8 of byte
// [tap, c/8, k] marks a nonzero weight (tap, c, k), and the K-block's
// nonzero values are packed in (tap, c, k) order. This fills rows[r], for
// r = tap*C + c, with the number of set bits in all rows before r -- the
// value index of row r's first nonzero -- so a block can decode any slice
// of output channels: the weight at (tap, c, k) is
//   vals[rows[r] + (set bits of row r below k)]   when its bit is set.
// Each thread counts the 8 rows of one (tap, c/8) byte row at once (8
// popcounts per 4-byte word), then the block scans them
// (block_exclusive_scan). All NT threads of the block call it;
// ``partial`` is NT ints of shared memory. Needs KBLK % 4 == 0, a 4-byte
// aligned ``mk`` and NT a multiple of 32, at most 1024.
template <int NT>
__device__ void kblock_row_ranks(const uint8_t* mk, int taps, int c, int kblk,
                                 int* rows, int* partial) {
  const int c8 = c / 8;
  for (int u = threadIdx.x; u < taps * c8; u += NT) {
    const uint32_t* words = reinterpret_cast<const uint32_t*>(mk + (long long)u * kblk);
    int cnt[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    for (int q = 0; q < kblk / 4; ++q) {
      const uint32_t wv = __ldg(words + q);
#pragma unroll
      for (int j = 0; j < 8; ++j) cnt[j] += __popc((wv >> j) & 0x01010101u);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) rows[u * 8 + j] = cnt[j];
  }
  __syncthreads();
  block_exclusive_scan<NT>(rows, taps * c, partial);
}

// The same walk at the granularity of the mask's byte rows: out[u], for
// byte row u = tap*C/8 + c/8, is the number of set bits in all byte rows
// before u -- the value index of row (tap, 8*(c/8))'s first nonzero. A
// table 8x smaller than kblock_row_ranks'; the rank of row (tap, c) adds
// the set bits c%8' < c%8 of its byte row (decode_chunk in
// igemm_conv.cuh). Same requirements as kblock_row_ranks.
template <int NT>
__device__ void kblock_byte_row_ranks(const uint8_t* mk, int n_byte_rows, int kblk, int* out,
                                      int* partial) {
  for (int u = threadIdx.x; u < n_byte_rows; u += NT) {
    const uint32_t* words = reinterpret_cast<const uint32_t*>(mk + (long long)u * kblk);
    int cnt = 0;
    for (int q = 0; q < kblk / 4; ++q) cnt += __popc(__ldg(words + q));
    out[u] = cnt;
  }
  __syncthreads();
  block_exclusive_scan<NT>(out, n_byte_rows, partial);
}
