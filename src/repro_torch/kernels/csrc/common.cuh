// Device helpers shared by the port's kernels (included by each .cu; the
// build key of every library covers this header, see backend.py).
#pragma once
#include <stdint.h>

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
// popcounts per 4-byte word), then the block scans: every thread sums a
// contiguous segment, then warp shuffles scan the NT segment sums. All NT
// threads of the block call it; ``partial`` is NT ints of shared memory. Needs
// KBLK % 4 == 0, a 4-byte aligned ``mk`` and NT a multiple of 32, at most
// 1024.
template <int NT>
__device__ void kblock_row_ranks(const uint8_t* mk, int taps, int c, int kblk,
                                 int* rows, int* partial) {
  const int c8 = c / 8, nrows = taps * c;
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
  const int seg = (nrows + NT - 1) / NT;
  const int r0 = min((int)threadIdx.x * seg, nrows), r1 = min(r0 + seg, nrows);
  int run = 0;
  for (int r = r0; r < r1; ++r) run += rows[r];
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
    const int v = rows[r];
    rows[r] = run;
    run += v;
  }
  __syncthreads();
}
