// Device helpers shared by the port's kernels (included by each .cu; the
// build key of every library covers this header, see backend.py).
#pragma once
#include <stdint.h>

// unsigned bytes of a (inputs: spikes or u8 pixels) times signed bytes of b
// (weights), summed into c: exact in int32
__device__ __forceinline__ int dp4a_us(uint32_t a, int b, int c) {
  int d;
  asm("dp4a.u32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
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
// popcounts per 4-byte word), then the block scans: every thread sums a
// contiguous segment, thread 0 scans the NT segment sums. All NT threads
// of the block call it; ``partial`` is NT ints of shared memory. Needs
// KBLK % 4 == 0 and a 4-byte aligned ``mk``.
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
  partial[threadIdx.x] = run;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int i = 0; i < NT; ++i) {
      const int v = partial[i];
      partial[i] = total;
      total += v;
    }
  }
  __syncthreads();
  run = partial[threadIdx.x];
  for (int r = r0; r < r1; ++r) {
    const int v = rows[r];
    rows[r] = run;
    run += v;
  }
  __syncthreads();
}
