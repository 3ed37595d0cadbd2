// The int8 tensor-core block conv shared by the port's two conv kernels:
// fused_pipeline.cu (conv -> tdBN -> LIF) and gated_one_to_all.cu (conv ->
// int32 sums). Each instantiates conv_tiles() with its own epilogue.
//
// The conv of one step (a time step, or an image of the gated kernel's M)
// is a GEMM: rows = the block's pixel tile, columns = its output-channel
// tile, K-dim = live taps x C (zero-padded to a multiple of 32), on
// mma.sync m16n8k32 u8 x s8 -> s32: binary spikes, or the encode layer's
// u8 pixels, times int8 weights. Integer sums are exact in any order.
//
//  * weights resident: each persistent block copies (predecoded) or
//    decodes (packed: the rank walk of common.cuh) its output-channel tile
//    of the weights into shared memory once, [channel][K-dim] bytes, and
//    reuses it over every step and pixel tile it walks. A tile whose
//    weights do not fit is streamed in K-chunks beside the inputs, through
//    a ring of B buffers: copied (predecoded), or decoded there by the
//    producer (packed, decode_chunk); or, where the caller asks for it
//    (plan_smem's ``segments``), decoded one K-dim segment at a time (the
//    caller walks the segments and its epilogue adds their sums);
//  * the A operand, in a ring of kStages shared-memory buffers (two items
//    in flight while the tensor cores run one), two ways:
//    - im2col: a block-clamped im2col chunk per item, cp.async gathers of
//      16, 8 or 4 bytes per (pixel, live tap) as C allows;
//    - halo: the pixel tile is a th x tw rectangle inside one block-conv
//      block; an item copies cc channels of its (th+2p) x (tw+2p) halo,
//      each halo pixel clamped to the block, and ldmatrix reads each tap's
//      A rows at the tap's shift. C % 32 == 0 takes cc channels of one tap
//      per 32-byte k-step; C == 16 takes two taps' 16-byte rows per k-step
//      (the lanes of the upper half address the second tap's pixels);
//  * TB steps batched per pass (A rows = TB x the pixel tile): a warp's TB
//    accumulator chains per n8 tile share its B fragments.
//
// Block convolution: neighbour coordinates are clamped into the pixel's
// bh x bw block, the same as convolving edge-padded independent blocks.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace igemm {

constexpr int kMaxTaps = 49;
constexpr int kThreads = 256;  // 8 warps
constexpr int kSmemMax = 227 * 1024;
constexpr int kAChunkBytes = 16384;  // the most bytes of one A chunk (rows x KC)
constexpr int kStages = 3;           // A chunks in shared memory: 2 in flight
constexpr int kPlanInts = 12;        // the launch plan a kernel records (launch_persistent)

// Which tiles may read the A operand from a halo tile: a kernel's policy,
// the constant kHalo of its Params, which plan_smem and conv_tiles both
// read, so that the plan and the loop agree. kHaloBatched: time-batched
// tiles (TB > 1) where C % 32 == 0; kHaloAny: any tile where C % 32 == 0
// or C == 16.
constexpr int kHaloBatched = 1, kHaloAny = 2;

// Division by a divisor fixed at launch, for dividends in [0, 2^31): a
// multiply-high and a shift in place of the integer division routine (the
// round-up multiplier: exact in that range for any divisor >= 1).
struct FastDiv {
  int d;
  uint32_t mul;
  int shift;
  FastDiv() = default;
  explicit FastDiv(int divisor) : d(divisor), mul(0), shift(0) {
    if (d > 1) {
      int l = 0;  // ceil(log2(d))
      while ((1u << l) < (uint32_t)d) ++l;
      mul = (uint32_t)(((1ull << (31 + l)) + (uint32_t)d - 1) / (uint32_t)d);
      shift = l - 1;
    }
  }
  __device__ __forceinline__ int div(int n) const {
    return d == 1 ? n : (int)(__umulhi((uint32_t)n, mul) >> shift);
  }
};

// The conv's geometry and its shared-memory plan (plan_smem).
struct Conv {
  const uint8_t* x;      // (t_in, N, H, W, C) uint8
  const uint8_t* w;      // predecoded weights (L, C/4, Kp, 4) int8, or null
  const uint8_t* maskp;  // packed weights (KB, kh*kw, C/8, KBLK), or null
  const int8_t* vals;    // (KB, VPAD)
  long long npix;        // N*H*W: the pixels of one step
  int h, w_, c, kout, kp;
  int kw, pad, bh, bw;
  int t_in;     // steps (time steps, or the gated kernel's images)
  int n_live;   // the live taps the launcher was given (or all kh*kw)
  int taps[kMaxTaps];
  int kblk, vpad, taps_total;
  // the plan
  int kreal, kpad;   // n_live x C, and rounded up to 32
  int kc, nch;       // A chunk width (bytes of K-dim) and chunks per pass
  int g;             // gather width: 16, 8 or 4 bytes
  int resident;      // weights resident (else streamed per chunk, predecoded)
  int kseg;          // K-dim bytes of packed weights decoded at once
  int w_stride;      // bytes per channel row of the weight buffer
  int a_stride;      // bytes per A row (im2col) or halo pixel
  int a_buf;         // bytes of one A buffer
  long long ptiles;  // pixel tiles
  int halo, th, tw, hwid, halo_px, cc, tyb, txb;
  int off_a, off_stage, off_extra, off_taps, off_units, off_rowinfo, off_rowpix, off_rows,
      off_partial;
  // the tile walk's divisors (set by launch_persistent): W, H, bh, bw; in
  // halo mode tw, txb, sub-tiles per block, blocks per image, blocks per
  // block row, hwid, 16-byte units per halo pixel
  FastDiv fd_w, fd_h, fd_bh, fd_bw, fd_tw, fd_txb, fd_blk, fd_img, fd_nbx, fd_hwid, fd_px;
};

// What a block runs with: its live taps and the K-dim segment resident in
// shared memory (the whole K-dim but for the packed segments).
struct Geo {
  int n_live;  // live taps (tdh/tdw in shared memory)
  int kreal;   // n_live x C
  int kbase;   // the segment's first K-dim byte
  int klen;    // its length, a multiple of 32
  int nch;     // items per pass
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
// pixels x 8*NI channels, for TB steps at once. The A tile has TB x BP
// rows, (step, pixel); a warp's TB x NI accumulators share its B fragments
// and are independent.
template <int TB_, int NI_, int WM, int WN>
struct Tile {
  static_assert(WM * WN * 32 == kThreads, "8 warps");
  static_assert(NI_ % 2 == 0, "B fragments load two n8 tiles at a time");
  static_assert(TB_ == 1 || TB_ == 4, "one step, or four, per pass");
  static constexpr int TB = TB_, NI = NI_;
  static constexpr int BP = WM * 16;      // pixels
  static constexpr int BN = WN * 8 * NI;  // output channels
  static constexpr int ROWS = TB * BP;    // A rows
  static constexpr int SF = BN + 8;       // staging row of 32-bit values
  static constexpr int SB = BN + 16;      // staging row of bytes
  // accumulator fragment element (ni, e) of this thread <-> tile pixel row
  // and channel column
  __device__ static int row(int e) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    return (warp / WN) * 16 + (lane >> 2) + (e >> 1) * 8;
  }
  __device__ static int col(int ni, int e) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    return (warp % WN) * 8 * NI + ni * 8 + 2 * (lane & 3) + (e & 1);
  }
};

// One A row's gathers of a chunk (im2col mode): units uu = j0, j0 + tpr,
// ... of the chunk, G bytes each, from the live tap and channel ``units``
// names; the block-clamped source pixel is recomputed only when the tap
// changes. Rows past the image or the last step, and the K-dim padding,
// are zero-filled.
template <int G>
__device__ __forceinline__ void gather_row(const Conv& p, uint8_t* arow, const int* units,
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
        const int hh = min(max(info.y + tdh[l], 0), p.bh - 1);  // clamped to the block
        const int ww = min(max(info.z + tdw[l], 0), p.bw - 1);
        base = p.x + ((long long)t * p.npix + info.x + hh * p.w_ + ww) * p.c;
      }
      src = base + (unit & 0xffff);
      bytes = G;
    }
    cp_async<G>(arow + uu * G, src, bytes);
  }
}

// The tap tables of a block's live taps (tdh/tdw filled by the caller):
// each tap's byte offset in the halo, and, in im2col mode, every gather
// unit of the segment (its live tap and first channel; -1: padding).
__device__ __forceinline__ void fill_tables(const Conv& p, const Geo& gm, bool halo,
                                            const int* tdh, const int* tdw, int* toff,
                                            int* units) {
  for (int l = threadIdx.x; l < gm.n_live; l += kThreads)
    toff[l] = (tdh[l] * p.hwid + tdw[l]) * p.a_stride;
  if (!halo)
    for (int u = threadIdx.x; u < gm.klen / p.g; u += kThreads) {
      const int kq = gm.kbase + u * p.g, l = kq / p.c;
      units[u] = kq < gm.kreal ? (l << 16) | (kq - l * p.c) : -1;
    }
}

// One live (tap, channel) row's weights in the span [ks, ke) of K-block
// ``kb``, W mask bytes a load: idx enters as the row's first value index in
// the K-block, the bits left of the span are counted, then each set bit
// takes the next value (clipped to VPAD - 1, like the TPU gather). kAll:
// a clear bit writes its zero too (else the caller zeroed the buffer).
template <int W, bool kAll = false>
__device__ __forceinline__ void decode_row(const Conv& p, const uint8_t* row, int sh, int idx,
                                           int ks, int ke, const int8_t* vk, uint8_t* dst,
                                           int n_off) {
  for (int q = 0; q < ks; q += W) {
    if constexpr (W == 8) {
      const uint2 wv = __ldg(reinterpret_cast<const uint2*>(row + q));
      idx += __popc((wv.x >> sh) & 0x01010101u) + __popc((wv.y >> sh) & 0x01010101u);
    } else {
      idx += __popc((__ldg(reinterpret_cast<const uint32_t*>(row + q)) >> sh) & 0x01010101u);
    }
  }
  for (int q = ks; q < ke; q += W) {
    uint32_t words[W / 4];
    if constexpr (W == 8) {
      const uint2 wv = __ldg(reinterpret_cast<const uint2*>(row + q));
      words[0] = wv.x;
      words[1] = wv.y;
    } else {
      words[0] = __ldg(reinterpret_cast<const uint32_t*>(row + q));
    }
#pragma unroll
    for (int j = 0; j < W; ++j) {
      if ((words[j / 4] >> (8 * (j & 3) + sh)) & 1u) {
        dst[(n_off + q + j) * p.w_stride] = (uint8_t)__ldg(vk + min(idx, p.vpad - 1));
        ++idx;
      } else if (kAll) {
        dst[(n_off + q + j) * p.w_stride] = 0;
      }
    }
  }
}

// Decode the block's channel tile [n0, n0 + BN) of the packed weights, K-dim
// segment [kbase, kbase + klen), into wsm: byte (n, k - kbase) is the weight
// of output channel n0 + n at K-dim position k = l*C + c (live tap l,
// channel c); everything else is zero. Per K-block that the tile touches,
// the rank walk of common.cuh gives every (tap, channel) row's first value
// index; then one thread per live (tap, channel) row of the segment counts
// the row's set bits left of the tile and walks the tile's channels.
template <int BN>
__device__ void decode_weights(const Conv& p, const Geo& gm, uint8_t* wsm, int n0,
                               const int* tdh, const int* tdw, int* rows, int* partial) {
  const int c8 = p.c / 8;
  for (int e = threadIdx.x; e < BN * p.w_stride / 16; e += kThreads)  // w_stride % 16 == 0
    reinterpret_cast<uint4*>(wsm)[e] = make_uint4(0u, 0u, 0u, 0u);
  const int n_end = min(n0 + BN, p.kp);
  const int r_end = min(gm.kreal, gm.kbase + gm.klen);
  for (int kb = n0 / p.kblk; kb * p.kblk < n_end; ++kb) {
    const uint8_t* mk = p.maskp + (long long)kb * p.taps_total * c8 * p.kblk;
    __syncthreads();  // the previous K-block's ranks are no longer read
    kblock_row_ranks<kThreads>(mk, p.taps_total, p.c, p.kblk, rows, partial);
    const int ks = max(n0, kb * p.kblk) - kb * p.kblk;  // the tile's span in this K-block
    const int ke = min(n_end, (kb + 1) * p.kblk) - kb * p.kblk;
    const int8_t* vk = p.vals + (long long)kb * p.vpad;
    for (int r = gm.kbase + threadIdx.x; r < r_end; r += kThreads) {
      const int l = r / p.c, ch = r - l * p.c;
      const int tap = (tdh[l] + p.pad) * p.kw + tdw[l] + p.pad;
      const uint8_t* row = mk + ((long long)tap * c8 + ch / 8) * p.kblk;
      const int idx = rows[tap * p.c + ch];
      uint8_t* dst = wsm + (r - gm.kbase);
      const int n_off = kb * p.kblk - n0;
      if (p.kblk % 8 == 0)
        decode_row<8>(p, row, ch & 7, idx, ks, ke, vk, dst, n_off);
      else
        decode_row<4>(p, row, ch & 7, idx, ks, ke, vk, dst, n_off);
    }
  }
  __syncthreads();
}

// Decode K-dim chunk [k0, k0 + klen) of the block's channel tile [n0, n0 +
// BN) of the packed weights into a streamed B buffer: byte (n, k - k0) of
// rows of w_stride bytes, every byte written (the weight, or zero). One
// thread per K-dim row. A chunk starts and ends anywhere in a K-block's
// rows, so each row's first value index comes from ``rank8``, the byte-row
// ranks of every K-block the tile touches (kblock_byte_row_ranks, K-block
// n0/KBLK first), plus the set bits of the row's byte row in the bits
// below its own, over the whole K-block (those rows precede it in the
// values' (tap, c, k) order). Plain stores: the barrier before the buffer
// is read makes them visible. Only the loop instantiated for it
// (conv_tiles' kDecodeChunks) contains it.
template <int BN>
__device__ __forceinline__ void decode_chunk(const Conv& p, const Geo& gm, uint8_t* B, int n0,
                                             int k0, int klen, const int* tdh, const int* tdw,
                                             const int* rank8) {
  const int c8 = p.c / 8, per_kb = p.taps_total * c8;
  const int n_end = min(n0 + BN, p.kp), kb0 = n0 / p.kblk;
  for (int r = k0 + threadIdx.x; r < k0 + klen; r += kThreads) {
    uint8_t* dst = B + (r - k0);
    const int n_dec = r < gm.kreal ? n_end - n0 : 0;  // channels decoded; the rest zero
    for (int n = n_dec; n < BN; ++n) dst[n * p.w_stride] = 0;
    if (n_dec == 0) continue;
    const int l = r / p.c, ch = r - l * p.c, sh = ch & 7;
    const int tap = (tdh[l] + p.pad) * p.kw + tdw[l] + p.pad;
    const int u = tap * c8 + ch / 8;  // the row's byte row
    const uint32_t below = 0x01010101u * ((1u << sh) - 1u);  // bits c%8' < c%8 of each byte
    for (int kb = kb0; kb * p.kblk < n_end; ++kb) {
      const uint8_t* row = p.maskp + ((long long)kb * per_kb + u) * p.kblk;
      int idx = rank8[(kb - kb0) * per_kb + u];
      if (below != 0u)
        for (int q = 0; q < p.kblk; q += 4)
          idx += __popc(__ldg(reinterpret_cast<const uint32_t*>(row + q)) & below);
      const int ks = max(n0, kb * p.kblk) - kb * p.kblk;  // the tile's span in this K-block
      const int ke = min(n_end, (kb + 1) * p.kblk) - kb * p.kblk;
      const int8_t* vk = p.vals + (long long)kb * p.vpad;
      const int n_off = kb * p.kblk - n0;
      if (p.kblk % 8 == 0)
        decode_row<8, true>(p, row, sh, idx, ks, ke, vk, dst, n_off);
      else
        decode_row<4, true>(p, row, sh, idx, ks, ke, vk, dst, n_off);
    }
  }
}

// The block's main loop over its items: chunk ch (of the K-dim, or of the
// channels in halo mode) of pass ps (steps ps*TB ...) of the block's pixel
// tile tl (its blockIdx.x + tl * gridDim.x-th), in (tl, ps, ch) order, the
// A operand of item it + kStages - 1 issued while item it is multiplied.
// When a pass's convs are complete, epi(acc, ps, ntb, rp) takes the TB
// accumulator sets (ntb of them hold steps) and rp, each tile row's pixel
// (-1: none). The caller has filled the tap tables and the weights and
// synchronised. P is the kernel's Params: its kHalo policy (kHaloAny:
// halo mode at one step per pass and C == 16 too) is the one plan_smem
// planned with. kDecodeChunks: the weights are packed and streamed (the
// plan's resident == 0), and the byte-row ranks are at off_rows.
template <class T, bool kDecodeChunks = false, class P, class Epi>
__device__ __forceinline__ void conv_tiles(const P& p, const Geo& gm, uint8_t* smem, int n0,
                                           Epi&& epi) {
  constexpr bool kHalo1 = P::kHalo == kHaloAny;
  constexpr int TB = T::TB, NI = T::NI, BP = T::BP, BN = T::BN, ROWS = T::ROWS;
  uint8_t* wsm = smem;  // resident weights, or kStages streamed B chunks
  const int* tdh = reinterpret_cast<const int*>(smem + p.off_taps);
  const int* tdw = tdh + kMaxTaps;
  const int* toff = tdw + kMaxTaps;
  const int* units = reinterpret_cast<const int*>(smem + p.off_units);
  int4* rowinfo = reinterpret_cast<int4*>(smem + p.off_rowinfo);  // [BP]
  int* rowpix = reinterpret_cast<int*>(smem + p.off_rowpix);      // [kStages][BP]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp / (BN / (8 * NI))) * 16, wn = (warp % (BN / (8 * NI))) * 8 * NI;
  const bool halo = (TB > 1 || kHalo1) && p.halo;
  const bool pair = kHalo1 && halo && p.cc == 16;  // two taps per k-step

  const long long my_tiles =
      blockIdx.x < p.ptiles ? (p.ptiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int passes = (p.t_in + TB - 1) / TB;
  const long long n_items = my_tiles * passes * gm.nch;
  struct Item {
    int tl, ps, ch;
  };
  auto advance = [&](Item& c) {
    if (++c.ch == gm.nch) {
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
  auto origin = [&](int gt) {  // gt < ptiles <= npix < 2^31
    const int blk = p.fd_blk.div(gt);
    const int st = gt - blk * p.fd_blk.d, sy = p.fd_txb.div(st), sx = st - sy * p.txb;
    const int n = p.fd_img.div(blk), rb = blk - n * p.fd_img.d;
    const int by = p.fd_nbx.div(rb), bx = rb - by * p.fd_nbx.d;
    const int by0 = by * p.bh, bx0 = bx * p.bw;
    return Origin{n, by0 + sy * p.th, bx0 + sx * p.tw, by0, bx0};
  };
  Origin o_next{0, 0, 0, 0, 0};  // halo mode: the origin of the tile being issued

  // the loads of item c -> A buffer ``buf`` (and, streamed, B)
  auto issue = [&](const Item& c, int buf) {
    const long long gt = blockIdx.x + (long long)c.tl * gridDim.x;
    uint8_t* a = smem + p.off_a + buf * p.a_buf;
    if (c.ps == 0 && c.ch == 0) {  // a new pixel tile: each row's output pixel (-1: none)
      int* rp = rowpix + (c.tl % kStages) * BP;
      if (halo) {  // read by the tile's epilogue only, after later barriers
        o_next = origin((int)gt);
        const Origin& o = o_next;
        for (int r = tid; r < BP; r += kThreads) {
          const int py = p.fd_tw.div(r), px = r - py * p.tw;
          const bool in = o.y0 + py < o.by0 + p.bh && o.x0 + px < o.bx0 + p.bw;
          rp[r] = in ? ((o.n * p.h + o.y0 + py) * p.w_ + o.x0 + px) : -1;
        }
      } else {  // and each row's block corner (its pixel index) and place in the block
        for (int r = tid; r < BP; r += kThreads) {
          int4 info = make_int4(-1, 0, 0, 0);
          const long long pix = gt * BP + r;
          if (pix < p.npix) {
            const int pi = (int)pix;  // npix < 2^31 (checked at launch)
            const int q = p.fd_w.div(pi), wi = pi - q * p.w_;
            const int ni = p.fd_h.div(q), hi = q - ni * p.h;
            const int hlo = p.fd_bh.div(hi) * p.bh, wlo = p.fd_bw.div(wi) * p.bw;
            info = make_int4((ni * p.h + hlo) * p.w_ + wlo, hi - hlo, wi - wlo, 0);
          }
          rowinfo[r] = info;
          rp[r] = pix < p.npix ? (int)pix : -1;
        }
        __syncthreads();  // rowinfo is read by the gathers below
      }
    }
    if (halo) {  // TB steps x the halo's pixels x cc channels, 16 bytes a copy
      const Origin& o = o_next;
      const int per_px = p.cc / 16;
      for (int rem = tid; rem < p.halo_px * per_px && gm.n_live > 0; rem += kThreads) {
        const int hp = p.fd_px.div(rem), u = rem - hp * per_px;
        const int hy = p.fd_hwid.div(hp), hx = hp - hy * p.hwid;
        const int y = min(max(o.y0 - p.pad + hy, o.by0), o.by0 + p.bh - 1);
        const int x = min(max(o.x0 - p.pad + hx, o.bx0), o.bx0 + p.bw - 1);
        const uint8_t* src0 = p.x + (((long long)o.n * p.h + y) * p.w_ + x) * p.c + c.ch * p.cc +
                              u * 16;
        uint8_t* dst = a + hp * p.a_stride + u * 16;
#pragma unroll
        for (int tb = 0; tb < TB; ++tb) {
          const int t = c.ps * TB + tb;
          const bool in = t < p.t_in;
          cp_async<16>(dst + tb * p.halo_px * p.a_stride,
                       in ? src0 + (long long)t * p.npix * p.c : p.x, in ? 16 : 0);
        }
      }
    } else {
      const int k0 = c.ch * p.kc, klen = min(p.kc, gm.klen - k0);
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
      if (kDecodeChunks && !p.resident) {  // packed: decode the chunk's weights into B
        if constexpr (kDecodeChunks)
          decode_chunk<BN>(p, gm, wsm + buf * BN * p.w_stride, n0, k0, klen, tdh, tdw,
                           reinterpret_cast<const int*>(smem + p.off_rows));
      } else if (!p.resident) {  // the chunk's weights, channel rows of klen bytes
        uint8_t* B = wsm + buf * BN * p.w_stride;
        const int c4 = p.c / 4;
        const int wpr = klen / 4;
        for (int e = tid; e < BN * wpr; e += kThreads) {
          const int n = e % BN, kq = k0 + (e / BN) * 4;
          const uint8_t* src = p.w;
          int bytes = 0;
          if (n0 + n < p.kout && kq < gm.kreal) {
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

  int acc[TB][NI][4];  // int32 sums per step

  // this lane's A row (a tile pixel): its byte offset in an A buffer, and
  // the offset from one step's rows to the next
  const int arow = wm + (lane & 15);
  const int a_lane = (halo ? ((arow / p.tw + p.pad) * p.hwid + arow % p.tw + p.pad) * p.a_stride
                          : arow * p.a_stride) + (pair ? 0 : (lane >> 4) * 16);
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
      // k-steps: the chunk's 32-byte columns; in the halo each live tap's
      // cc channels 32 at a time, or (pair) two live taps' 16 channels
      const int nks = pair ? (gm.n_live + 1) / 2
                           : halo ? gm.n_live * (p.cc / 32) : min(p.kc, gm.klen - k0) / 32;
      // the next k-step to load: its A offset (in the halo: the tap's shift
      // plus the channels) and its weights' K-dim offset, kept incrementally
      auto pair_ao = [&](int l) { return toff[l < gm.n_live ? l : 0]; };
      int ld_l = 0, ld_cj = 0;
      int ld_ao = halo && nks > 0 ? (pair ? pair_ao(lane >> 4) : toff[0]) : 0;
      int ld_bo = halo ? ch * p.cc : k0;
      auto load = [&](uint32_t (&a)[TB][4], uint32_t (&b)[NI / 2][4]) {
#pragma unroll
        for (int tb = 0; tb < TB; ++tb)
          if (tb < ntb) ldsm_x4(a[tb], a_ptr + tb * a_step + ld_ao);
#pragma unroll
        for (int nj = 0; nj < NI / 2; ++nj) ldsm_x4(b[nj], b_ptr + nj * 16 * p.w_stride + ld_bo);
        ld_bo += 32;
        if (pair) {  // lanes 16-31 read the second tap's rows
          ld_l += 2;
          ld_ao = pair_ao(ld_l + (lane >> 4));
        } else {
          ld_ao += 32;
          if (halo && (ld_cj += 32) == p.cc) {  // the next live tap
            ld_cj = 0;
            if (++ld_l < gm.n_live) {
              ld_ao = toff[ld_l];
              ld_bo = ld_l * p.c + ch * p.cc;
            }
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

    if (ch == gm.nch - 1) epi(acc, ps, ntb, rp);  // the pass's convs are complete
    __syncthreads();  // this item's buffer is free for item it + kStages
  }
}

__host__ __device__ inline int round_up(int a, int b) { return (a + b - 1) / b * b; }

// The shared-memory plan for a tile of TB x bp A rows (im2col) and bn
// channels, with ``extra`` bytes of the caller's at off_extra; returns the
// bytes, or -1 when no plan fits. Halo mode where P::kHalo admits the
// tile (kHaloBatched, kHaloAny above), the kernel is wider than 1x1 (a
// 1x1's im2col rows are contiguous already) and the weights are resident:
// the pixel tile is a th x tw rectangle inside one block-conv block (the
// shape that wastes the fewest rows at the block's edges), and a channel
// chunk of cc channels (the widest that fits) of its halo is one item.
// Packed weights that do not fit whole are streamed, decoded a K-chunk at
// a time into the B ring (the block keeps byte-row ranks of the K-blocks
// its tile touches at off_rows), or (segments) decoded kseg K-dim bytes at
// a time.
template <class P>
inline int plan_smem(P& p, int tb, int bp, int bn, bool packed, int extra, bool segments) {
  const int rows = tb * bp;
  p.kreal = p.n_live * p.c;
  p.kpad = round_up(p.kreal > 0 ? p.kreal : 32, 32);
  p.g = p.c % 16 == 0 ? 16 : p.c % 8 == 0 ? 8 : 4;
  const int stage = std::max(bp * (bn + 8) * 4, bp * (bn + 16));
  extra = round_up(extra, 16);
  const int taps = round_up(3 * kMaxTaps * 4, 16);
  const int units = round_up(p.kpad / p.g * 4, 16);
  const int rowinfo = bp * 16;
  const int rowpix = kStages * bp * 4;
  int ranks = packed ? round_up(p.taps_total * p.c * 4, 16) : 0;  // kblock_row_ranks' table
  const int partial = packed ? kThreads * 4 : 0;
  int fixed = stage + extra + taps + units + rowinfo + rowpix + ranks + partial;
  const int wres = bn * (p.kpad + 16);
  const bool pair = P::kHalo == kHaloAny && p.c == 16;
  p.halo = 0;
  p.kseg = p.kpad;
  if ((P::kHalo == kHaloAny || tb > 1) &&
      (p.c % 32 == 0 || pair) && p.n_live > 0 && p.pad > 0) {
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
    for (int cc = p.c; cc >= (pair ? 16 : 32); cc -= 32) {
      if (p.c % cc != 0) continue;
      // an odd multiple of 16: conflict-free ldmatrix rows
      const int stride = (cc / 16) % 2 == 0 ? cc + 16 : cc + 32;
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
    if (!p.resident && packed && segments) {
      // segments: a 128-byte (or narrower) A chunk, the weights' K-dim
      // segment as wide as the bytes left allow
      p.kc = std::max(32, std::min(128, kAChunkBytes / rows) / 32 * 32);
      const int left = kSmemMax - fixed - kStages * rows * (p.kc + 16);
      p.kseg = (left / bn - 16) / 32 * 32;
      if (p.kseg < 32) return -1;
      p.resident = 1;
      p.nch = (p.kseg + p.kc - 1) / p.kc;
    } else {
      if (!p.resident && packed) {  // streamed decode: byte-row ranks per touched K-block
        int kbs = 1;
        for (int c0 = 0; c0 < p.kp; c0 += bn)
          kbs = std::max(kbs, (std::min(c0 + bn, p.kp) - 1) / p.kblk - c0 / p.kblk + 1);
        const int ranks8 = round_up(kbs * p.taps_total * (p.c / 8) * 4, 16);
        fixed += ranks8 - ranks;
        ranks = ranks8;
      }
      // the A chunk: as wide as the bytes left allow, up to kAChunkBytes a stage
      const int per_col = p.resident ? kStages * rows : kStages * (rows + bn);
      const int left = kSmemMax - fixed - (p.resident ? wres : 0);
      const int kc_max = std::min(kAChunkBytes / rows, left / per_col - 16) / 32 * 32;
      if (kc_max < 32) return -1;
      p.nch = (p.kpad + kc_max - 1) / kc_max;
      p.kc = round_up((p.kpad + p.nch - 1) / p.nch, 32);  // balanced chunks
    }
    p.a_stride = p.kc + 16;  // an odd multiple of 16: conflict-free ldmatrix rows
    p.a_buf = rows * p.a_stride;
    p.th = 1;
    p.tw = bp;
    p.hwid = bp;
  }
  p.w_stride = p.resident ? p.kseg + 16 : p.kc + 16;
  const int wbytes = p.resident ? bn * p.w_stride : kStages * bn * p.w_stride;
  p.off_a = wbytes;
  p.off_stage = p.off_a + kStages * p.a_buf;
  p.off_extra = p.off_stage + stage;
  p.off_taps = p.off_extra + extra;
  p.off_units = p.off_taps + taps;
  p.off_rowinfo = p.off_units + units;
  p.off_rowpix = p.off_rowinfo + rowinfo;
  p.off_rows = p.off_rowpix + rowpix;
  p.off_partial = p.off_rows + ranks;
  return p.off_partial + partial;
}

// Launch ``kernel`` on tile T with the plan of plan_smem (``smem`` bytes):
// persistent blocks, one wave of the card, each walking its pixel tiles
// with the weights it loaded once. Records in ``plan``: dynamic shared
// memory, steps per pass, pixels and channels per tile, halo mode, the
// chunk (cc in halo mode, else kc bytes), chunks per pass, grid x and y,
// blocks per SM, the K-dim segment of packed weights.
template <class T, class P>
int launch_persistent(void (*kernel)(P), P& p, int smem, cudaStream_t s, int* plan) {
  if (smem < 0) return (int)cudaErrorInvalidValue;
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
  p.fd_w = FastDiv(p.w_);
  p.fd_h = FastDiv(p.h);
  p.fd_bh = FastDiv(p.bh);
  p.fd_bw = FastDiv(p.bw);
  p.fd_tw = FastDiv(p.tw);
  p.fd_txb = FastDiv(std::max(p.txb, 1));
  p.fd_blk = FastDiv(std::max(p.tyb * p.txb, 1));
  p.fd_img = FastDiv((p.h / p.bh) * (p.w_ / p.bw));
  p.fd_nbx = FastDiv(p.w_ / p.bw);
  p.fd_hwid = FastDiv(p.hwid);
  p.fd_px = FastDiv(p.halo ? p.cc / 16 : 1);
  p.ptiles = p.halo ? p.npix / ((long long)p.bh * p.bw) * p.tyb * p.txb
                    : (p.npix + T::BP - 1) / T::BP;
  const long long ctiles = (p.kout + T::BN - 1) / T::BN;
  long long bx = ((long long)sms * occ + ctiles - 1) / ctiles;
  if (bx > p.ptiles) bx = p.ptiles;
  if (bx < 1) bx = 1;
  if (ctiles > 65535 || bx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<dim3((unsigned)bx, (unsigned)ctiles), kThreads, smem, s>>>(p);
  const int out[kPlanInts] = {smem, T::TB, T::BP, T::BN, p.halo, p.halo ? p.cc : p.kc, p.nch,
                              (int)bx, (int)ctiles, occ, p.kseg, p.resident};
  std::copy(out, out + kPlanInts, plan);
  return (int)cudaGetLastError();
}

}  // namespace igemm
