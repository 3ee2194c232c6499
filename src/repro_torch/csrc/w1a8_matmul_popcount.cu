// Binary-domain W1A8 matmul: the exact int32 sum of uint8 codes against
// packed 1-bit weights (what the TPU kernel forms with AND + popcount over
// the codes' 8 bit-planes), then the Div/bias epilogue and, when
// requested, the requant to uint8 codes.
//
// What each entry replaces. The 2-D entries, w1a8_matmul_popcount and its
// decode route w1a8_matmul_popcount_decode (M <= 16), replace the TPU
// kernel
// repro/kernels/w1a8_matmul/kernel.py::w1a8_matmul_popcount_pallas
// (_popcount_matmul_kernel, _xnor_accumulate, _pack_act_bitplane): exact
// int32 sum_k s_k * a_k, converted to f32, then acc * div + bias. The codes
// must already sit on one grid; the wrapper folds a per-channel Mul_prev
// into them and its uniform step into div. The grouped entry
// w1a8_matmul_popcount_grouped runs the same product for a stack of
// experts in one launch; it replaces no Pallas kernel but the reference's
// einsum("etk,ekn->etn") over quantize_act codes and signs (the MoE FFN's
// packed experts, repro/models/moe.py:62-69), each expert's rows from its
// count on written as zeros. Every product is an integer on the int8
// tensor cores (mma.sync m16n8k32, s32 accumulate): |acc| <= 255 * k stays
// far inside int32 and, below 2^24, converts to f32 exactly, so every
// route and every split of K gives the same sum bit for bit.
//
// What bounds it on the H100. At the detector's conv9 (M = 4 * 100,
// K = 128, N = 64) the call moves about 80 KB: its time is latency (the
// launch, the round trip of its loads, the chain of dependent mma.sync).
// At the LM decode shapes (M = 4 to 16 tokens, K and N in the thousands)
// the sign words are almost every byte: (K / 32) * N * 4 bytes, 7.0 MB at
// chatglm3-6b's (4096, 13696), a bound of some 2.1 us at 3.35 TB/s; the
// int8 operations (2 * M * K * N) are a hundredth of that. A call has to
// stream the words once, with enough of them in flight to cover the
// memory's latency.
//
// Design, rows above the threshold (the PR-15 tile, kernels/w1a8_matmul/
// geometry.py::matmul_launch): per span of 128 codes of K each lane loads
// its 16 codes of each of its rows and one sign word per column
// (w1a8::load_span); the code words are the A registers of its mma.sync
// (w1a8::matmul_imma_tile); the two warps of an item add their int32 sums
// in a fixed order (w1a8::reduce_split), and each stores its half of the
// outputs (w1a8::store_tile).
//
// Design, the decode tile (M <= 16 over K >= 768,
// geometry.py::decode_launch). The 16-row side of the mma is 16 output
// columns and its 8-column side 8 tokens (mma.sync m16n8k32 u8 * u8), so
// M <= 8 pads to 8 and not to 16: the A bytes are the sign bits, each
// moved to bit 7 by one shift and kept by one AND (128 or 0), the B
// bytes the codes, which each lane transposes byte-wise (8 PRMT) so that
// mma p takes bits p + 8i and p + 4 + 8i of a word; a warp's sum of 128 *
// bit * code becomes sum s * code = acc / 64 - sum code. Lane 4g + t
// takes sign word 4s + t of span s for its 2 * NT adjacent columns (one
// or two 16-byte copies, so a warp reads 4 rows of 64 contiguous words a
// span) and the 32 codes of that word of its token(s), through its own
// ring of kStages spans in shared memory (cp.async; kStages - 1 spans in
// flight while it computes one, no barrier: a lane reads only what it
// copied). K is split three ways, all exact: the spans of a warp, kw
// warps a block and cs blocks a thread block cluster (geometry.py picks
// the split that keeps every block resident in one wave). A block's kw'
// = 0 warps add the other warps' fragments from shared memory, rank 0
// the other blocks' from theirs (distributed shared memory), each in a
// fixed order, and store the outputs from their registers through the
// epilogue, Div and bias copied to shared memory with the first span. No
// global scratch, no counter, no atomic: a call replays under a CUDA
// graph and gives the same bits every time.
//
// The grouped entry is persistent: a few blocks an SM walk the work items
// of the experts that hold rows (expert x row block x column tile), which
// every block forms on the device from `counts` (a prefix over the
// experts in shared memory, an expert found by binary search); the rows
// from each count on are written as zeros with 16-byte stores. An empty
// expert takes no work item and reads no word. At cap <= 16 an item is
// the decode tile over the expert's held rows, above it the PR-15 tile.
#include <cooperative_groups.h>

#include "w1a8_common.cuh"

namespace {

using w1a8::ceil_div;
using w1a8::kLaneCodes;
using w1a8::kMatmulThreads;
using w1a8::kSplit;
using w1a8::words_of;

// One block per SM at the least: without it ptxas held some
// instantiations to 80 registers and spilled.
template <int WM, int WN>
__global__ void __launch_bounds__(kMatmulThreads, 1)
matmul_popcount_kernel(const uint8_t* __restrict__ a,
                       const uint32_t* __restrict__ w,
                       const float* __restrict__ div,
                       const float* __restrict__ bias,
                       void* __restrict__ out, int m, int k, int n, int bn,
                       float out_step, int quant) {
  __shared__ int red[kMatmulThreads * WM * WN * 4];
  const int lane = threadIdx.x & 31;
  const int q = (threadIdx.x / 32) % kSplit;
  const int row0 = blockIdx.x * 16 * WM;
  const int m_blk = min(16 * WM, m - row0);
  const int col = blockIdx.y * bn + (threadIdx.x / 32 / kSplit) * 8 * WN;
  const bool vec = k % 16 == 0 && (reinterpret_cast<uintptr_t>(a) & 15) == 0;
  float dv[WN][2], bs[WN][2];
  w1a8::lane_constants<WN>(div, bias, col, n, dv, bs);
  const uint8_t* rows[WM][2];
  w1a8::row_pointers<WM>(a, k, row0, m_blk, rows);
  int acc[WM][WN][4] = {};
  for (int s = 0; s * w1a8::kSpan < k; ++s) {
    uint32_t code[WM][2][kLaneCodes / 4], word[WN];
    w1a8::load_span<WM, WN>(rows, w, k, n, s, q, col + (lane >> 2), vec, code,
                            word);
    w1a8::matmul_imma_tile<WM, WN>(code, word, q, acc);
  }
  w1a8::reduce_split(acc, red);
  w1a8::store_tile<WM, WN, kSplit>(acc, dv, bs, out, row0, 0, m_blk, n, col,
                                   out_step, quant, q);
}

// ---------------------------------------------------------------------------
// Thread block clusters. The cluster primitives sit in small functions so
// that a host emulation can stand in for them.
// ---------------------------------------------------------------------------

// This block's rank in its cluster.
__device__ __forceinline__ int cluster_rank() {
  return static_cast<int>(cooperative_groups::this_cluster().block_rank());
}

// A barrier over every thread of the cluster: what a block wrote to its
// shared memory before it is visible to the whole cluster after it.
__device__ __forceinline__ void cluster_sync() {
  cooperative_groups::this_cluster().sync();
}

// `p`, an address in this block's shared memory, in block `rank`'s.
__device__ __forceinline__ const int* cluster_peer(int* p, int rank) {
  return cooperative_groups::this_cluster().map_shared_rank(p, rank);
}

// ---------------------------------------------------------------------------
// The decode tile.
// ---------------------------------------------------------------------------

constexpr int kDecodeThreads = 256;  // the kernel's __launch_bounds__
constexpr int kMaxCluster = 8;       // the portable cluster size
constexpr int kMaxExperts = 4096;    // a grouped call's prefix in smem
constexpr int kMaxK = 65536;         // 128 * 255 * k stays inside int32
constexpr uint32_t kBit7 = 0x80808080u;  // bit 7 of each byte
constexpr int kStages = 4;           // ring stages a lane keeps: kStages - 1
                                     // spans in flight while it computes one

// y[p] = byte p of x0, x1, x2, x3, in that order: a 4 x 4 byte transpose.
__device__ __forceinline__ void transpose_bytes(uint32_t x0, uint32_t x1,
                                                uint32_t x2, uint32_t x3,
                                                uint32_t (&y)[4]) {
  const uint32_t t0 = __byte_perm(x0, x1, 0x5140);
  const uint32_t t1 = __byte_perm(x0, x1, 0x7362);
  const uint32_t t2 = __byte_perm(x2, x3, 0x5140);
  const uint32_t t3 = __byte_perm(x2, x3, 0x7362);
  y[0] = __byte_perm(t0, t2, 0x5410);
  y[1] = __byte_perm(t0, t2, 0x7632);
  y[2] = __byte_perm(t1, t3, 0x5410);
  y[3] = __byte_perm(t1, t3, 0x7632);
}

// Ring slots a lane fills for one span: the sign words 4s + t of its 2 *
// NT columns (16 bytes a slot; one 8-byte copy for NT = 1), then the 32
// codes of that word for each of its MT tokens (two slots each). Slot c of
// a stage is 32 lanes' 16 bytes side by side, so a warp's reads of one slot
// fall on distinct banks.
template <int NT>
__host__ __device__ constexpr int sign_chunks() {
  return NT == 1 ? 1 : NT / 2;
}

template <int NT, int MT>
__host__ __device__ constexpr int span_chunks() {
  return sign_chunks<NT>() + 2 * MT;
}

// Issues the copies of span s into stage `st` (this lane's slot 0 of the
// stage) and closes their group: cp.async where the operands allow it
// (fast_w: the lane's words 16-byte aligned and inside n; fast[mt]: the
// token's codes 16-byte aligned, k % 16 == 0), else loads and stores to
// shared memory; a word past the last, a code past k and a token past
// `tokens` (live[mt] false) stage 0. A span past the last closes an empty
// group.
template <int NT, int MT>
__device__ __forceinline__ void stage_span(
    uint4* st, int s, int spans, const uint32_t* __restrict__ w, int words,
    int n, int c, bool fast_w, const uint8_t* const (&rows)[MT],
    const bool (&live)[MT], const bool (&fast)[MT], int k) {
  constexpr int kSign = sign_chunks<NT>();
  const int j = 4 * s + (threadIdx.x & 3);
  if (s < spans) {
    const uint32_t* p = w + static_cast<size_t>(j) * n + c;
    if (fast_w && j < words) {
#pragma unroll
      for (int h = 0; h < kSign; ++h) {
        w1a8::cp_async_lane<NT == 1 ? 8 : 16>(st + 32 * h, p + 4 * h,
                                              NT == 1 ? 8 : 16);
      }
    } else {
      uint32_t v[4 * kSign] = {};
#pragma unroll
      for (int i = 0; i < 2 * NT; ++i) {
        if (j < words && c + i < n) v[i] = __ldg(p + i);
      }
#pragma unroll
      for (int h = 0; h < kSign; ++h) {
        st[32 * h] = make_uint4(v[4 * h], v[4 * h + 1], v[4 * h + 2],
                                v[4 * h + 3]);
      }
    }
    const int valid = k - w1a8::kPack * j;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint4* dst = st + 32 * (kSign + 2 * mt);
      const uint8_t* q = rows[mt] + w1a8::kPack * j;
      if (fast[mt] && valid > 0) {
        // k % 16 == 0: valid is 16 or at least 32
        w1a8::cp_async_lane<16>(dst, q, 16);
        w1a8::cp_async_lane<16>(dst + 32, valid >= 32 ? q + 16 : q,
                                valid >= 32 ? 16 : 0);
      } else {
        uint32_t v[8] = {};
        if (live[mt]) {
#pragma unroll
          for (int b = 0; b < 32; ++b) {
            if (b < valid) {
              v[b / 4] |= static_cast<uint32_t>(__ldg(q + b))
                          << (8 * (b % 4));
            }
          }
        }
        dst[0] = make_uint4(v[0], v[1], v[2], v[3]);
        dst[32] = make_uint4(v[4], v[5], v[6], v[7]);
      }
    }
  }
  w1a8::cp_async_commit();
}

// Adds one sign word a lane of its warp's quad t holds to the warp's sums.
// sw[i] is the word of column 2 * NT * g + i of the warp, code[mt] the
// lane's 32 codes of token 8 * mt + g for the same word. Tile nt's A row g
// is column 2 * NT * g + 2 * nt and row g + 8 the next; mma p takes, in
// each lane's registers, the word's bits p + 8i (A columns 4t + i) and
// p + 4 + 8i (A columns 16 + 4t + i), i < 4, and the codes of the same k
// (B rows 4t + i and 16 + 4t + i), so the four quads' words are one mma's
// K. Each A byte is the bit moved to bit 7 by one left shift and kept by
// one AND (128 or 0), so acc[mt][nt] gathers 128 * sum bit * code (below
// 2^31 for k <= kMaxK) and rowsum[mt] the codes' sum.
template <int NT, int MT>
__device__ __forceinline__ void decode_word(
    const uint32_t (&sw)[4 * sign_chunks<NT>()],
    const uint32_t (&code)[MT][8], int (&acc)[MT][NT][4],
    uint32_t (&rowsum)[MT]) {
  uint32_t b[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    transpose_bytes(code[mt][0], code[mt][2], code[mt][4], code[mt][6],
                    b[mt][0]);
    transpose_bytes(code[mt][1], code[mt][3], code[mt][5], code[mt][7],
                    b[mt][1]);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      rowsum[mt] = __dp4a(code[mt][i], 0x01010101u, rowsum[mt]);
    }
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint32_t lo = sw[2 * nt], hi = sw[2 * nt + 1];
      const uint32_t af[4] = {(lo << (7 - p)) & kBit7, (hi << (7 - p)) & kBit7,
                              (lo << (3 - p)) & kBit7,
                              (hi << (3 - p)) & kBit7};
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint32_t bf[2] = {b[mt][0][p], b[mt][1][p]};
        w1a8::mma_u8u8_16832(acc[mt][nt], af, bf);
      }
    }
  }
}

// One warp's exact partial sums sum_k s_k * code_k over its K slice: the
// spans slice, slice + slices, ... of the words of 16 * NT columns from
// `col` against the codes of `tokens` rows of `a` (stride k), streamed
// through this warp's kStages-stage ring `ring`. acc[mt][nt] is the m16n8
// fragment of tile nt (lane 4g + t: columns col + 2 * NT * g + 2 * nt +
// {0, 1} as d[0, 1] and d[2, 3], tokens 8 * mt + 2t + {0, 1} as d[0, 2]
// and d[1, 3]). Each lane reads only the slots it filled, so no barrier
// orders the ring.
template <int NT, int MT>
__device__ __forceinline__ void decode_warp(
    uint4* ring, const uint8_t* __restrict__ a, int tokens,
    const uint32_t* __restrict__ w, int k, int n, int col, int slice,
    int slices, bool vec_a, bool vec_w, int (&acc)[MT][NT][4]) {
  constexpr int kSign = sign_chunks<NT>(), kChunks = span_chunks<NT, MT>();
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int words = words_of(k);
  const int spans = ceil_div(words, 4);
  const int c = col + 2 * NT * g;
  const uint8_t* rows[MT];
  bool live[MT], fast[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    live[mt] = 8 * mt + g < tokens;
    fast[mt] = live[mt] && vec_a;
    rows[mt] = a + static_cast<size_t>(min(8 * mt + g, tokens - 1)) * k;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;
    }
  }
  const bool fast_w = vec_w && c + 2 * NT <= n;
  ring += lane;
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    stage_span<NT, MT>(ring + p * kChunks * 32, slice + p * slices, spans,
                       w, words, n, c, fast_w, rows, live, fast, k);
  }
  uint32_t rowsum[MT] = {};
  for (int i = 0, s = slice; s < spans; ++i, s += slices) {
    stage_span<NT, MT>(ring + (i + kStages - 1) % kStages * kChunks * 32,
                       s + (kStages - 1) * slices, spans, w, words, n, c,
                       fast_w, rows, live, fast, k);
    w1a8::cp_async_wait<kStages - 1>();
    const uint4* st = ring + i % kStages * kChunks * 32;
    uint32_t sw[4 * kSign], code[MT][8];
#pragma unroll
    for (int h = 0; h < kSign; ++h) {
      const uint4 v = st[32 * h];
      sw[4 * h] = v.x;
      sw[4 * h + 1] = v.y;
      sw[4 * h + 2] = v.z;
      sw[4 * h + 3] = v.w;
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint4 v = st[32 * (kSign + 2 * mt + h)];
        code[mt][4 * h] = v.x;
        code[mt][4 * h + 1] = v.y;
        code[mt][4 * h + 2] = v.z;
        code[mt][4 * h + 3] = v.w;
      }
    }
    decode_word<NT, MT>(sw, code, acc, rowsum);
  }
  w1a8::cp_async_wait<0>();
  // sum s * code = 2 * sum bit * code - sum code = acc / 64 - sum code,
  // token by token: the quads' code sums of token 8 * mt + g, then those
  // of this lane's tokens
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    int r = static_cast<int>(rowsum[mt]);
    r += __shfl_xor_sync(0xffffffffu, r, 1);
    r += __shfl_xor_sync(0xffffffffu, r, 2);
    const int r0 = __shfl_sync(0xffffffffu, r, 8 * t);
    const int r1 = __shfl_sync(0xffffffffu, r, 8 * t + 4);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      acc[mt][nt][0] = (acc[mt][nt][0] >> 6) - r0;
      acc[mt][nt][1] = (acc[mt][nt][1] >> 6) - r1;
      acc[mt][nt][2] = (acc[mt][nt][2] >> 6) - r0;
      acc[mt][nt][3] = (acc[mt][nt][3] >> 6) - r1;
    }
  }
}

// The rows expert e holds: counts[e] clamped to [0, cap].
__device__ __forceinline__ int held_rows(const int* __restrict__ counts, int e,
                                         int cap) {
  return min(max(__ldg(counts + e), 0), cap);
}

// Writes 0 to every output row an expert does not hold (rows counts[e] on
// of expert e's cap), the rows spread over the grid: 16-byte stores where
// n % 4 == 0 and `out` is 16-byte aligned.
__device__ __forceinline__ void zero_rows(const int* __restrict__ counts,
                                          int experts, int cap, int n,
                                          float* __restrict__ out) {
  const bool vec = n % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  for (int r = blockIdx.x; r < experts * cap; r += gridDim.x) {
    if (r % cap < held_rows(counts, r / cap, cap)) continue;
    float* row = out + static_cast<size_t>(r) * n;
    if (vec) {
      for (int i = threadIdx.x; i < n / 4; i += blockDim.x) {
        reinterpret_cast<float4*>(row)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {
      for (int i = threadIdx.x; i < n; i += blockDim.x) row[i] = 0.f;
    }
  }
}

// pre[e] = sum over e' < e of ceil(held_rows(e') / unit), e <= experts;
// returns pre[experts], the row blocks of all experts. Warp 0 scans 32
// experts at a time; every thread of the block calls it (a barrier).
__device__ __forceinline__ int scan_held(const int* __restrict__ counts,
                                         int experts, int cap, int unit,
                                         int* pre) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int carry = 0;
    if (lane == 0) pre[0] = 0;
    for (int base = 0; base < experts; base += 32) {
      const int e = base + lane;
      int v = e < experts ? ceil_div(held_rows(counts, e, cap), unit) : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      if (e < experts) pre[e + 1] = carry + v;
      carry += __shfl_sync(0xffffffffu, v, 31);
    }
  }
  __syncthreads();
  return pre[experts];
}

// The expert whose row blocks hold block h: the last e with pre[e] <= h
// (then pre[e + 1] > h, so e holds rows).
__device__ __forceinline__ int find_expert(const int* pre, int experts,
                                           int h) {
  int lo = 0, hi = experts - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (pre[mid] <= h) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

__device__ __forceinline__ void add4(int4& a, const int4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// Stores one warp's summed fragments through the epilogue: lane 4g + t
// holds tokens 8 * mt + 2t + e (e = 0, 1) of the 2 * NT adjacent columns
// col_blk + col_warp + 2 * NT * g on (acc[mt][nt][2h + e] is column
// 2 * nt + h of them), whose Div and bias sit in sdiv and sbias at the
// tile's column index. Output row row0 + token, rows from `tokens` and
// columns from n not stored; 16-byte stores where whole and aligned.
template <int NT, int MT>
__device__ __forceinline__ void store_fragments(
    const int (&acc)[MT][NT][4], const float* sdiv, const float* sbias,
    void* __restrict__ out, size_t row0, int tokens, int n, int col_blk,
    int col_warp, int quant, float out_step) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int cl = col_warp + 2 * NT * g;
  const int col = col_blk + cl;
  float dv[2 * NT], bs[2 * NT];
#pragma unroll
  for (int i = 0; i < 2 * NT; ++i) {
    dv[i] = sdiv[cl + i];
    bs[i] = sbias[cl + i];
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int tok = 8 * mt + 2 * t + e;
      if (tok >= tokens) continue;
      float y[2 * NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          y[2 * nt + h] = w1a8::epilogue(
              static_cast<float>(acc[mt][nt][2 * h + e]), dv[2 * nt + h],
              bs[2 * nt + h], quant != 0, out_step);
        }
      }
      const size_t o = (row0 + tok) * n + col;
      if (quant) {
        uint8_t* q = static_cast<uint8_t*>(out) + o;
#pragma unroll
        for (int i = 0; i < 2 * NT; ++i) {
          if (col + i < n) q[i] = static_cast<uint8_t>(y[i]);
        }
        continue;
      }
      float* f = static_cast<float*>(out) + o;
      if (NT > 1 && col + 2 * NT <= n &&
          (reinterpret_cast<uintptr_t>(f) & 15) == 0) {
#pragma unroll
        for (int h = 0; h < NT / 2; ++h) {
          reinterpret_cast<float4*>(f)[h] = make_float4(
              y[4 * h], y[4 * h + 1], y[4 * h + 2], y[4 * h + 3]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 2 * NT; ++i) {
          if (col + i < n) f[i] = y[i];
        }
      }
    }
  }
}

// The decode tile: a block of kw x cw warps covers bc = cw * 16 * NT
// columns of up to 8 * MT tokens, warp (kw', cw') the columns 16 * NT *
// cw' on over K slice rank * kw + kw' of kw * cs. 2-D (counts == nullptr):
// `tiles` column tiles of the (cap, n) output, one a cluster. Grouped: the
// clusters walk the (held expert, column tile) items, and every block
// first writes the rows no expert holds as zeros. Dynamic shared memory
// (decode_smem): each warp's ring, a slot for every lane's fragments, the
// tile's Div and bias (copied with the first span, so the epilogue waits
// on no load), then (grouped) the experts' prefix. The kw' = 0 warps of
// rank 0 add the partial sums of the block's other warps and of the other
// ranks, in a fixed order, and store the outputs from their registers.
// cs == 1 launches without a cluster and uses no cluster primitive.
template <int NT, int MT>
__global__ void __launch_bounds__(kDecodeThreads, 1)
matmul_popcount_decode_kernel(const uint8_t* __restrict__ a,
                              const uint32_t* __restrict__ w,
                              const float* __restrict__ div,
                              const float* __restrict__ bias,
                              const int* __restrict__ counts,
                              void* __restrict__ out, int experts, int cap,
                              int k, int n, float out_step, int quant, int cw,
                              int cs, int tiles) {
  extern __shared__ uint4 smem[];
  constexpr int kCols = 16 * NT;
  constexpr int kFrag = MT * NT;  // int4 fragments a lane holds
  constexpr int kRing = kStages * span_chunks<NT, MT>() * 32;  // uint4s
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int kw = warps / cw, wk = warp / cw, wc = warp % cw;
  const int bc = cw * kCols;
  int4* red4 = reinterpret_cast<int4*>(smem + warps * kRing);
  int* red = reinterpret_cast<int*>(red4);
  float* sdiv = reinterpret_cast<float*>(red4 + blockDim.x * kFrag);
  float* sbias = sdiv + bc;
  int* pre = reinterpret_cast<int*>(sbias + bc);
  const int rank = cs > 1 ? cluster_rank() : 0;
  const int cluster = blockIdx.x / cs, clusters = gridDim.x / cs;
  const bool vec_w =
      n % (NT == 1 ? 2 : 4) == 0 &&
      (reinterpret_cast<uintptr_t>(w) & (NT == 1 ? 7 : 15)) == 0;
  const size_t expert_words = static_cast<size_t>(words_of(k)) * n;
  int items = tiles;
  if (counts != nullptr) {
    zero_rows(counts, experts, cap, n, static_cast<float*>(out));
    items = scan_held(counts, experts, cap, cap, pre) * tiles;
  }
  for (int item = cluster; item < items; item += clusters) {
    int e = 0, tokens = cap, tile = item;
    if (counts != nullptr) {
      e = find_expert(pre, experts, item / tiles);
      tile = item % tiles;
      tokens = held_rows(counts, e, cap);
    }
    const int col_blk = tile * bc;
    const float* div_e = div + static_cast<size_t>(e) * n;
    const float* bias_e = bias + static_cast<size_t>(e) * n;
    for (int i = threadIdx.x; i < bc; i += blockDim.x) {
      const int col = min(col_blk + i, n - 1);
      const int bytes = col_blk + i < n ? 4 : 0;
      w1a8::cp_async_lane<4>(sdiv + i, div_e + col, bytes);
      w1a8::cp_async_lane<4>(sbias + i, bias_e + col, bytes);
    }
    const uint8_t* a_e = a + static_cast<size_t>(e) * cap * k;
    const bool vec_a =
        k % 16 == 0 && (reinterpret_cast<uintptr_t>(a_e) & 15) == 0;
    int acc[MT][NT][4];
    decode_warp<NT, MT>(smem + warp * kRing, a_e, tokens,
                        w + e * expert_words, k, n, col_blk + wc * kCols,
                        rank * kw + wk, kw * cs, vec_a, vec_w, acc);
    // the block's sum, in the registers of its kw' = 0 warps: the other
    // warps post their fragments (slot f of lane l of warp w at red4[(w *
    // kFrag + f) * 32 + l]) and those add them in warp order; then rank 0
    // adds the other ranks' in rank order
    int4(&frag)[kFrag] = reinterpret_cast<int4(&)[kFrag]>(acc);
    if (wk > 0) {
#pragma unroll
      for (int f = 0; f < kFrag; ++f) {
        red4[(warp * kFrag + f) * 32 + lane] = frag[f];
      }
    }
    __syncthreads();
    if (wk == 0) {
      for (int q = 1; q < kw; ++q) {
#pragma unroll
        for (int f = 0; f < kFrag; ++f) {
          add4(frag[f], red4[((q * cw + wc) * kFrag + f) * 32 + lane]);
        }
      }
    }
    if (cs > 1) {
      if (wk == 0) {
#pragma unroll
        for (int f = 0; f < kFrag; ++f) {
          red4[(wc * kFrag + f) * 32 + lane] = frag[f];
        }
      }
      cluster_sync();
      if (rank == 0 && wk == 0) {
        for (int r = 1; r < cs; ++r) {
          const int4* peer =
              reinterpret_cast<const int4*>(cluster_peer(red, r));
#pragma unroll
          for (int f = 0; f < kFrag; ++f) {
            add4(frag[f], peer[(wc * kFrag + f) * 32 + lane]);
          }
        }
      }
    }
    if (rank == 0 && wk == 0) {
      store_fragments<NT, MT>(acc, sdiv, sbias, out,
                              static_cast<size_t>(e) * cap, tokens, n,
                              col_blk, wc * kCols, quant, out_step);
    }
    // the partial sums and constants are the next item's; a peer's are
    // read before it moves on
    if (cs > 1) {
      cluster_sync();
    } else {
      __syncthreads();
    }
  }
}

// The grouped form above the decode threshold: the PR-15 tile (bm = 16 *
// WM rows by bn columns) per item, the items the (held expert, row block,
// column block) triples of the experts' held rows, walked by a persistent
// grid; every block first writes the rows no expert holds as zeros.
// Expert e's operands sit at a + e * cap * k, w + e * ceil(k / 32) * n,
// div, bias + e * n and out + e * cap * n. Dynamic shared memory: the
// experts' prefix of row blocks.
template <int WM, int WN>
__global__ void __launch_bounds__(kMatmulThreads, 1)
matmul_popcount_grouped_kernel(const uint8_t* __restrict__ a,
                               const uint32_t* __restrict__ w,
                               const float* __restrict__ div,
                               const float* __restrict__ bias,
                               const int* __restrict__ counts,
                               float* __restrict__ out, int experts, int cap,
                               int k, int n, int bn) {
  __shared__ int red[kMatmulThreads * WM * WN * 4];
  extern __shared__ int pre[];
  const int lane = threadIdx.x & 31;
  const int q = (threadIdx.x / 32) % kSplit;
  const int col_blocks = ceil_div(n, bn);
  zero_rows(counts, experts, cap, n, out);
  const int items = scan_held(counts, experts, cap, 16 * WM, pre) * col_blocks;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int h = item / col_blocks;
    const int e = find_expert(pre, experts, h);
    const int row0 = (h - pre[e]) * 16 * WM;
    const int m_blk = min(16 * WM, held_rows(counts, e, cap) - row0);
    float* out_e = out + static_cast<size_t>(e) * cap * n;
    const uint8_t* a_e = a + static_cast<size_t>(e) * cap * k;
    const uint32_t* w_e = w + static_cast<size_t>(e) * words_of(k) * n;
    const int col = (item % col_blocks) * bn +
                    (threadIdx.x / 32 / kSplit) * 8 * WN;
    const bool vec =
        k % 16 == 0 && (reinterpret_cast<uintptr_t>(a_e) & 15) == 0;
    float dv[WN][2], bs[WN][2];
    w1a8::lane_constants<WN>(div + static_cast<size_t>(e) * n,
                             bias + static_cast<size_t>(e) * n, col, n, dv,
                             bs);
    const uint8_t* rows[WM][2];
    w1a8::row_pointers<WM>(a_e, k, row0, m_blk, rows);
    int acc[WM][WN][4] = {};
    for (int s = 0; s * w1a8::kSpan < k; ++s) {
      uint32_t code[WM][2][kLaneCodes / 4], word[WN];
      w1a8::load_span<WM, WN>(rows, w_e, k, n, s, q, col + (lane >> 2), vec,
                              code, word);
      w1a8::matmul_imma_tile<WM, WN>(code, word, q, acc);
    }
    w1a8::reduce_split(acc, red);
    w1a8::store_tile<WM, WN, kSplit>(acc, dv, bs, out_e, row0, 0, m_blk, n,
                                     col, 1.f, 0, q);
    __syncthreads();  // red is the next item's
  }
}

struct Kernels {
  template <int WM, int WN>
  static auto get() { return matmul_popcount_kernel<WM, WN>; }
};

struct GroupedKernels {
  template <int WM, int WN>
  static auto get() { return matmul_popcount_grouped_kernel<WM, WN>; }
};

// The decode kernel of wm token tiles of 8 and wn column tiles of 16 a
// warp, or nullptr.
using DecodeKernel = decltype(&matmul_popcount_decode_kernel<1, 1>);
DecodeKernel pick_decode(int wm, int wn) {
  switch (10 * wm + wn) {
    case 11: return matmul_popcount_decode_kernel<1, 1>;
    case 12: return matmul_popcount_decode_kernel<2, 1>;
    case 14: return matmul_popcount_decode_kernel<4, 1>;
    case 21: return matmul_popcount_decode_kernel<1, 2>;
    case 22: return matmul_popcount_decode_kernel<2, 2>;
    case 24: return matmul_popcount_decode_kernel<4, 2>;
    default: return nullptr;
  }
}

// True when a decode launch covers an (m, n) output: bm = 8 * wm >= m
// tokens, k <= kMaxK, bn = cw * 16 * wn columns a block, threads a
// multiple of 32 * cw up to kDecodeThreads, clusters of cs blocks.
bool decode_geometry_ok(int m, int k, int n, int bm, int bn, int wm, int wn,
                        int threads, int cs) {
  if (m < 1 || k < 1 || k > kMaxK || n < 1 || bm != 8 * wm || m > bm ||
      cs < 1 || cs > kMaxCluster || bn % (16 * wn) != 0 || bn < 16 * wn) {
    return false;
  }
  const int cw = bn / (16 * wn);
  return threads >= 32 * cw && threads <= kDecodeThreads &&
         threads % (32 * cw) == 0;
}

// Dynamic shared memory of a decode launch (geometry.py::decode_smem): a
// ring of kStages stages a warp, a slot for each lane's fragments, the
// tile's Div and bias, then the prefix of `experts` experts (0 for the 2-D
// entry).
size_t decode_smem(int bn, int wm, int wn, int threads, int experts) {
  const int chunks = (wn == 1 ? 1 : wn / 2) + 2 * wm;
  return sizeof(uint4) * threads * (kStages * chunks + wm * wn) +
         sizeof(int) * (2 * bn + (experts > 0 ? experts + 1 : 0));
}

template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), int blocks, int threads,
                            size_t smem, int cs, void* stream,
                            Args... args) {
  cudaError_t err = w1a8::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cs > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

}  // namespace

extern "C" {

// a (m, k) uint8 codes on one grid; w (ceil(k / 32), n) sign words; div and
// bias (n,) f32; out (m, n), uint8 codes when quant != 0, else f32. The
// launch geometry is w1a8_matmul's, from kernels/w1a8_matmul/geometry.py;
// one that does not cover the output exactly is refused with
// cudaErrorInvalidValue. Returns cudaGetLastError() otherwise.
int w1a8_matmul_popcount(const void* a, const void* w, const void* div,
                         const void* bias, void* out, int m, int k, int n,
                         float out_step, int quant, int grid_x, int grid_y,
                         int bm, int bn, int wm, int wn, int threads,
                         void* stream) {
  const auto kernel = w1a8::pick_matmul<Kernels, 11>(wm, wn);
  if (!kernel || !w1a8::matmul_geometry_ok(m, k, n, grid_x, grid_y, bm, bn,
                                           wm, wn, threads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  kernel<<<dim3(grid_x, grid_y), threads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint32_t*>(w),
      static_cast<const float*>(div), static_cast<const float*>(bias), out,
      m, k, n, bn, out_step, quant);
  return static_cast<int>(cudaGetLastError());
}

// The same product at m <= 16 rows through the decode tile, with the
// geometry of kernels/w1a8_matmul/geometry.py::decode_launch: `blocks` =
// ceil(n / bn) * cs blocks of `threads`, bm = 8 * wm tokens, bn = cw * 16 *
// wn columns a block, clusters of cs blocks splitting K. One that does not
// cover the output exactly is refused with cudaErrorInvalidValue.
int w1a8_matmul_popcount_decode(const void* a, const void* w, const void* div,
                                const void* bias, void* out, int m, int k,
                                int n, float out_step, int quant, int blocks,
                                int threads, int bm, int bn, int wm, int wn,
                                int cs, void* stream) {
  const DecodeKernel kernel = pick_decode(wm, wn);
  if (!kernel || !decode_geometry_ok(m, k, n, bm, bn, wm, wn, threads, cs) ||
      blocks != ceil_div(n, bn) * cs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cw = bn / (16 * wn);
  const cudaError_t err = launch_clusters(
      kernel, blocks, threads, decode_smem(bn, wm, wn, threads, 0),
      cs, stream, a, w, div, bias, nullptr, out, 1, m, k, n, out_step, quant,
      cw, cs, ceil_div(n, bn));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The grouped entry: a (experts, cap, k) uint8 codes on one grid; w
// (experts, ceil(k / 32), n) sign words; div and bias (experts, n) f32;
// counts (experts,) int32, the rows each expert holds (clamped to [0,
// cap]), read on the device; out (experts, cap, n) f32, rows from
// counts[e] on written as zeros. One launch of `blocks` persistent blocks
// of `threads`: with decode != 0 the decode tile (bm = 8 * wm >= cap
// tokens, bn = cw * 16 * wn, clusters of cs blocks), else the PR-15 tile
// (bm = 16 * wm, bn = 8 * wn * threads / 64, cs = 1). A geometry the
// kernels do not build, or more than kMaxExperts experts, is refused with
// cudaErrorInvalidValue.
int w1a8_matmul_popcount_grouped(const void* a, const void* w,
                                 const void* div, const void* bias,
                                 const void* counts, void* out, int experts,
                                 int cap, int k, int n, int decode,
                                 int blocks, int threads, int bm, int bn,
                                 int wm, int wn, int cs, void* stream) {
  if (experts < 1 || experts > kMaxExperts || blocks < 1 || blocks % cs != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (decode) {
    const DecodeKernel kernel = pick_decode(wm, wn);
    if (!kernel || !decode_geometry_ok(cap, k, n, bm, bn, wm, wn, threads,
                                       cs)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int cw = bn / (16 * wn);
    const cudaError_t err = launch_clusters(
        kernel, blocks, threads,
        decode_smem(bn, wm, wn, threads, experts),
        cs, stream, a, w, div, bias, counts, out, experts, cap, k, n, 1.f, 0,
        cw, cs, ceil_div(n, bn));
    return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
  }
  const auto kernel = w1a8::pick_matmul<GroupedKernels, 11>(wm, wn);
  if (!kernel || cs != 1 ||
      !w1a8::matmul_geometry_ok(cap, k, n, ceil_div(cap, bm),
                                ceil_div(n, bn), bm, bn, wm, wn, threads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  kernel<<<blocks, threads, sizeof(int) * (experts + 1),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint32_t*>(w),
      static_cast<const float*>(div), static_cast<const float*>(bias),
      static_cast<const int*>(counts), static_cast<float*>(out), experts, cap,
      k, n, bn);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
