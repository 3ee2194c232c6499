// The integer PE: one layer of the detector's integer golden datapath (the
// paper's RTL analogue), bit for bit, on the int8 tensor cores.
//
// Replaces repro/models/yolo.py::yolo_forward_int, a numpy int64 path and no
// Pallas kernel. One launch computes one layer of it:
//
//   kind 0, W1A8 (conv2-conv10, 3x3 SAME with zero padding or 1x1): the PE
//     of Eq. 3-4, acc[n] = sum_k a_k * m[c(k)] * s[k, n] with K in (dy, dx,
//     cin) order and s = +-1 from packed sign words, then
//     q = clip(rshift_round(acc * mult[n] + bias[n], shift[n]), 0, 255),
//     bias = b_pre;
//   kind 1, conv1 (3x3 SAME): dense Q5.11 weights on the Q0.8 pixel codes,
//     no Mul_prev, t = max(acc + bias[n], 0) with bias = b_raw << 5, then
//     q = clip(rshift_round(t * mult[n], shift[n]), 0, 255);
//   kind 2, the head (conv11, 1x1): acc = sum_k a_k * m[c(k)] * w[k, n], dense
//     Q1.15 weights, raw = rshift_round(acc, shift) + bias[n], bias =
//     b_raw << 3, stored as int64 (Q*.15), negatives kept.
//
// with an optional 2x2 max of the codes (kinds 0 and 1). rshift_round is the
// RTL's symmetric rounder, sign(x) * ((|x| + half) >> s) with half =
// 2^(s - 1) (0 at s = 0): an arithmetic shift of a negative value floors
// and would be wrong. Every sum and product is int64 and wraps as numpy's
// does; a shift outside [0, 62] is refused.
//
// Exactness on the int8 tensor cores. acc[n] = sum_k a_k * W'[k, n] with a
// constant W' (m[c(k)] * s[k, n], w_raw, or m[c] * w_raw[c, n]). Written in
// signed digits that fit s8, W' = sum_j 128^j * d_j mod 2^64 with |d_j| <=
// 127 (sign-magnitude, kernels/w1a8_int/planes.py), the sum is acc =
// sum_j 128^j * (A . D_j): each plane's A . D_j is a u8 * s8 product with an
// exact int32 sum (|A . D_j| <= 255 * 127 * K < 2^31 for K <= 66311), and
// the planes combine in int64 with wrapping shifts and adds, exact modulo
// 2^64: equal to numpy's wrapped int64 sum bit for bit, even where it wraps.
// The detector needs one plane (conv6-conv10), two (conv1-conv5) or three
// (the head); any count up to 10 runs, kGroup<KIND> planes a pass of the K
// loop.
//
// What bounds it on the H100: at the detector's shapes neither the bytes
// (codes in and out, weights and constants) nor the int8 tensor-core rate,
// but latency, as for the popcount convs whose tiles it shares: one warp
// issues mma.sync far below a tensor core's rate, the block stages its
// codes once, and the int64 epilogue comes on top. chip_smoke.py reports
// the bound as the larger of bytes / 3.35 TB/s and 2 * MACs over the int8
// dense peak, the same work whatever the plane count.
//
// Design: the popcount conv kernels' implicit GEMM (w1a8_conv3x3_popcount.cu,
// w1a8_conv3x3_pool2_popcount.cu) with their staging of raw codes, their
// window unit offsets and their geometry (kernels/w1a8_int/geometry.py,
// from kernels/w1a8_conv/geometry.py), 3x3 and 1x1 alike, the 1x1 layers
// as a one-tap window. One A fragment of 32 codes (ldmatrix from the staged
// strip) feeds one mma.sync.m16n8k32 per plane, into one int32 accumulator
// set per plane. The B fragments: kind 0 reads the layer's 1-bit sign
// words and the per-channel digits of m_raw, and forms s * d per byte in
// registers (the digit in place of the popcount route's +-1: Mul_prev fused
// into the BNN PE); kinds 1 and 2 read s8 planes of their dense W' from
// shared memory. The epilogue combines the planes in wrapping int64 and
// applies the kind's int64 epilogue per conv output; a fused 2x2 max takes
// the max of the four outputs' codes (acc * mult may wrap, so the epilogue
// is not monotone in acc, and the max is never taken over acc).
#include "w1a8_common.cuh"

namespace {

using w1a8::ceil_div;
using w1a8::code_stride;
using w1a8::code_units;
using w1a8::kChunk;

constexpr int kMaxThreads = 256;
// Planes one pass of the K loop accumulates: two for the W1A8 layers and
// conv1 (one or two planes each at the detector), four for the head (three
// planes), whose K loop is short and whose grid is small.
template <int KIND>
constexpr int kGroup = KIND == 2 ? 4 : 2;
constexpr int kMaxPlanes = 10;  // 128^10 > 2^64
constexpr int kRadixBits = 7;   // digits in radix 128
constexpr int kMaxK = 66311;    // 255 * 127 * K < 2^31

__device__ __forceinline__ int64_t wrap_add(int64_t a, int64_t b) {
  return static_cast<int64_t>(static_cast<uint64_t>(a) +
                              static_cast<uint64_t>(b));
}

__device__ __forceinline__ int64_t wrap_mul(int64_t a, int64_t b) {
  return static_cast<int64_t>(static_cast<uint64_t>(a) *
                              static_cast<uint64_t>(b));
}

__device__ __forceinline__ int64_t wrap_neg(int64_t a) {
  return static_cast<int64_t>(0ull - static_cast<uint64_t>(a));
}

// 2^(s - 1), 0 at s = 0: the rounder's half for shift s.
__device__ __forceinline__ int64_t half_of(int s) {
  return s > 0 ? (int64_t{1} << (s - 1)) : 0;
}

// numpy's sign(x) * ((abs(x) + half) >> s), int64 throughout: abs wraps at
// INT64_MIN and >> is arithmetic, as numpy's are. 0 <= s <= 62, half =
// half_of(s). Branch-free: with m = x >> 63 (all ones where x < 0),
// (x ^ m) - m is abs(x) and (r ^ m) - m is sign(x) * r; x = 0 gives
// half >> s = 0.
__device__ __forceinline__ int64_t rshift_round(int64_t x, int s,
                                                int64_t half) {
  const int64_t m = x >> 63;
  const int64_t r = wrap_add(wrap_add(x ^ m, wrap_neg(m)), half) >> s;
  return wrap_add(r ^ m, wrap_neg(m));
}

template <int KIND>
__device__ __forceinline__ int64_t epilogue(int64_t acc, int64_t mult,
                                            int64_t bias, int shift,
                                            int64_t half) {
  if constexpr (KIND == 2) {
    return wrap_add(rshift_round(acc, shift, half), bias);
  }
  int64_t p;
  if constexpr (KIND == 1) {
    const int64_t t = wrap_add(acc, bias);
    p = wrap_mul(t > 0 ? t : 0, mult);
  } else {
    p = wrap_add(wrap_mul(acc, mult), bias);
  }
  const int64_t q = rshift_round(p, shift, half);
  return q < 0 ? 0 : (q > 255 ? 255 : q);
}

// Units of 16 channels of one tap in the window, the (tap, unit) order of
// K, and the pairs of them one mma.sync takes.
__host__ __device__ constexpr int window_units(int ks, int cin) {
  return ks * ks * code_units(cin);
}

__host__ __device__ constexpr int window_pairs(int ks, int cin) {
  return ceil_div(window_units(ks, cin), 2);
}

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) / 16 * 16;
}

// Shared memory of a block, in this order: kind 0, the pair words
// (window_pairs + 1, bn) then the digit words and their negations (2,
// planes, code_units(cin), 16 bytes); kinds 1 and 2, the planes (planes,
// 2 * window_pairs, bn, 16 bytes); then the window's unit offsets
// (2 * window_pairs ints) and `staged_rows` rows of `row_px` staged pixels
// (kernels/w1a8_int/geometry.py computes the same).
__host__ __device__ constexpr size_t weights_smem(int kind, int ks, int cin,
                                                  int bn, int planes) {
  return kind == 0
             ? align16(sizeof(uint32_t) * (window_pairs(ks, cin) + 1) * bn) +
                   static_cast<size_t>(2) * planes * code_units(cin) * kChunk
             : static_cast<size_t>(planes) * 2 * window_pairs(ks, cin) * bn *
                   kChunk;
}

__host__ __device__ constexpr size_t pe_smem(int kind, int ks, int cin,
                                             int bn, int planes,
                                             int staged_rows, int row_px) {
  return weights_smem(kind, ks, cin, bn, planes) +
         align16(sizeof(int) * 2 * window_pairs(ks, cin)) +
         static_cast<size_t>(staged_rows) * row_px * code_stride(cin);
}

// The pair words of output channels [co0, co0 + bn): bits 0-15 the signs
// of unit 2j's 16 channels, bits 16-31 those of unit 2j + 1, from the sign
// words w (ceil(ks * ks * cin / 32), cout). Unit u = (tap, c) holds the
// signs of k = tap * cin + 16 * c on. With cin % 16 == 0 unit u starts at
// bit 16 * u, so pair word j is sign word j, staged 16 bytes at a time as
// the popcount convs stage theirs (cp_async_wait_all before reading);
// otherwise each unit's 16 bits are cut from the words (the bits past cin
// belong to the next tap and meet zero codes and zero digits). Columns
// past cout hold 0.
__device__ __forceinline__ void stage_pairs(const uint32_t* __restrict__ w,
                                            uint32_t* wsm, int ks, int cin,
                                            int cout, int co0, int bn) {
  const int n_words = w1a8::words_of(ks * ks * cin);
  if (cin % kChunk == 0) {
    w1a8::stage_conv_words(w, wsm, n_words, cout, co0, bn);
    return;
  }
  const int cu = code_units(cin);
  const int units = window_units(ks, cin);
  for (int i = threadIdx.x; i < window_pairs(ks, cin) * bn;
       i += blockDim.x) {
    const int j = i / bn;
    const int co = co0 + i % bn;
    uint32_t v = 0u;
    for (int half = 0; half < 2 && co < cout; ++half) {
      const int u = 2 * j + half;
      if (u >= units) break;
      const int tap = u / cu;
      const int k = tap * cin + (u - tap * cu) * kChunk;
      const int q = k / w1a8::kPack;
      const uint32_t lo = w[static_cast<size_t>(q) * cout + co];
      const uint32_t up =
          q + 1 < n_words ? w[static_cast<size_t>(q + 1) * cout + co] : 0u;
      v |= (__funnelshift_r(lo, up, k & (w1a8::kPack - 1)) & 0xFFFFu)
           << (16 * half);
    }
    wsm[i] = v;
  }
}

// Each byte of x negated (mod 256).
__device__ __forceinline__ uint32_t neg_bytes(uint32_t x) {
  uint32_t r = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    r |= ((0u - ((x >> (8 * i)) & 0xFFu)) & 0xFFu) << (8 * i);
  }
  return r;
}

// Kind 0's digit words: word (j, c, q) holds the digits of plane j of
// channels 16 * c + 4q .. + 3, then the same words negated. mdig is
// (planes, 16 * code_units(cin)) int8, zero past cin.
__device__ __forceinline__ void stage_digits(const int8_t* __restrict__ mdig,
                                             uint32_t* dtab, int planes,
                                             int cin) {
  const int total = planes * code_units(cin) * 4;
  const uint32_t* src = reinterpret_cast<const uint32_t*>(mdig);
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const uint32_t v = src[i];
    dtab[i] = v;
    dtab[total + i] = neg_bytes(v);
  }
}

// Kinds 1 and 2: the planes of output channels [co0, co0 + bn) as
// (planes, 2 * window_pairs, bn) units of 16 bytes, from the (planes,
// window_units, cout, 16) int8 planes, one cp_async_16 each
// (cp_async_wait_all before reading); units past the window and columns
// past cout hold 0.
__device__ __forceinline__ void stage_dense(const int8_t* __restrict__ planes,
                                            uint4* wpl, int n_planes, int ks,
                                            int cin, int cout, int co0,
                                            int bn) {
  const int units = window_units(ks, cin);
  const int u2 = 2 * window_pairs(ks, cin);
  for (int i = threadIdx.x; i < n_planes * u2 * bn; i += blockDim.x) {
    const int col = i % bn;
    const int r = i / bn;
    const int u = r % u2;
    const int j = r / u2;
    const int co = co0 + col;
    const bool in = u < units && co < cout;
    w1a8::cp_async_16(
        wpl + i,
        in ? planes + ((static_cast<size_t>(j) * units + u) * cout + co) *
                          kChunk
           : planes,
        in ? 16 : 0);
  }
}

// The byte offset of unit u = (tap, c) of the window from the output's
// window corner (staged pixel column = output column, staged row = output
// row): a 3x3 tap lies tap / 3 rows and tap % 3 pixels on, the 1x1 tap one
// pixel on (the staged strip keeps a zero column on each side). Units past
// the window read the corner (their B is 0).
__device__ __forceinline__ void stage_offsets(int* uoff, int ks, int cin,
                                              int row_stride) {
  const int cu = code_units(cin);
  const int ps = code_stride(cin);
  for (int u = threadIdx.x; u < 2 * window_pairs(ks, cin); u += blockDim.x) {
    const int tap = u / cu;
    const int at = ks == 3 ? (tap / 3) * row_stride + (tap % 3) * ps : ps;
    uoff[u] = tap < ks * ks ? at + (u - tap * cu) * kChunk : 0;
  }
}

// 0xFF in byte i where bit i of `bits` is 1 (sign +1), else 0x00, for
// bits 0-3: w1a8::sign_bytes' spread of four bits to four bytes.
__device__ __forceinline__ uint32_t plus_mask(uint32_t bits) {
  return (((bits & 0xFu) * 0x00204081u) & 0x01010101u) * 0xFFu;
}

// Accumulates planes j0 .. min(j0 + G, n_planes) - 1 of WM M tiles of
// 16 outputs against WN N tiles of 8 channels over the whole window:
// acc[jj][mt][nt] is the m16n8 int32 fragment of plane j0 + jj, M tile mt,
// channels col0 + 8 * nt on. The pairs of units run in one order for every
// output, as in w1a8::conv3x3_imma_tile, and each A fragment feeds one
// mma.sync per plane. Kind 0's B: per byte, the plane's digit of the
// channel where the sign bit is 1, its negation where it is 0, and 0 past
// the window's last unit (whose A rows read the window corner); kinds 1
// and 2 read the s8 planes, 0 past the last unit.
template <int KIND, int WM, int WN>
__device__ __forceinline__ void pe_tile(
    const uint8_t* act, const int (&a_off)[WM], const int* uoff, int units,
    int u2, int cu, const uint32_t* wsm, const uint32_t* dtab,
    const uint32_t* wpl, int bn, int col0, int j0, int n_planes,
    int (&acc)[kGroup<KIND>][WM][WN][4]) {
  constexpr int G = kGroup<KIND>;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int g = lane >> 2;
  const int hi = lane >> 4;
#pragma unroll
  for (int jj = 0; jj < G; ++jj) {
#pragma unroll
    for (int mt = 0; mt < WM; ++mt) {
#pragma unroll
      for (int nt = 0; nt < WN; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[jj][mt][nt][i] = 0;
      }
    }
  }
  const int neg = n_planes * cu * 4;   // the negated digit words
  int c = 0;                           // channel unit of unit u: u % cu
#pragma unroll 2
  for (int u = 0; u < units; u += 2) {
    const uint8_t* at = act + uoff[u + hi];
    uint32_t b[G][WN][2];
    if constexpr (KIND == 0) {
      const int cr[2] = {c, c + 1 == cu ? 0 : c + 1};
      const bool ur[2] = {true, u + 1 < units};
      uint32_t dpos[G][2], dneg[G][2];
#pragma unroll
      for (int jj = 0; jj < G; ++jj) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = ((j0 + jj) * cu + cr[r]) * 4 + t;
          const bool on = j0 + jj < n_planes && ur[r];
          dpos[jj][r] = on ? dtab[i] : 0u;
          dneg[jj][r] = on ? dtab[neg + i] : 0u;
        }
      }
      c += 2;
      c -= c >= cu ? cu : 0;
      c -= c >= cu ? cu : 0;
      const uint32_t* wj = wsm + (u >> 1) * bn + col0 + g;
#pragma unroll
      for (int nt = 0; nt < WN; ++nt) {
        const uint32_t bits = wj[8 * nt] >> (4 * t);
        const uint32_t m[2] = {plus_mask(bits), plus_mask(bits >> 16)};
#pragma unroll
        for (int jj = 0; jj < G; ++jj) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            b[jj][nt][r] = (dpos[jj][r] & m[r]) | (dneg[jj][r] & ~m[r]);
          }
        }
      }
    } else {
#pragma unroll
      for (int jj = 0; jj < G; ++jj) {
#pragma unroll
        for (int nt = 0; nt < WN; ++nt) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = (((j0 + jj) * u2 + u + r) * bn + col0 + 8 * nt + g) *
                              4 + t;
            b[jj][nt][r] = j0 + jj < n_planes ? wpl[i] : 0u;
          }
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < WM; ++mt) {
      uint32_t a[4];
      w1a8::ldmatrix_x4(a, at + a_off[mt]);
#pragma unroll
      for (int jj = 0; jj < G; ++jj) {
        if (j0 + jj >= n_planes) continue;
#pragma unroll
        for (int nt = 0; nt < WN; ++nt) {
          w1a8::mma_u8s8_16832(acc[jj][mt][nt], a, b[jj][nt]);
        }
      }
    }
  }
}

// x (b, h, w, cin) uint8 codes. Kind 0: wbits (ceil(ks * ks * cin / 32),
// cout) sign words, LSB first along K, and planes (n_planes, 16 *
// code_units(cin)) int8, the digits of m_raw; kinds 1 and 2: planes
// (n_planes, ks * ks * code_units(cin), cout, 16) int8, the digits of W'.
// mult, bias (cout,) int64 (mult null for kind 2); shift (cout,) int64 or
// null (every channel shift_all). out (b, h, w, cout), or (b, h / 2, w / 2,
// cout) pooled: uint8 codes for kinds 0 and 1, int64 for kind 2. Grid
// (ceil(cout / bn), ceil(h_out / rows), b), h_out the output rows (pooled
// rows with POOL).
template <int KIND, int KS, bool POOL, int WM, int WN>
__global__ void __launch_bounds__(kMaxThreads)
int_pe_kernel(const uint8_t* __restrict__ x, const uint32_t* __restrict__ wbits,
              const int8_t* __restrict__ planes, int n_planes,
              const int64_t* __restrict__ mult,
              const int64_t* __restrict__ bias,
              const int64_t* __restrict__ shift, int shift_all,
              void* __restrict__ out, int h, int width, int cin, int cout,
              int rows, int bn, int row_px) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int co0 = blockIdx.x * bn;
  const int y0 = blockIdx.y * rows;
  const int b = blockIdx.z;
  const int ph = h / 2;
  const int pw = width / 2;
  const int n_rows = min(rows, (POOL ? ph : h) - y0);
  const int units = window_units(KS, cin);
  const int u2 = 2 * window_pairs(KS, cin);
  const int ps = code_stride(cin);
  const int row_stride = row_px * ps;

  uint32_t* wsm = reinterpret_cast<uint32_t*>(smem);
  const int cu = code_units(cin);
  uint32_t* dtab = reinterpret_cast<uint32_t*>(
      smem + align16(sizeof(uint32_t) * (u2 / 2 + 1) * bn));
  const uint32_t* wpl = wsm;
  int* uoff = reinterpret_cast<int*>(
      smem + weights_smem(KIND, KS, cin, bn, n_planes));
  uint8_t* act = reinterpret_cast<uint8_t*>(uoff) + align16(sizeof(int) * u2);
  if constexpr (KIND == 0) {
    stage_pairs(wbits, wsm, KS, cin, cout, co0, bn);
    stage_digits(planes, dtab, n_planes, cin);
  } else {
    stage_dense(planes, reinterpret_cast<uint4*>(smem), n_planes, KS, cin,
                cout, co0, bn);
  }
  stage_offsets(uoff, KS, cin, row_stride);
  w1a8::stage_raw_codes(
      x + static_cast<size_t>(b) * h * width * cin, act,
      (POOL ? 2 * y0 : y0) - KS / 2, (POOL ? 2 * n_rows : n_rows) + KS - 1,
      h, width, cin, row_px);
  w1a8::cp_async_wait_all();
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t2 = 2 * (lane & 3);
  const int m_blk = POOL ? 4 * n_rows * pw : n_rows * width;
  const int m_items = ceil_div(ceil_div(m_blk, 16), WM);
  const int items = m_items * (bn / (8 * WN));
  for (int item = threadIdx.x / 32; item < items; item += blockDim.x / 32) {
    const int m0 = (item % m_items) * WM * 16;
    const int col0 = (item / m_items) * 8 * WN;
    int a_off[WM];
#pragma unroll
    for (int mt = 0; mt < WM; ++mt) {
      // rows past the block's outputs read a valid pixel; never stored
      const int i = min(m0 + mt * 16 + (lane & 15), m_blk - 1);
      if (POOL) {
        // M row 4p + q is conv output (2 * py + q / 2, 2 * px + q % 2) of
        // pooled pixel p = (py, px) of the block
        const int p = i >> 2;
        a_off[mt] = (2 * (p / pw) + ((i >> 1) & 1)) * row_stride +
                    (2 * (p % pw) + (i & 1)) * ps;
      } else {
        a_off[mt] = (i / width) * row_stride + (i % width) * ps;
      }
    }
    int64_t acc64[WM][WN][4];
#pragma unroll
    for (int mt = 0; mt < WM; ++mt) {
#pragma unroll
      for (int nt = 0; nt < WN; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc64[mt][nt][i] = 0;
      }
    }
    constexpr int G = kGroup<KIND>;
    for (int j0 = 0; j0 < n_planes; j0 += G) {
      int acc[G][WM][WN][4];
      pe_tile<KIND, WM, WN>(act, a_off, uoff, units, u2, cu, wsm, dtab, wpl,
                            bn, col0, j0, n_planes, acc);
      // acc64 += acc_j << 7j, wrapping: exact modulo 2^64
#pragma unroll
      for (int jj = 0; jj < G; ++jj) {
        if (j0 + jj >= n_planes) continue;
        const int s = kRadixBits * (j0 + jj);
#pragma unroll
        for (int mt = 0; mt < WM; ++mt) {
#pragma unroll
          for (int nt = 0; nt < WN; ++nt) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc64[mt][nt][i] = wrap_add(
                  acc64[mt][nt][i],
                  static_cast<int64_t>(
                      static_cast<uint64_t>(
                          static_cast<int64_t>(acc[jj][mt][nt][i]))
                      << s));
            }
          }
        }
      }
    }
    // this lane holds rows g and g + 8 of each M tile, columns t2, t2 + 1
    // of each N tile; their constants, 0 past cout
    int64_t mu[WN][2], bs[WN][2], hf[WN][2];
    int sh[WN][2];
#pragma unroll
    for (int nt = 0; nt < WN; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int co = co0 + col0 + 8 * nt + t2 + e;
        const bool in = co < cout;
        mu[nt][e] = KIND == 2 || !in ? 1 : mult[co];
        bs[nt][e] = in ? bias[co] : 0;
        sh[nt][e] = shift != nullptr && in ? static_cast<int>(shift[co])
                                           : shift_all;
        hf[nt][e] = half_of(sh[nt][e]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < WM; ++mt) {
#pragma unroll
      for (int nt = 0; nt < WN; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = m0 + mt * 16 + g + 8 * (i >> 1);
          const int co = co0 + col0 + 8 * nt + t2 + (i & 1);
          const int64_t e =
              epilogue<KIND>(acc64[mt][nt][i], mu[nt][i & 1], bs[nt][i & 1],
                             sh[nt][i & 1], hf[nt][i & 1]);
          if constexpr (POOL) {
            // the quad's four outputs sit in rows g, g ^ 1, g ^ 2, g ^ 3:
            // the lanes whose bits 2 and 3 differ; max of their codes
            int q = static_cast<int>(e);
            q = max(q, __shfl_xor_sync(0xffffffffu, q, 4));
            q = max(q, __shfl_xor_sync(0xffffffffu, q, 8));
            if ((g & 3) || row >= m_blk || co >= cout) continue;
            const int p = row >> 2;
            static_cast<uint8_t*>(out)[((static_cast<size_t>(b) * ph + y0 +
                                         p / pw) * pw + p % pw) * cout + co] =
                static_cast<uint8_t>(q);
          } else {
            if (row >= m_blk || co >= cout) continue;
            const size_t at =
                ((static_cast<size_t>(b) * h + y0) * width + row) * cout + co;
            if constexpr (KIND == 2) {
              static_cast<int64_t*>(out)[at] = e;
            } else {
              static_cast<uint8_t*>(out)[at] = static_cast<uint8_t>(e);
            }
          }
        }
      }
    }
  }
}

// The instantiation for warp tile (wm, wn), or nullptr; the tiles are
// kernels/w1a8_int/geometry.py's WARP_TILES.
template <int KIND, int KS, bool POOL>
auto pick(int wm, int wn) -> decltype(&int_pe_kernel<KIND, KS, POOL, 1, 1>) {
  switch (wm * 10 + wn) {
    case 22: return int_pe_kernel<KIND, KS, POOL, 2, 2>;
    case 21: return int_pe_kernel<KIND, KS, POOL, 2, 1>;
    case 11: return int_pe_kernel<KIND, KS, POOL, 1, 1>;
    default: return nullptr;
  }
}

struct Args {
  const void* x;
  const void* wbits;
  const void* planes;
  int n_planes;
  const void* mult;
  const void* bias;
  const void* shift;
  int shift_all;
  void* out;
  int b, h, wd, cin, cout;
  int grid_x, grid_y, rows, bn, wm, wn, row_px, threads, smem;
};

template <int KIND, int KS, bool POOL>
int launch(const Args& a, cudaStream_t stream) {
  const auto kernel = pick<KIND, KS, POOL>(a.wm, a.wn);
  if (kernel == nullptr ||
      static_cast<size_t>(a.smem) <
          pe_smem(KIND, KS, a.cin, a.bn, a.n_planes,
                  (POOL ? 2 * a.rows : a.rows) + KS - 1, a.row_px)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = w1a8::allow_smem(kernel, a.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(a.grid_x, a.grid_y, a.b), a.threads, a.smem, stream>>>(
      static_cast<const uint8_t*>(a.x),
      static_cast<const uint32_t*>(a.wbits),
      static_cast<const int8_t*>(a.planes), a.n_planes,
      static_cast<const int64_t*>(a.mult),
      static_cast<const int64_t*>(a.bias),
      static_cast<const int64_t*>(a.shift), a.shift_all, a.out, a.h, a.wd,
      a.cin, a.cout, a.rows, a.bn, a.row_px);
  return static_cast<int>(cudaGetLastError());
}

// Kind 0 at ksize 3 or 1, kind 1 at ksize 3, pooled or not.
template <int KIND>
int launch_pool(const Args& a, int ksize, int pool, cudaStream_t stream) {
  if constexpr (KIND == 0) {
    if (ksize == 1) {
      return pool ? launch<KIND, 1, true>(a, stream)
                  : launch<KIND, 1, false>(a, stream);
    }
  }
  return pool ? launch<KIND, 3, true>(a, stream)
              : launch<KIND, 3, false>(a, stream);
}

}  // namespace

extern "C" {

// One layer of the integer datapath; see the note at the top for `kind`
// and the operands. [shift_lo, shift_hi] is the range of the shifts the
// launch reads (shift_all's when `shift` is null). The launch geometry
// (grid, rows, bn, warp tile, row_px, threads, smem) is
// kernels/w1a8_int/geometry.py's. Refused with cudaErrorInvalidValue: a
// shift range outside [0, 62]; a ksize other than 1 or 3 (kind 0), 3
// (kind 1) or 1 (kind 2); a pool on the head or on an odd plane; an empty
// shape; a plane count outside [1, 10]; K = ksize^2 * cin past 66311 (a
// plane's int32 sum could reach 2^31); planes not 16-byte aligned; a
// geometry that does not cover the output exactly or whose shared memory
// does not hold the block's staging. Returns cudaGetLastError() otherwise.
int w1a8_int_pe(int kind, int ksize, int pool, const void* x,
                const void* wbits, const void* planes, int n_planes,
                const void* mult, const void* bias, const void* shift,
                int shift_all, int shift_lo, int shift_hi, void* out, int b,
                int h, int wd, int cin, int cout, int grid_x, int grid_y,
                int rows, int bn, int wm, int wn, int row_px, int threads,
                int smem, void* stream) {
  const int h_out = pool ? h / 2 : h;
  const bool ok =
      kind >= 0 && kind <= 2 &&
      (kind == 0 ? ksize == 1 || ksize == 3
                 : ksize == (kind == 1 ? 3 : 1)) &&
      shift_lo >= 0 && shift_hi <= 62 && shift_lo <= shift_hi &&
      (shift != nullptr || (shift_lo == shift_all && shift_hi == shift_all)) &&
      !(pool && (kind == 2 || h % 2 || wd % 2)) && b > 0 && h > 0 &&
      wd > 0 && cin > 0 && cout > 0 && b <= 65535 && n_planes >= 1 &&
      n_planes <= kMaxPlanes && ksize * ksize * cin <= kMaxK &&
      x != nullptr && planes != nullptr && bias != nullptr &&
      out != nullptr && (kind == 2 || mult != nullptr) &&
      (kind != 0 || wbits != nullptr) &&
      (reinterpret_cast<uintptr_t>(planes) & 15) == 0 && rows >= 1 &&
      wm >= 1 && wn >= 1 && bn >= 8 * wn && bn % (8 * wn) == 0 &&
      grid_x * bn >= cout && (grid_x - 1) * bn < cout &&
      grid_y * rows >= h_out && (grid_y - 1) * rows < h_out &&
      grid_y <= 65535 && threads >= 32 && threads <= kMaxThreads &&
      threads % 32 == 0 && row_px >= wd + 2 && smem >= 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x,  wbits,  planes, n_planes, mult, bias,   shift,
               shift_all, out, b,  h,        wd,   cin,    cout,
               grid_x,    grid_y, rows, bn,  wm,   wn,     row_px,
               threads,   smem};
  const auto st = static_cast<cudaStream_t>(stream);
  if (kind == 0) return launch_pool<0>(a, ksize, pool, st);
  if (kind == 1) return launch_pool<1>(a, ksize, pool, st);
  return launch<2, 1, false>(a, st);
}

}  // extern "C"
