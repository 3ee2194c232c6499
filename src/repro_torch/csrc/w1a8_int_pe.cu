// The integer PE: one layer of the detector's integer golden datapath (the
// paper's RTL analogue), bit for bit, on the CUDA cores.
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
// What bounds it on the H100: the issue rate of integer instructions on
// the CUDA cores. The accumulator has to be int64 (acc * mult + b_pre
// passes 2^35 on a calibrated detector, and the reference puts no bound on
// m_raw), and int64 has no tensor-core path, so every MAC is a 64-bit
// select and add (conv1 and the head: a 64-bit multiply-add), some four to
// five instructions: 2.38 * 10^9 MACs a forward at B = 4, 320x320. The
// bytes (codes in and out, weights and constants, 8.9 MB a forward) are no
// limit. chip_smoke.py reports the roofline bound as the larger of bytes /
// 3.35 TB/s and 2 * MACs over the int8 dense peak, the time the same work
// would take as byte planes on the int8 tensor cores.
//
// Design, simple and exact: a direct implicit GEMM. A block owns an 8x8
// tile of output pixels and 32 output channels; each of its 128 threads owns
// one 2x2 quad of pixels (so a fused 2x2 max stays in the thread) and 4
// channels: 16 int64 accumulators. The K loop walks chunks of input
// channels: the chunk's halo tile of codes is staged in shared memory with
// Mul_prev applied once per staged code (a * m, int64), and its weights
// beside it (kind 0: per tap and channel the chunk's sign bits as one mask;
// kinds 1 and 2: the int64 weights). A sign is a select between +v and -v,
// no multiplier. The epilogue runs per pixel, then the max over the quad:
// the epilogue is monotone in acc (mult >= 0), but the max is taken over the
// codes, so the fused pool equals pooling afterwards by construction.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 8;                // output pixels per side of a block
constexpr int kQuads = kTile / 2;       // quads per side
constexpr int kCoT = 32;                // output channels per block
constexpr int kNc = 4;                  // output channels per thread
constexpr int kThreads = kQuads * kQuads * (kCoT / kNc);  // 128

// Input channels staged per chunk: a sign mask holds 16; conv1 has 3 input
// channels and nine taps of dense int64 weights.
template <int KIND>
constexpr int kChunk = KIND == 1 ? 4 : 16;

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

// numpy's sign(x) * ((abs(x) + half) >> s), int64 throughout: abs wraps at
// INT64_MIN and >> is arithmetic, as numpy's are. 0 <= s <= 62.
__device__ __forceinline__ int64_t rshift_round(int64_t x, int s) {
  const int64_t half = s > 0 ? (int64_t{1} << (s - 1)) : 0;
  const int64_t mag = wrap_add(x < 0 ? wrap_neg(x) : x, half);
  const int64_t r = mag >> s;
  return x < 0 ? wrap_neg(r) : (x > 0 ? r : 0);
}

template <int KIND>
__device__ __forceinline__ int64_t epilogue(int64_t acc, int64_t mult,
                                            int64_t bias, int shift) {
  if constexpr (KIND == 2) return wrap_add(rshift_round(acc, shift), bias);
  int64_t p;
  if constexpr (KIND == 1) {
    const int64_t t = wrap_add(acc, bias);
    p = wrap_mul(t > 0 ? t : 0, mult);
  } else {
    p = wrap_add(wrap_mul(acc, mult), bias);
  }
  const int64_t q = rshift_round(p, shift);
  return q < 0 ? 0 : (q > 255 ? 255 : q);
}

// x (b, h, w, cin) uint8 codes; m (cin,) int64 or null (1); kind 0: wbits
// (ceil(ks * ks * cin / 32), cout) sign words, LSB first along K; kinds 1
// (ks 3) and 2 (ks 1): wdense (ks * ks * cin, cout) int64. mult, bias
// (cout,) int64 (mult null: 1); shift (cout,) int64 or null (every channel
// shift_all).
// out (b, h, w, cout), or (b, h / 2, w / 2, cout) pooled: uint8 codes for
// kinds 0 and 1, int64 for kind 2. Grid (tiles_y * tiles_x, ceil(cout /
// 32), b).
template <int KIND, int KS, bool POOL>
__global__ void __launch_bounds__(kThreads)
int_pe_kernel(const uint8_t* __restrict__ x, const int64_t* __restrict__ m,
              const uint32_t* __restrict__ wbits,
              const int64_t* __restrict__ wdense,
              const int64_t* __restrict__ mult,
              const int64_t* __restrict__ bias,
              const int64_t* __restrict__ shift, int shift_all,
              void* __restrict__ out, int h, int w, int cin, int cout) {
  constexpr int kCc = kChunk<KIND>;
  constexpr int kTaps = KS * KS;
  constexpr int kPad = KS / 2;
  constexpr int kSpan = kTile + KS - 1;   // staged pixels per side
  __shared__ int64_t act[kCc][kSpan][kSpan];
  // kind 0: per tap and output channel the chunk's sign bits; kinds 1, 2:
  // per tap, input channel and output channel the weight
  __shared__ uint32_t mask[KIND == 0 ? kTaps : 1][kCoT];
  __shared__ int64_t dense[KIND == 0 ? 1 : kTaps][KIND == 0 ? 1 : kCc]
                          [kCoT];

  const int tiles_x = (w + kTile - 1) / kTile;
  const int y0 = (blockIdx.x / tiles_x) * kTile;
  const int x0 = (blockIdx.x % tiles_x) * kTile;
  const int n0 = blockIdx.y * kCoT;
  const int b = blockIdx.z;
  const int quad = threadIdx.x % (kQuads * kQuads);
  const int qy = quad / kQuads, qx = quad % kQuads;
  const int nl = (threadIdx.x / (kQuads * kQuads)) * kNc;  // first channel
  const int n_words = (kTaps * cin + 31) / 32;

  int64_t acc[4][kNc];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int j = 0; j < kNc; ++j) acc[p][j] = 0;

  for (int c0 = 0; c0 < cin; c0 += kCc) {
    __syncthreads();  // the previous chunk's readers are done
    // codes times Mul_prev, once per staged code; 0 outside the image and
    // past cin (SAME zero padding, the ragged last chunk)
    for (int i = threadIdx.x; i < kCc * kSpan * kSpan; i += kThreads) {
      const int c = i % kCc, pix = i / kCc;
      const int py = pix / kSpan, px = pix % kSpan;
      const int gy = y0 + py - kPad, gx = x0 + px - kPad;
      int64_t v = 0;
      if (gy >= 0 && gy < h && gx >= 0 && gx < w && c0 + c < cin) {
        v = x[((static_cast<int64_t>(b) * h + gy) * w + gx) * cin + c0 + c];
        if (m != nullptr) v = wrap_mul(v, m[c0 + c]);
      }
      act[c][py][px] = v;
    }
    if constexpr (KIND == 0) {
      // bits k .. k + kCc - 1 of column n, k = tap * cin + c0; bits past
      // cin meet staged zeros, columns past cout are never stored
      for (int i = threadIdx.x; i < kTaps * kCoT; i += kThreads) {
        const int tap = i / kCoT, col = i % kCoT, n = n0 + col;
        uint32_t bits = 0;
        if (n < cout) {
          const int k = tap * cin + c0, word = k / 32;
          uint64_t pair = wbits[static_cast<int64_t>(word) * cout + n];
          if (word + 1 < n_words) {
            pair |= static_cast<uint64_t>(
                        wbits[static_cast<int64_t>(word + 1) * cout + n])
                    << 32;
          }
          bits = static_cast<uint32_t>(pair >> (k % 32)) &
                 ((1u << kCc) - 1u);
        }
        mask[tap][col] = bits;
      }
    } else {
      for (int i = threadIdx.x; i < kTaps * kCc * kCoT; i += kThreads) {
        const int col = i % kCoT, c = (i / kCoT) % kCc, tap = i / (kCoT * kCc);
        const int n = n0 + col;
        dense[tap][c][col] =
            (n < cout && c0 + c < cin)
                ? wdense[static_cast<int64_t>(tap * cin + c0 + c) * cout + n]
                : 0;
      }
    }
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < kTaps; ++tap) {
      const int dy = tap / KS, dx = tap % KS;
      uint32_t bits[kNc] = {};
      if constexpr (KIND == 0) {
#pragma unroll
        for (int j = 0; j < kNc; ++j) bits[j] = mask[tap][nl + j];
      }
#pragma unroll
      for (int c = 0; c < kCc; ++c) {
        int64_t v[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          v[p] = act[c][2 * qy + p / 2 + dy][2 * qx + p % 2 + dx];
        }
        if constexpr (KIND == 0) {
          int64_t nv[4];
#pragma unroll
          for (int p = 0; p < 4; ++p) nv[p] = wrap_neg(v[p]);
#pragma unroll
          for (int j = 0; j < kNc; ++j) {
            const bool plus = (bits[j] >> c) & 1u;
#pragma unroll
            for (int p = 0; p < 4; ++p) {
              acc[p][j] = wrap_add(acc[p][j], plus ? v[p] : nv[p]);
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < kNc; ++j) {
            const int64_t wv = dense[tap][c][nl + j];
#pragma unroll
            for (int p = 0; p < 4; ++p) {
              acc[p][j] = wrap_add(acc[p][j], wrap_mul(v[p], wv));
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kNc; ++j) {
    const int n = n0 + nl + j;
    if (n >= cout) continue;
    const int64_t mu = mult != nullptr ? mult[n] : 1;
    const int64_t bs = bias[n];
    const int s = shift != nullptr ? static_cast<int>(shift[n]) : shift_all;
    if (POOL) {
      const int oy = y0 / 2 + qy, ox = x0 / 2 + qx;
      if (oy >= h / 2 || ox >= w / 2) continue;
      int64_t q = 0;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int64_t e = epilogue<KIND>(acc[p][j], mu, bs, s);
        q = e > q ? e : q;
      }
      static_cast<uint8_t*>(out)[((static_cast<int64_t>(b) * (h / 2) + oy) *
                                      (w / 2) + ox) * cout + n] =
          static_cast<uint8_t>(q);
    } else {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int oy = y0 + 2 * qy + p / 2, ox = x0 + 2 * qx + p % 2;
        if (oy >= h || ox >= w) continue;
        const int64_t at = ((static_cast<int64_t>(b) * h + oy) * w + ox) *
                           cout + n;
        const int64_t e = epilogue<KIND>(acc[p][j], mu, bs, s);
        if constexpr (KIND == 2) {
          static_cast<int64_t*>(out)[at] = e;
        } else {
          static_cast<uint8_t*>(out)[at] = static_cast<uint8_t>(e);
        }
      }
    }
  }
}

template <int KIND, int KS, bool POOL>
int launch(const void* x, const void* m, const void* w, const void* mult,
           const void* bias, const void* shift, int shift_all, void* out,
           int b, int h, int wd, int cin, int cout, cudaStream_t stream) {
  const dim3 grid(((h + kTile - 1) / kTile) * ((wd + kTile - 1) / kTile),
                  (cout + kCoT - 1) / kCoT, b);
  int_pe_kernel<KIND, KS, POOL><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(x), static_cast<const int64_t*>(m),
      KIND == 0 ? static_cast<const uint32_t*>(w) : nullptr,
      KIND == 0 ? nullptr : static_cast<const int64_t*>(w),
      static_cast<const int64_t*>(mult), static_cast<const int64_t*>(bias),
      static_cast<const int64_t*>(shift), shift_all, out, h, wd, cin, cout);
  return static_cast<int>(cudaGetLastError());
}

template <int KIND>
int launch_kind(int ksize, int pool, const void* x, const void* m,
                const void* w, const void* mult, const void* bias,
                const void* shift, int shift_all, void* out, int b, int h,
                int wd, int cin, int cout, cudaStream_t stream) {
  if (ksize == 3 && pool) {
    return launch<KIND, 3, true>(x, m, w, mult, bias, shift, shift_all, out,
                                 b, h, wd, cin, cout, stream);
  }
  if (ksize == 3) {
    return launch<KIND, 3, false>(x, m, w, mult, bias, shift, shift_all, out,
                                  b, h, wd, cin, cout, stream);
  }
  if constexpr (KIND == 0) {
    if (pool) {
      return launch<KIND, 1, true>(x, m, w, mult, bias, shift, shift_all,
                                   out, b, h, wd, cin, cout, stream);
    }
    return launch<KIND, 1, false>(x, m, w, mult, bias, shift, shift_all, out,
                                  b, h, wd, cin, cout, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// One layer of the integer datapath; see the note at the top for `kind`
// and the operands. [shift_lo, shift_hi] is the range of the shifts the
// launch reads (shift_all's when `shift` is null); a range outside [0, 62],
// a ksize other than 1 or 3 (kind 0), 3 (kind 1) or 1 (kind 2), a pool on
// the head or on an odd plane, or an empty shape is refused with
// cudaErrorInvalidValue. Returns
// cudaGetLastError() otherwise.
int w1a8_int_pe(int kind, int ksize, int pool, const void* x, const void* m,
                const void* w, const void* mult, const void* bias,
                const void* shift, int shift_all, int shift_lo, int shift_hi,
                void* out, int b, int h, int wd, int cin, int cout,
                void* stream) {
  const bool ok = (kind == 0 ? ksize == 1 || ksize == 3
                              : ksize == (kind == 1 ? 3 : 1)) &&
                  kind >= 0 && kind <= 2 &&
                  shift_lo >= 0 && shift_hi <= 62 && shift_lo <= shift_hi &&
                  (shift != nullptr || shift_lo == shift_all) &&
                  (shift != nullptr || shift_hi == shift_all) &&
                  !(pool && (kind == 2 || h % 2 || wd % 2)) && b > 0 &&
                  h > 0 && wd > 0 && cin > 0 && cout > 0 && b <= 65535 &&
                  x != nullptr && w != nullptr && bias != nullptr &&
                  out != nullptr && (kind == 2 || mult != nullptr);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (kind == 0) {
    return launch_kind<0>(ksize, pool, x, m, w, mult, bias, shift, shift_all,
                          out, b, h, wd, cin, cout, st);
  }
  if (kind == 1) {
    return launch_kind<1>(ksize, pool, x, m, w, mult, bias, shift, shift_all,
                          out, b, h, wd, cin, cout, st);
  }
  return launch<2, 1, false>(x, m, w, mult, bias, shift, shift_all, out, b, h,
                             wd, cin, cout, st);
}

}  // extern "C"
