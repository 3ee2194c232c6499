// Arithmetic shared by the W1A8 CUDA kernels: the bf16 Mul_prev prologue,
// the Div/bias/requant epilogue, and the tiles on the tensor cores: the 3x3
// conv tiles and the matmul tiles, each in a bf16 dot form (mma.sync
// m16n8k16, f32 accumulation) and an exact int8 popcount form (mma.sync
// m16n8k32, u8 codes times s8 signs, s32 accumulation).
//
// Both dot conv kernels (w1a8_conv3x3.cu, w1a8_conv3x3_pool2.cu) take
// every accumulator from `conv3x3_mma_tile`, and both popcount conv kernels
// (w1a8_conv3x3_popcount.cu, w1a8_conv3x3_pool2_popcount.cu) from
// `conv3x3_imma_tile`; the four write their outputs through
// `store_conv_tile` or `store_pool_tile`. So each fused conv+pool kernel
// equals its conv kernel followed by a 2x2 max bit for bit. The dot matmul
// (w1a8_matmul.cu) takes its accumulators from `matmul_mma_tile`, the
// popcount matmul (w1a8_matmul_popcount.cu) and the int matmul
// (w1a8_matmul_int.cu) from `matmul_imma_tile`, all on operands that
// `load_span` brings from device memory straight into registers; the dot
// and popcount matmuls store through `store_tile`, as `store_conv_tile`
// does, the int matmul its sums as they are through `store_int_tile`.
//
// Every rounding is spelled out (__fmul_rn, __fadd_rn, __fdiv_rn): nvcc
// would otherwise contract `acc * div + bias` into one FMA, while the
// reference rounds the product and the sum separately. Build without
// --use_fast_math, which would replace the IEEE division of the requant.
//
// The tiles' PTX (ldmatrix, mma.sync, cp.async) sits in small functions,
// `ldmatrix_x4`, `mma_bf16_16816`, `mma_u8s8_16832`, `mma_u8u8_16832`,
// `cp_async_16`, `cp_async_wait_all`, `cp_async_lane`, `cp_async_commit`
// and `cp_async_wait`, so that a host emulation of the warp can stand in
// for them.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace w1a8 {

constexpr int kPack = 32;  // sign bits per 32-bit word, LSB first

// trunc(x + (x >= 0 ? 0.5 : -0.5)) with the add rounded in f32.
__device__ __forceinline__ float round_half_away(float x) {
  return truncf(__fadd_rn(x, x >= 0.f ? 0.5f : -0.5f));
}

// y = acc * div + bias (two roundings); with `quant`, the uint8 code
// clip(round_half_away(y / out_step), 0, 255) as a float.
__device__ __forceinline__ float epilogue(float acc, float div, float bias,
                                          bool quant, float out_step) {
  const float y = __fadd_rn(__fmul_rn(acc, div), bias);
  if (!quant) return y;
  const float q = round_half_away(__fdiv_rn(y, out_step));
  return fminf(fmaxf(q, 0.f), 255.f);
}

// Stages the sign words of output channels [co0, co0 + ct) as (n_words +
// n_pad, ct): columns past cout and the n_pad rows after the last word
// hold 0.
__device__ __forceinline__ void stage_words(const uint32_t* __restrict__ w,
                                            uint32_t* wsm, int n_words,
                                            int cout, int co0, int ct,
                                            int n_pad = 0) {
  for (int i = threadIdx.x; i < (n_words + n_pad) * ct; i += blockDim.x) {
    const int j = i / ct;
    const int co = co0 + i % ct;
    wsm[i] = j < n_words && co < cout ? w[static_cast<size_t>(j) * cout + co]
                                      : 0u;
  }
}

// ---------------------------------------------------------------------------
// Dot route: the 3x3 conv as an implicit GEMM on the tensor cores.
//
// M is conv outputs (pixels), N output channels, K = 9 * cin in the
// reference's im2col order k = (dy * 3 + dx) * cin + ci. The activations
// sit in shared memory as bf16(code * Mul_prev): each staged pixel holds
// padded_cin(cin) channels (zeros past cin) and 16 spare bytes, so that the
// eight row addresses of an ldmatrix fall on eight different 16-byte bank
// groups. One mma.sync.m16n8k16 takes a 16-wide K chunk of one tap: its A
// rows are 16 pixels' 16 channels, read straight from the staged strip by
// ldmatrix; its B column is 16 sign bits of one output channel, turned
// into +-1 bf16 in registers. Pad channels have A = 0 and add exactly 0
// whatever their bits say. A product of a bf16 prologue value and +-1 is
// exact, so only the order of the f32 sums differs from the reference's.
// ---------------------------------------------------------------------------

constexpr int kChunk = 16;     // K per mma.sync
constexpr int kPixPad = 8;     // spare bf16 after each staged pixel

__host__ __device__ constexpr int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

__host__ __device__ constexpr int padded_cin(int cin) {
  return ceil_div(cin, kChunk) * kChunk;
}

// bf16 elements from one staged pixel to the next.
__host__ __device__ constexpr int pixel_stride(int cin) {
  return padded_cin(cin) + kPixPad;
}

__host__ __device__ constexpr int words_of(int k) { return ceil_div(k, kPack); }

// Dynamic shared memory of a dot conv block: its sign words,
// (words_of(9 * cin) + 1, bn), then `staged_rows` rows of `row_px` staged
// pixels (kernels/w1a8_conv/geometry.py computes the same).
__host__ __device__ constexpr size_t dot_conv_smem(int cin, int bn,
                                                   int staged_rows,
                                                   int row_px) {
  return (sizeof(uint32_t) * (words_of(9 * cin) + 1) * bn + 15) / 16 * 16 +
         sizeof(__nv_bfloat16) * staged_rows * row_px * pixel_stride(cin);
}

// Loads the four 8-row x 16-byte matrices of an A fragment (16x16 bf16 or
// 16x32 int8, whose register layouts agree byte for byte); `p` is this
// lane's row address: row lane % 16, bytes 16 * (lane / 16) on.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a * b on one 16x8x16 tile: bf16 operands, f32 accumulation.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two +-1 bf16 values in one register from bits 0 and 1 of `bits` (1 <=>
// +1), bit 0's value in the low half: 0x3F80 is bf16 1.0, bit 15 its sign.
__device__ __forceinline__ uint32_t sign_pair(uint32_t bits) {
  const uint32_t neg = ~bits;
  return 0x3F803F80u | ((neg & 1u) << 15) | ((neg & 2u) << 30);
}

// Accumulates WM M tiles of 16 conv outputs against WN N tiles of 8
// output channels over the whole 3x3 window: acc[mt][nt] is the m16n8
// accumulator fragment of M tile mt and channels col0 + 8 * nt on.
//
// act:   staged prologue values; a_off[mt] is the offset of this lane's
//        ldmatrix row in M tile mt: its output's window corner (dy = dx =
//        0) plus 8 * (lane / 16) channels.
// row_stride, pix_stride: staged elements per row and per pixel.
// wsm:   sign words (words_of(9 * cin) + 1, ldw), the last row zero.
//
// The K chunks run tap by tap and channel chunk by channel chunk, the same
// for every output, and mma computes each output from its own A row and B
// column only: an output's value depends neither on the M row or the tile
// it lands in nor on the kernel that asks for it.
template <int WM, int WN>
__device__ __forceinline__ void conv3x3_mma_tile(
    const __nv_bfloat16* act, const int (&a_off)[WM], int row_stride,
    int pix_stride, int cin, const uint32_t* wsm, int ldw, int col0,
    float (&acc)[WM][WN][4]) {
  const int lane = threadIdx.x & 31;
  const int t2 = 2 * (lane & 3);
  const uint32_t* wcol = wsm + col0 + (lane >> 2);
  const int chunks = padded_cin(cin) / kChunk;
#pragma unroll
  for (int mt = 0; mt < WM; ++mt) {
#pragma unroll
    for (int nt = 0; nt < WN; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
    }
  }
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const __nv_bfloat16* at =
        act + (tap / 3) * row_stride + (tap % 3) * pix_stride;
    int k0 = tap * cin;
    for (int c = 0; c < chunks; ++c, k0 += kChunk, at += kChunk) {
      // sign bits k0 .. k0 + 15 of this chunk, which start at any bit of a
      // word when cin % 16 != 0; this lane needs k0 + t2 + {0, 1, 8, 9}
      const uint32_t* wj = wcol + (k0 / kPack) * ldw;
      uint32_t b[WN][2];
#pragma unroll
      for (int nt = 0; nt < WN; ++nt) {
        const uint32_t bits =
            __funnelshift_r(wj[8 * nt], wj[ldw + 8 * nt], k0 & (kPack - 1));
        b[nt][0] = sign_pair(bits >> t2);
        b[nt][1] = sign_pair(bits >> (t2 + 8));
      }
#pragma unroll
      for (int mt = 0; mt < WM; ++mt) {
        uint32_t a[4];
        ldmatrix_x4(a, at + a_off[mt]);
#pragma unroll
        for (int nt = 0; nt < WN; ++nt) mma_bf16_16816(acc[mt][nt], a, b[nt]);
      }
    }
  }
}

// Copies 16 bytes from global to shared memory without waiting; with
// src_bytes = 0 it writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(d), "l"(src), "r"(src_bytes));
}

// Waits for every cp_async_16 this thread issued.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// A lane's own copy pipeline (the popcount matmul's decode tile): copies
// kBytes (4, 8 or 16) from global to shared memory through L1 without
// waiting, the first src_bytes of them read and the rest zero, ordered
// with this thread's other shared memory accesses; `cp_async_commit`
// closes a group of them and `cp_async_wait<N>` waits until at most N of
// this thread's groups are in flight.
template <int kBytes>
__device__ __forceinline__ void cp_async_lane(void* dst, const void* src,
                                              int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %3, %2;\n"
               :
               : "r"(d), "l"(src), "r"(src_bytes), "n"(kBytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// stage_words(w, wsm, n_words, cout, co0, ct, 1) for the dot conv kernels:
// with cout % 4 == 0 and `w` 16-byte aligned, 16 bytes at a time, all in
// flight together (cp_async_wait_all before reading them).
__device__ __forceinline__ void stage_conv_words(
    const uint32_t* __restrict__ w, uint32_t* wsm, int n_words, int cout,
    int co0, int ct) {
  if (cout % 4 || (reinterpret_cast<uintptr_t>(w) & 15)) {
    stage_words(w, wsm, n_words, cout, co0, ct, 1);
    return;
  }
  const int q = ct / 4;
  for (int i = threadIdx.x; i < (n_words + 1) * q; i += blockDim.x) {
    const int j = i / q;
    const int co = co0 + 4 * (i - j * q);
    const bool in = j < n_words && co < cout;
    cp_async_16(wsm + 4 * i, in ? w + static_cast<size_t>(j) * cout + co : w,
                in ? 16 : 0);
  }
}

// Two bf16 values in one register, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return static_cast<uint32_t>(__bfloat16_as_ushort(p.x)) |
         static_cast<uint32_t>(__bfloat16_as_ushort(p.y)) << 16;
}

// Stages `n_rows` zero-padded input rows, starting at input row `r0` (which
// may be -1), as prologue values bf16(code * Mul_prev). Staged pixel s of a
// row is input column s - 1; pixels 0 and width + 1, rows outside the image
// and channels past cin hold 0. A row holds row_px >= width + 2 pixels of
// pixel_stride(cin) elements; the spare ones are never read. `a_img` is
// one image, (h, width, cin) uint8.
//
// A unit is 16 channels of one pixel. A thread issues the loads of kBatch
// units (one 16-byte load each when cin % 16 == 0 and `a_img` is 16-byte
// aligned) before it converts any, so that a strip's loads are in flight
// together; when blockDim.x % chunks == 0 all its units share one channel
// chunk, whose 16 Mul_prev values it keeps in registers.
constexpr int kBatch = 4;

__device__ __forceinline__ void stage_act(const uint8_t* __restrict__ a_img,
                                          const float* __restrict__ mul,
                                          __nv_bfloat16* act, int r0,
                                          int n_rows, int h, int width,
                                          int cin, int row_px) {
  const int chunks = padded_cin(cin) / kChunk;
  const int ps = pixel_stride(cin);
  const int units = n_rows * (width + 2) * chunks;
  const bool vec = cin % kChunk == 0 &&
                   (reinterpret_cast<uintptr_t>(a_img) & 15) == 0;
  const bool fixed = blockDim.x % chunks == 0;
  float m[kChunk];
  for (int i0 = threadIdx.x; i0 < units; i0 += kBatch * blockDim.x) {
    uint32_t v[kBatch][4];
    int src[kBatch], dst[kBatch], chunk[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * blockDim.x;
      const int pix = i / chunks;
      const int c = i - pix * chunks;
      const int rr = pix / (width + 2);
      const int s = pix - rr * (width + 2);
      const int r = r0 + rr;
      const bool inside = i < units && r >= 0 && r < h && s >= 1 &&
                          s <= width;
      chunk[u] = c;
      dst[u] = i < units ? (rr * row_px + s) * ps + c * kChunk : -1;
      src[u] = inside ? (r * width + s - 1) * cin + c * kChunk : -1;
      v[u][0] = v[u][1] = v[u][2] = v[u][3] = 0u;
      if (vec && src[u] >= 0) {
        const uint4 q = *reinterpret_cast<const uint4*>(a_img + src[u]);
        v[u][0] = q.x;
        v[u][1] = q.y;
        v[u][2] = q.z;
        v[u][3] = q.w;
      }
    }
    if (fixed && i0 == threadIdx.x) {
      // after the first batch's loads are issued, so both are in flight
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int ci = chunk[0] * kChunk + j;
        m[j] = ci < cin ? __ldg(mul + ci) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (dst[u] < 0) break;
      const int c = chunk[u];
      if (!vec && src[u] >= 0) {
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          if (c * kChunk + j < cin) {
            v[u][j / 4] |= static_cast<uint32_t>(a_img[src[u] + j])
                           << (8 * (j % 4));
          }
        }
      }
      if (!fixed) {
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          const int ci = c * kChunk + j;
          m[j] = ci < cin ? __ldg(mul + ci) : 0.f;
        }
      }
      uint32_t packed[kChunk / 2];
#pragma unroll
      for (int j = 0; j < kChunk / 2; ++j) {
        const uint32_t two = v[u][j / 2] >> (16 * (j & 1));
        packed[j] = pack_bf16x2(
            __fmul_rn(static_cast<float>(two & 0xffu), m[2 * j]),
            __fmul_rn(static_cast<float>((two >> 8) & 0xffu), m[2 * j + 1]));
      }
      uint4* out = reinterpret_cast<uint4*>(act + dst[u]);
      out[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
      out[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
    }
  }
}

// ---------------------------------------------------------------------------
// Popcount route: the 3x3 conv's exact int32 sum sum_k s_k * a_k as an
// implicit GEMM on the int8 tensor cores.
//
// M, N and the im2col order of K are the dot route's. The codes sit in
// shared memory raw: a staged pixel holds code_units(cin) units of 16
// channels (zeros past cin) and, where that count is even, one spare unit,
// so that a pixel spans an odd number of 16-byte units and the eight row
// addresses of an ldmatrix fall on eight different bank groups, as for the
// dot route. One mma.sync.m16n8k32 (u8 codes, s8 signs, s32 accumulate)
// takes a pair of units, 2j and 2j + 1, in the order (tap, unit) of the
// window, so a pair spans two taps where a pixel has an odd number of
// units (cin = 16: two taps a pair). Its A rows are 16 pixels' codes:
// lanes 0-15 post the row addresses of unit 2j, lanes 16-31 those of unit
// 2j + 1, and ldmatrix loads them unchanged. Its B column is the 32 sign
// bits of the pair (`stage_pair_words`), turned into +-1 bytes in
// registers. Pad channels have code 0 and add exactly 0 whatever their
// bits say; an odd last unit is paired with B = 0. The products are exact
// integers and |acc| <= 255 * 9 * cin < 2^24, so the sum is the one the
// bit-plane popcount forms, and its float conversion is exact.
// ---------------------------------------------------------------------------

// 16-channel units a staged pixel holds, and its bytes (an odd number of
// 16-byte units).
__host__ __device__ constexpr int code_units(int cin) {
  return ceil_div(cin, kChunk);
}

__host__ __device__ constexpr int code_stride(int cin) {
  return kChunk * (code_units(cin) | 1);
}

// Sign words of the pairs of units, one 32-bit word per pair: bits 0-15
// are the signs of unit 2j's 16 channels, bits 16-31 those of unit 2j + 1.
__host__ __device__ constexpr int pair_words(int cin) {
  return ceil_div(9 * code_units(cin), 2);
}

// Dynamic shared memory of a popcount conv block: its pair words,
// (pair_words(cin) + 1, bn), the byte offsets of the window's units,
// (2 * pair_words(cin),) ints, then `staged_rows` rows of `row_px` staged
// pixels (kernels/w1a8_conv/geometry.py computes the same).
__host__ __device__ constexpr size_t popcount_conv_smem(int cin, int bn,
                                                        int staged_rows,
                                                        int row_px) {
  return (sizeof(uint32_t) * (pair_words(cin) + 1) * bn + 15) / 16 * 16 +
         (sizeof(int) * 2 * pair_words(cin) + 15) / 16 * 16 +
         static_cast<size_t>(staged_rows) * row_px * code_stride(cin);
}

// d += a * b on one 16x8x32 tile: u8 A, s8 B, s32 accumulation (exact: no
// sum here comes near the int32 range).
__device__ __forceinline__ void mma_u8s8_16832(int (&d)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b on one 16x8x32 tile: u8 A, u8 B, s32 accumulation (the
// popcount matmul's decode tile: 0/128 sign bytes against codes).
__device__ __forceinline__ void mma_u8u8_16832(int (&d)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four s8 values in one register from bits 0-3 of `bits`, bit i's value in
// byte i: +1 (0x01) where the bit is 1, -1 (0xFF) where it is 0. The
// multiply spreads the four bits to bit 0 of the four bytes; t * 0xFE then
// holds 0xFE or 0 in each byte, with no carry, and its complement 0x01 or
// 0xFF.
__device__ __forceinline__ uint32_t sign_bytes(uint32_t bits) {
  const uint32_t t = ((bits & 0xFu) * 0x00204081u) & 0x01010101u;
  return ~(t * 0xFEu);
}

// Accumulates WM M tiles of 16 conv outputs against WN N tiles of 8 output
// channels over the whole 3x3 window, exactly: acc[mt][nt] is the m16n8
// accumulator fragment of M tile mt and channels col0 + 8 * nt on.
//
// act:   staged codes; a_off[mt] is the byte offset of this lane's
//        ldmatrix row in M tile mt: its output's window corner.
// uoff:  byte offset of unit u of the window from the corner,
//        (2 * pair_words(cin),), the entry past an odd last unit 0.
// units: 9 * code_units(cin).
// wsm:   pair words (pair_words(cin), ldw).
//
// The pairs run in one order for every output, and mma computes each
// output from its own A row and B column only, as in conv3x3_mma_tile.
template <int WM, int WN>
__device__ __forceinline__ void conv3x3_imma_tile(
    const uint8_t* act, const int (&a_off)[WM], const int* uoff, int units,
    const uint32_t* wsm, int ldw, int col0, int (&acc)[WM][WN][4]) {
  const int lane = threadIdx.x & 31;
  const int t4 = 4 * (lane & 3);
  const int hi = lane >> 4;
  const uint32_t* wcol = wsm + col0 + (lane >> 2);
#pragma unroll
  for (int mt = 0; mt < WM; ++mt) {
#pragma unroll
    for (int nt = 0; nt < WN; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;
    }
  }
  for (int u = 0; u < units; u += 2) {
    const uint8_t* at = act + uoff[u + hi];
    // B rows k = t4 + {0..3} from unit u, k = 16 + t4 + {0..3} from unit
    // u + 1, which past the last unit adds 0
    const uint32_t keep = u + 1 < units ? ~0u : 0u;
    const uint32_t* wj = wcol + (u >> 1) * ldw;
    uint32_t b[WN][2];
#pragma unroll
    for (int nt = 0; nt < WN; ++nt) {
      const uint32_t bits = wj[8 * nt] >> t4;
      b[nt][0] = sign_bytes(bits);
      b[nt][1] = sign_bytes(bits >> 16) & keep;
    }
#pragma unroll
    for (int mt = 0; mt < WM; ++mt) {
      uint32_t a[4];
      ldmatrix_x4(a, at + a_off[mt]);
#pragma unroll
      for (int nt = 0; nt < WN; ++nt) mma_u8s8_16832(acc[mt][nt], a, b[nt]);
    }
  }
}

// Stages `n_rows` zero-padded input rows of raw codes, starting at input
// row `r0` (which may be -1): staged pixel s of a row is input column
// s - 1; pixels 0 and width + 1, rows outside the image and channels past
// cin hold 0. A row holds row_px >= width + 2 pixels of code_stride(cin)
// bytes; the spare ones, and a pixel's spare unit, are never read. `a_img`
// is one image, (h, width, cin) uint8. With cin % 16 == 0 and `a_img`
// 16-byte aligned each 16-channel unit is one cp_async_16, all in flight
// together (cp_async_wait_all before reading them); otherwise it is
// gathered byte by byte.
__device__ __forceinline__ void stage_raw_codes(
    const uint8_t* __restrict__ a_img, uint8_t* act, int r0, int n_rows,
    int h, int width, int cin, int row_px) {
  const int cu = code_units(cin);
  const int ps = code_stride(cin);
  const int total = n_rows * (width + 2) * cu;
  const bool vec = cin % kChunk == 0 &&
                   (reinterpret_cast<uintptr_t>(a_img) & 15) == 0;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int pix = i / cu;
    const int c = i - pix * cu;
    const int rr = pix / (width + 2);
    const int s = pix - rr * (width + 2);
    const int r = r0 + rr;
    const bool inside = r >= 0 && r < h && s >= 1 && s <= width;
    uint8_t* dst = act + (rr * row_px + s) * ps + c * kChunk;
    const uint8_t* src =
        inside ? a_img + (static_cast<size_t>(r) * width + s - 1) * cin +
                     c * kChunk
               : a_img;
    if (vec) {
      cp_async_16(dst, src, inside ? 16 : 0);
      continue;
    }
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    if (inside) {
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (c * kChunk + j < cin) {
          v[j / 4] |= static_cast<uint32_t>(src[j]) << (8 * (j % 4));
        }
      }
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// Stages the pair words of output channels [co0, co0 + ct) as
// (pair_words(cin) + 1, ct), from the sign words w (words_of(9 * cin),
// cout); columns past cout and the last row hold 0. Unit u = (tap, c)
// holds the signs of k = tap * cin + 16 * c on. With cin % 16 == 0 unit u
// starts at bit 16 * u, so pair word j is sign word j and the words are
// staged as for the dot route; otherwise each unit's 16 bits are cut from
// the words (the bits past cin belong to the next tap, and meet zero
// codes).
__device__ __forceinline__ void stage_pair_words(
    const uint32_t* __restrict__ w, uint32_t* wsm, int cin, int cout,
    int co0, int ct) {
  const int n_words = words_of(9 * cin);
  if (cin % kChunk == 0) {
    stage_conv_words(w, wsm, n_words, cout, co0, ct);
    return;
  }
  const int cu = code_units(cin);
  const int units = 9 * cu;
  const int pairs = pair_words(cin);
  for (int i = threadIdx.x; i < (pairs + 1) * ct; i += blockDim.x) {
    const int j = i / ct;
    const int co = co0 + i % ct;
    uint32_t v = 0u;
    for (int half = 0; half < 2 && j < pairs && co < cout; ++half) {
      const int u = 2 * j + half;
      if (u >= units) break;
      const int tap = u / cu;
      const int k = tap * cin + (u - tap * cu) * kChunk;
      const int q = k / kPack;
      const uint32_t lo = w[static_cast<size_t>(q) * cout + co];
      const uint32_t up =
          q + 1 < n_words ? w[static_cast<size_t>(q + 1) * cout + co] : 0u;
      v |= (__funnelshift_r(lo, up, k & (kPack - 1)) & 0xFFFFu)
           << (16 * half);
    }
    wsm[i] = v;
  }
}

// Fills uoff (2 * pair_words(cin),) for conv3x3_imma_tile: unit u = (tap,
// c) of the window lies tap / 3 staged rows and tap % 3 staged pixels from
// the corner, c units into the pixel.
__device__ __forceinline__ void stage_unit_offsets(int* uoff, int cin,
                                                   int row_stride) {
  const int cu = code_units(cin);
  for (int u = threadIdx.x; u < 2 * pair_words(cin); u += blockDim.x) {
    const int tap = u / cu;
    uoff[u] = tap < 9 ? (tap / 3) * row_stride +
                            (tap % 3) * code_stride(cin) +
                            (u - tap * cu) * kChunk
                      : 0;
  }
}

// ---------------------------------------------------------------------------
// Epilogues of the four conv kernels, on the m16n8 accumulator fragments of
// one warp item (f32 sums on the dot route, exact int32 on the popcount
// one): this lane holds rows g and g + 8 of each M tile and columns t2 and
// t2 + 1 of each 8-wide N tile.
// ---------------------------------------------------------------------------

// Div and bias of this lane's columns of the item whose first channel is
// co_base; 0 past cout.
template <int WN>
__device__ __forceinline__ void lane_constants(const float* __restrict__ div,
                                               const float* __restrict__ bias,
                                               int co_base, int cout,
                                               float (&dv)[WN][2],
                                               float (&bs)[WN][2]) {
  const int t2 = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int nt = 0; nt < WN; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int co = co_base + 8 * nt + t2 + e;
      dv[nt][e] = co < cout ? __ldg(div + co) : 0.f;
      bs[nt][e] = co < cout ? __ldg(bias + co) : 0.f;
    }
  }
}

// Stores one warp item's accumulators through the epilogue into the
// row-major (rows, ld) output `out`: M row i of the item's block is output
// row row0 + i, and columns run from co_base; rows from m_blk on and
// columns from ld on are not stored. dv and bs are the item's
// lane_constants. With KQ > 1 (the matmuls' kSplit) only the fragment
// elements 2 * half + e that are part modulo KQ are stored (reduce_split).
template <int WM, int WN, int KQ = 1, typename Acc>
__device__ __forceinline__ void store_tile(
    const Acc (&acc)[WM][WN][4], const float (&dv)[WN][2],
    const float (&bs)[WN][2], void* __restrict__ out, size_t row0, int m0,
    int m_blk, int ld, int co_base, float out_step, int quant,
    int part = 0) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t2 = 2 * (lane & 3);
#pragma unroll
  for (int mt = 0; mt < WM; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = m0 + mt * 16 + g + 8 * half;
      if (i >= m_blk) continue;
      const size_t o = (row0 + i) * ld;
#pragma unroll
      for (int nt = 0; nt < WN; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = co_base + 8 * nt + t2 + e;
          if (co >= ld || (2 * half + e) % KQ != part) continue;
          const float v =
              epilogue(static_cast<float>(acc[mt][nt][2 * half + e]),
                       dv[nt][e], bs[nt][e], quant != 0, out_step);
          if (quant) {
            static_cast<uint8_t*>(out)[o + co] = static_cast<uint8_t>(v);
          } else {
            static_cast<float*>(out)[o + co] = v;
          }
        }
      }
    }
  }
}

// The int matmul's store: one warp item's exact int32 sums as they are,
// with no epilogue, into the row-major (rows, ld) int32 output `out`; rows,
// columns and the KQ split as in store_tile.
template <int WM, int WN, int KQ>
__device__ __forceinline__ void store_int_tile(const int (&acc)[WM][WN][4],
                                               int* __restrict__ out,
                                               size_t row0, int m_blk, int ld,
                                               int co_base, int part) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t2 = 2 * (lane & 3);
#pragma unroll
  for (int mt = 0; mt < WM; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = mt * 16 + g + 8 * half;
      if (i >= m_blk) continue;
#pragma unroll
      for (int nt = 0; nt < WN; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = co_base + 8 * nt + t2 + e;
          if (co >= ld || (2 * half + e) % KQ != part) continue;
          out[(row0 + i) * ld + co] = acc[mt][nt][2 * half + e];
        }
      }
    }
  }
}

// The conv kernels' epilogue: M row i of the block is output pixel
// (y0 + i / width, i % width) of image b, which is row (b * h + y0) *
// width + i of the (b * h * width, cout) output; rows from m_blk on and
// columns from cout on are not stored.
template <int WM, int WN, typename Acc>
__device__ __forceinline__ void store_conv_tile(
    const Acc (&acc)[WM][WN][4], const float* __restrict__ div,
    const float* __restrict__ bias, void* __restrict__ out, int b, int h,
    int width, int cout, int y0, int co_base, int m0, int m_blk,
    float out_step, int quant) {
  float dv[WN][2], bs[WN][2];
  lane_constants<WN>(div, bias, co_base, cout, dv, bs);
  store_tile<WM, WN>(acc, dv, bs, out,
                     (static_cast<size_t>(b) * h + y0) * width, m0, m_blk,
                     cout, co_base, out_step, quant);
}

__device__ __forceinline__ float quad_pick(float x, float y, bool rising) {
  return rising ? fmaxf(x, y) : fminf(x, y);
}

__device__ __forceinline__ int quad_pick(int x, int y, bool rising) {
  return rising ? max(x, y) : min(x, y);
}

// The fused conv+pool kernels' epilogue. M row 4p + q of the block is conv
// output (2 * py + q / 2, 2 * px + q % 2) of pooled pixel p = (py, px),
// py counted from py0, so the four conv outputs under a pooled output sit
// in rows g, g ^ 1, g ^ 2, g ^ 3 of a fragment, held by the lanes whose
// bits 2 and 3 differ. The requant is monotone in acc (each of its IEEE
// steps is), rising where div and out_step share a sign and falling
// elsewhere, so the max of the four codes is the code of the quad's
// largest or smallest acc: two __shfl_xor_sync reduce acc over the quad,
// then each quad lane requants a quarter of the results, one requant per
// pooled output. M rows from m_blk on and columns from cout on are not
// stored.
template <int WM, int WN, typename Acc>
__device__ __forceinline__ void store_pool_tile(
    Acc (&acc)[WM][WN][4], const float* __restrict__ div,
    const float* __restrict__ bias, uint8_t* __restrict__ out, int b, int ph,
    int pw, int cout, int py0, int co_base, int m0, int m_blk,
    float out_step) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t2 = 2 * (lane & 3);
  float dv[WN][2], bs[WN][2];
  lane_constants<WN>(div, bias, co_base, cout, dv, bs);
#pragma unroll
  for (int mt = 0; mt < WM; ++mt) {
#pragma unroll
    for (int nt = 0; nt < WN; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool rising = (dv[nt][i & 1] >= 0.f) == (out_step >= 0.f);
        Acc x = acc[mt][nt][i];
#pragma unroll
        for (int m = 4; m <= 8; m *= 2) {
          x = quad_pick(x, __shfl_xor_sync(0xffffffffu, x, m), rising);
        }
        acc[mt][nt][i] = x;
      }
    }
  }
  // result j = ((mt * 2 + half) * WN + nt) * 2 + e goes to quad lane j % 4
  const int q = g & 3;
#pragma unroll
  for (int r = 0; r < WM * WN; ++r) {
    Acc x = 0;
    float d = 0.f, bb = 0.f;
    int co = 0, i = 0;
#pragma unroll
    for (int qq = 0; qq < 4; ++qq) {
      const int j = 4 * r + qq;
      const int mt = j / (4 * WN), half = (j / (2 * WN)) % 2;
      const int nt = (j / 2) % WN, e = j % 2;
      if (q == qq) {
        x = acc[mt][nt][2 * half + e];
        d = dv[nt][e];
        bb = bs[nt][e];
        co = co_base + 8 * nt + t2 + e;
        i = m0 + mt * 16 + (g & ~3) + 8 * half;
      }
    }
    if (i >= m_blk || co >= cout) continue;
    const int p = i >> 2;
    const size_t o =
        ((static_cast<size_t>(b) * ph + py0 + p / pw) * pw + p % pw) * cout;
    out[o + co] = static_cast<uint8_t>(
        epilogue(static_cast<float>(x), d, bb, true, out_step));
  }
}

// ---------------------------------------------------------------------------
// The matmuls: y = a @ signs for (m, k) uint8 codes and (ceil(k / 32), n)
// sign words, as a GEMM on the tensor cores, in the dot form (bf16
// prologue values, mma.sync m16n8k16) and the popcount form (raw codes,
// mma.sync m16n8k32 u8 * s8, exact). Each item of WM M tiles of 16 rows by
// WN N tiles of 8 columns is computed by kSplit warps straight from device
// memory: no shared memory but for the partial sums, so an item's time
// is one round of loads, all in flight together, a short chain of
// mma.sync and one barrier.
//
// K runs in spans of kSpan = 128 codes. In a span, lane 4g + t of an item
// covers the 32 codes 32t .. 32t + 31 of its rows g and g + 8 and sign
// word 4s + t of its columns: the mma.sync take the span's k in a fixed
// permutation, the same for A and B, under which each lane's share of an
// mma's K is the next 4 (dot) or 8 (popcount) of its own codes, already in
// its registers. Warp q of the item's two takes codes 16q .. 16q + 15 of
// each lane's 32, and `reduce_split` adds the two partial sums in the
// order q = 0, 1. Codes past k load as 0 and add exactly 0 whatever their
// sign bits say (the last sign word's pad bits are +1). An output's K runs
// in one order, span by span, mma by mma and warp by warp, whatever its
// row, its tile or the call's M, and mma computes it from its own A row
// and B column only: a row's result does not depend on the rows beside
// it.
// ---------------------------------------------------------------------------

constexpr int kSpan = 4 * kPack;  // K codes of one span: 32 per lane of a quad
constexpr int kSplit = 2;         // warps that split an item's K
constexpr int kLaneCodes = kPack / kSplit;  // a lane's codes per row and span
constexpr int kMatmulThreads = 256;         // the kernels' __launch_bounds__

// The 16 codes p[0 .. 15] as 4 words, code j in byte j % 4 of word j / 4,
// 0 from `valid` on: one 16-byte load with `vec` (p 16-byte aligned and
// valid a multiple of 16), else a byte gather.
__device__ __forceinline__ void load_codes(uint32_t (&v)[kLaneCodes / 4],
                                           const uint8_t* __restrict__ p,
                                           int valid, bool vec) {
#pragma unroll
  for (int i = 0; i < kLaneCodes / 4; ++i) v[i] = 0u;
  if (vec) {
    if (valid > 0) {
      const uint4 q = *reinterpret_cast<const uint4*>(p);
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[3] = q.w;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kLaneCodes; ++j) {
    if (j < valid) v[j / 4] |= static_cast<uint32_t>(p[j]) << (8 * (j % 4));
  }
}

// The 16 Mul_prev values p[0 .. 15], 0 from `valid` on: 16-byte loads
// with `vec` (p 16-byte aligned and valid % 4 == 0), else one by one.
__device__ __forceinline__ void load_mul(float (&m)[kLaneCodes],
                                         const float* __restrict__ p,
                                         int valid, bool vec) {
  if (vec) {
#pragma unroll
    for (int q = 0; q < kLaneCodes / 4; ++q) {
      const float4 f = 4 * q < valid
                           ? __ldg(reinterpret_cast<const float4*>(p) + q)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      m[4 * q] = f.x;
      m[4 * q + 1] = f.y;
      m[4 * q + 2] = f.z;
      m[4 * q + 3] = f.w;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kLaneCodes; ++j) m[j] = j < valid ? __ldg(p + j) : 0.f;
}

// rows[mt][r]: the first code of row g + 8r of M tile mt of this lane's
// item, for a block whose rows start at row0 and hold m_blk outputs. Rows
// past them point at the last one: they are loaded, never stored.
template <int WM>
__device__ __forceinline__ void row_pointers(const uint8_t* a, int k, int row0,
                                             int m_blk,
                                             const uint8_t* (&rows)[WM][2]) {
  const int g = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int mt = 0; mt < WM; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = min(mt * 16 + g + 8 * r, m_blk - 1);
      rows[mt][r] = a + static_cast<size_t>(row0 + i) * k;
    }
  }
}

// Loads one span's operands of warp q of an item: this lane's codes of
// rows rows[mt][r] (pointers to each row's first code) and the sign words
// of its columns col + 8 * nt (0 past n or past the last word).
template <int WM, int WN>
__device__ __forceinline__ void load_span(
    const uint8_t* const (&rows)[WM][2], const uint32_t* __restrict__ w,
    int k, int n, int s, int q, int col, bool vec,
    uint32_t (&code)[WM][2][kLaneCodes / 4], uint32_t (&word)[WN]) {
  const int t = threadIdx.x & 3;
  const int kb = s * kSpan + kPack * t + kLaneCodes * q;
#pragma unroll
  for (int mt = 0; mt < WM; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      load_codes(code[mt][r], rows[mt][r] + kb, k - kb, vec);
    }
  }
  const int j = s * (kSpan / kPack) + t;
#pragma unroll
  for (int nt = 0; nt < WN; ++nt) {
    const int c = col + 8 * nt;
    word[nt] = j < words_of(k) && c < n
                   ? __ldg(w + static_cast<size_t>(j) * n + c)
                   : 0u;
  }
}

// float(byte i of x), exactly, without a conversion instruction: the byte
// as the low mantissa bits of 2^23, less 2^23.
__device__ __forceinline__ float byte_to_float(uint32_t x, int i) {
  return __fsub_rn(__uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540 + i)),
                   8388608.f);
}

// Adds warp q's share of one span to acc[mt][nt] (the m16n8 accumulator
// fragment of M tile mt and columns 8 * nt on of the item) on the bf16
// tensor cores: code[mt][r] holds this lane's codes 16q .. 16q + 15 of row
// g + 8r of M tile mt, mul their Mul_prev values and word[nt] the span's
// sign word of column 8 * nt + g. mma c takes codes 4c .. 4c + 3 of them,
// the first two as the lane's A columns 2t, 2t + 1 (and the sign bits of
// the same k as its B rows 2t, 2t + 1), the last two as columns and rows
// 2t + 8, 2t + 9; each A value is the prologue bf16(code * Mul_prev).
template <int WM, int WN>
__device__ __forceinline__ void matmul_mma_tile(
    const uint32_t (&code)[WM][2][kLaneCodes / 4],
    const float (&mul)[kLaneCodes], const uint32_t (&word)[WN], int q,
    float (&acc)[WM][WN][4]) {
#pragma unroll
  for (int c = 0; c < kLaneCodes / 4; ++c) {
    const int shift = kLaneCodes * q + 4 * c;
    uint32_t b[WN][2];
#pragma unroll
    for (int nt = 0; nt < WN; ++nt) {
      b[nt][0] = sign_pair(word[nt] >> shift);
      b[nt][1] = sign_pair(word[nt] >> (shift + 2));
    }
#pragma unroll
    for (int mt = 0; mt < WM; ++mt) {
      uint32_t a[4];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t four = code[mt][r][c];
        a[r] = pack_bf16x2(__fmul_rn(byte_to_float(four, 0), mul[4 * c]),
                           __fmul_rn(byte_to_float(four, 1), mul[4 * c + 1]));
        a[2 + r] =
            pack_bf16x2(__fmul_rn(byte_to_float(four, 2), mul[4 * c + 2]),
                        __fmul_rn(byte_to_float(four, 3), mul[4 * c + 3]));
      }
#pragma unroll
      for (int nt = 0; nt < WN; ++nt) mma_bf16_16816(acc[mt][nt], a, b[nt]);
    }
  }
}

// The exact int32 counterpart, on the int8 tensor cores: mma p takes codes
// 8p .. 8p + 7 of the lane's 16, the first four as its A columns
// 4t .. 4t + 3 (and their sign bits as its B rows), the last four as
// columns and rows 16 + 4t .. 16 + 4t + 3: the A registers are the code
// words as loaded.
template <int WM, int WN>
__device__ __forceinline__ void matmul_imma_tile(
    const uint32_t (&code)[WM][2][kLaneCodes / 4], const uint32_t (&word)[WN],
    int q, int (&acc)[WM][WN][4]) {
#pragma unroll
  for (int p = 0; p < kLaneCodes / 8; ++p) {
    const int shift = kLaneCodes * q + 8 * p;
    uint32_t b[WN][2];
#pragma unroll
    for (int nt = 0; nt < WN; ++nt) {
      b[nt][0] = sign_bytes(word[nt] >> shift);
      b[nt][1] = sign_bytes(word[nt] >> (shift + 4));
    }
#pragma unroll
    for (int mt = 0; mt < WM; ++mt) {
      const uint32_t a[4] = {code[mt][0][2 * p], code[mt][1][2 * p],
                             code[mt][0][2 * p + 1], code[mt][1][2 * p + 1]};
#pragma unroll
      for (int nt = 0; nt < WN; ++nt) mma_u8s8_16832(acc[mt][nt], a, b[nt]);
    }
  }
}

// Sums the partial accumulators of an item's two warps for the outputs
// that warp q stores: its elements i % 2 == q of each fragment (i = 2 *
// half + e: row g + 8 * half, column t2 + e). Both warps post their
// partial sums in `red` (two tiles of 32 lanes per item of the block),
// then add, for their own elements, warp 0's and warp 1's in that order,
// so that an output's sum does not depend on the warp that stores it.
// Every thread of the block calls it (a barrier).
template <int WM, int WN, typename Acc>
__device__ __forceinline__ void reduce_split(Acc (&acc)[WM][WN][4],
                                             Acc* red) {
  constexpr int kTile = WM * WN * 4;
  const int lane = threadIdx.x & 31;
  const int q = (threadIdx.x / 32) % kSplit;
  Acc* item = red + (threadIdx.x / 32 / kSplit) * kSplit * kTile * 32 + lane;
  Acc* flat = &acc[0][0][0];
#pragma unroll
  for (int i = 0; i < kTile; ++i) item[(q * kTile + i) * 32] = flat[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kTile; ++i) {
    if (i % kSplit != q) continue;
    Acc sum = item[i * 32];
    for (int j = 1; j < kSplit; ++j) sum += item[(j * kTile + i) * 32];
    flat[i] = sum;
  }
}

// The instantiation Kernels::get<WM, WN>() of a matmul kernel, dot or
// popcount, for warp tile (wm, wn), one of the library's Tiles (10 * WM +
// WN each: its route's WARP_TILES in kernels/w1a8_matmul/geometry.py), or
// nullptr.
template <typename Kernels, int... Tiles>
auto pick_matmul(int wm, int wn) -> decltype(Kernels::template get<1, 1>()) {
  decltype(Kernels::template get<1, 1>()) kernel = nullptr;
  ((kernel = 10 * wm + wn == Tiles
                 ? Kernels::template get<Tiles / 10, Tiles % 10>()
                 : kernel),
   ...);
  return kernel;
}

// True when a matmul launch covers the (m, n) output exactly: grid_x row
// blocks of bm = 16 * wm rows by grid_y column blocks of bn = 8 * wn *
// threads / (32 * kSplit) columns, no block past the output.
inline bool matmul_geometry_ok(int m, int k, int n, int grid_x, int grid_y,
                               int bm, int bn, int wm, int wn, int threads) {
  return m >= 1 && k >= 1 && n >= 1 && bm == 16 * wm && threads >= 32 &&
         threads <= kMatmulThreads && threads % (32 * kSplit) == 0 &&
         bn == 8 * wn * (threads / (32 * kSplit)) && grid_x * bm >= m &&
         (grid_x - 1) * bm < m && grid_y * bn >= n && (grid_y - 1) * bn < n;
}

// Sets a kernel's dynamic shared memory limit where it needs more than the
// default 48 KB.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace w1a8
