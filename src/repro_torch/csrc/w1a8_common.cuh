// Arithmetic shared by the W1A8 CUDA kernels: the bf16 Mul_prev prologue,
// the 3x3 per-output accumulations (bf16 dot and XNOR-popcount) and the
// Div/bias/requant epilogue.
//
// Both dot conv kernels (w1a8_conv3x3.cu, w1a8_conv3x3_pool2.cu) compute
// every conv output through `conv3x3_output`, and both popcount conv kernels
// (w1a8_conv3x3_popcount.cu, w1a8_conv3x3_pool2_popcount.cu) through
// `conv3x3_popcount_output`, in the same order and with the same roundings,
// so each fused conv+pool kernel equals its conv kernel followed by a 2x2
// max bit for bit.
//
// Every rounding is spelled out (__fmul_rn, __fadd_rn, __fdiv_rn): nvcc
// would otherwise contract `acc * div + bias` into one FMA, while the
// reference rounds the product and the sum separately. Build without
// --use_fast_math, which would replace the IEEE division of the requant.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace w1a8 {

constexpr int kPack = 32;  // sign bits per 32-bit word, LSB first

// bf16(a * m): the prologue value the reference feeds its bf16 dot.
__device__ __forceinline__ __nv_bfloat16 prologue(uint8_t a, float m) {
  return __float2bfloat16_rn(__fmul_rn(static_cast<float>(a), m));
}

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

// Adds +v where the sign bit `k` of `word` is 1 and -v where it is 0.
__device__ __forceinline__ float signed_add(float acc, float v, uint32_t word,
                                            int k) {
  return ((word >> (k & (kPack - 1))) & 1u) ? __fadd_rn(acc, v)
                                            : __fsub_rn(acc, v);
}

// One 3x3 SAME conv output and its epilogue.
//
// rows: staged prologue values of three consecutive zero-padded input rows,
//       the first being the row above the output row; each row holds
//       (width + 2) * cin values, pixel-major.
// x:    output column. The window starts at padded column x.
// wsm:  sign words (ceil(9 * cin / 32), ct) of this block's cout tile;
//       col is this output's column in it.
// The sum runs over k = (dy * 3 + dx) * cin + ci in increasing order, the
// im2col order of the reference. Pad bits beyond 9 * cin are never read:
// the reference gives them zero scales, so they add exactly 0 there too.
__device__ __forceinline__ float conv3x3_output(
    const __nv_bfloat16* rows, int row_len, int x, int cin,
    const uint32_t* wsm, int ct, int col, float div, float bias, bool quant,
    float out_step) {
  float acc = 0.f;
  uint32_t word = 0;
  int k = 0;
  for (int dy = 0; dy < 3; ++dy) {
    for (int dx = 0; dx < 3; ++dx) {
      const __nv_bfloat16* a = rows + dy * row_len + (x + dx) * cin;
      for (int ci = 0; ci < cin; ++ci, ++k) {
        if ((k & (kPack - 1)) == 0) word = wsm[(k / kPack) * ct + col];
        acc = signed_add(acc, __bfloat162float(a[ci]), word, k);
      }
    }
  }
  return epilogue(acc, div, bias, quant, out_step);
}

// Stages `n_rows` zero-padded input rows, starting at input row `r0` (which
// may be -1), as prologue values: out-of-range rows and the two pad columns
// hold 0. `a_img` is one image, (h, width, cin) uint8.
__device__ __forceinline__ void stage_rows(const uint8_t* __restrict__ a_img,
                                           const float* __restrict__ mul,
                                           __nv_bfloat16* act, int r0,
                                           int n_rows, int h, int width,
                                           int cin) {
  const int row_len = (width + 2) * cin;
  const int total = n_rows * row_len;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int r = r0 + i / row_len;
    const int rem = i % row_len;
    const int c = rem / cin - 1;
    const int ci = rem % cin;
    __nv_bfloat16 v = __float2bfloat16_rn(0.f);
    if (r >= 0 && r < h && c >= 0 && c < width) {
      v = prologue(a_img[(static_cast<size_t>(r) * width + c) * cin + ci],
                   __ldg(mul + ci));
    }
    act[i] = v;
  }
}

// Stages the sign words of output channels [co0, co0 + ct) as (n_words, ct);
// columns past cout hold 0 and are never read.
__device__ __forceinline__ void stage_words(const uint32_t* __restrict__ w,
                                            uint32_t* wsm, int n_words,
                                            int cout, int co0, int ct) {
  for (int i = threadIdx.x; i < n_words * ct; i += blockDim.x) {
    const int j = i / ct;
    const int co = co0 + i % ct;
    wsm[i] = co < cout ? w[static_cast<size_t>(j) * cout + co] : 0u;
  }
}

// ---------------------------------------------------------------------------
// Binary domain: exact int32 sum over the bit-planes of uint8 codes.
// ---------------------------------------------------------------------------

// Adds one 32-lane K word to `acc`: lane l of the calling warp holds the
// code of lane l of the word (0 past the end of K), `w` is this thread's
// sign word for the same 32 lanes (bit l = 1 <=> +1). Bit b of the 32
// codes, gathered by __ballot_sync, is plane word b, LSB first as in
// core/packing.py; over a plane, sum_l s_l * a_{b,l} =
// 2 * popc(w & plane) - popc(plane). Zero codes add 0 to both terms, so
// pad lanes and their +1 pad bits add nothing. |acc| <= 255 * K stays far
// inside int32 and, below 2^24, converts to float exactly. All 32 lanes of
// the warp must call it together.
__device__ __forceinline__ int popcount_word(int acc, uint32_t code,
                                             uint32_t w) {
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const uint32_t plane = __ballot_sync(0xffffffffu, (code >> b) & 1u);
    acc += (2 * __popc(w & plane) - __popc(plane)) * (1 << b);
  }
  return acc;
}

// One 3x3 SAME conv output through popcount, and its epilogue.
//
// rows: staged codes of three consecutive zero-padded input rows, the first
//       being the row above the output row; each row holds
//       (width + 2) * cin codes, pixel-major.
// x:    output column. The window starts at padded column x.
// wsm:  sign words (ceil(9 * cin / 32), ct) of this block's cout tile;
//       col is this thread's column in it (lane of the warp).
// The warp's 32 lanes compute the 32 output channels of one pixel: word j
// takes lane l's code at k = 32 * j + l, in the im2col order
// k = (dy * 3 + dx) * cin + ci of the reference.
__device__ __forceinline__ float conv3x3_popcount_output(
    const uint8_t* rows, int row_len, int x, int cin, const uint32_t* wsm,
    int ct, int col, float div, float bias, bool quant, float out_step) {
  const int lane = threadIdx.x & (kPack - 1);
  const int k9 = 9 * cin;
  const int n_words = (k9 + kPack - 1) / kPack;
  int acc = 0;
  for (int j = 0; j < n_words; ++j) {
    const int k = j * kPack + lane;
    uint32_t code = 0;
    if (k < k9) {
      const int tap = k / cin;
      const int ci = k - tap * cin;
      const int dy = tap / 3;
      const int dx = tap - dy * 3;
      code = rows[dy * row_len + (x + dx) * cin + ci];
    }
    acc = popcount_word(acc, code, wsm[j * ct + col]);
  }
  return epilogue(static_cast<float>(acc), div, bias, quant, out_step);
}

// Stages `n_rows` zero-padded input rows of codes, starting at input row
// `r0` (which may be -1): out-of-range rows and the two pad columns hold 0.
// `a_img` is one image, (h, width, cin) uint8.
__device__ __forceinline__ void stage_codes(const uint8_t* __restrict__ a_img,
                                            uint8_t* act, int r0, int n_rows,
                                            int h, int width, int cin) {
  const int row_len = (width + 2) * cin;
  const int total = n_rows * row_len;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int r = r0 + i / row_len;
    const int rem = i % row_len;
    const int c = rem / cin - 1;
    const int ci = rem % cin;
    uint8_t v = 0;
    if (r >= 0 && r < h && c >= 0 && c < width) {
      v = a_img[(static_cast<size_t>(r) * width + c) * cin + ci];
    }
    act[i] = v;
  }
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
