// W1A8 3x3 SAME conv on uint8 codes with packed 1-bit weights.
//
// Replaces the dot body of the TPU kernel
// repro/kernels/w1a8_conv/kernel.py::w1a8_conv3x3_pallas (_conv_kernel,
// _im2col_rows): bf16(a * Mul_prev) against +-1 signs unpacked from 32-bit
// words, f32 accumulation in (dy, dx, cin) order, then Div/bias and, when
// requested, the requant to uint8 codes.
//
// What bounds it on the H100: at the detector's shapes (B = 4, Cin <= 128,
// K = 9 * Cin <= 1152) the bytes are small (one uint8 read per input
// element, one write per output) and the work is 2 * M * K * N sign-adds
// done on the CUDA cores, not on the tensor cores; so the instruction rate
// of the inner loop bounds it, far above the memory bound.
//
// Design: one block per (Cout tile of 32, `rows` output rows, image). The
// block stages the rows + 2 padded input rows it needs once in shared
// memory, already multiplied by Mul_prev and rounded to bf16 (each staged
// value feeds 9 * 32 outputs), and the sign words of its 32 output channels
// (at most 36 * 32 words). Each thread then produces whole outputs: a warp
// spans the 32 output channels of one pixel, so its reads of the staged
// activations are broadcasts and its reads of the sign words hit 32
// consecutive words. The accumulation and epilogue live in
// w1a8_common.cuh, shared with the fused conv+pool kernel.
#include "w1a8_common.cuh"

namespace {

constexpr int kCoutTile = 32;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const uint8_t* __restrict__ a, const uint32_t* __restrict__ w,
               const float* __restrict__ mul, const float* __restrict__ div,
               const float* __restrict__ bias, void* __restrict__ out, int h,
               int width, int cin, int cout, int rows, float out_step,
               int quant) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int co0 = blockIdx.x * kCoutTile;
  const int y0 = blockIdx.y * rows;
  const int b = blockIdx.z;
  const int n_words = (9 * cin + w1a8::kPack - 1) / w1a8::kPack;
  const int row_len = (width + 2) * cin;

  uint32_t* wsm = reinterpret_cast<uint32_t*>(smem);
  __nv_bfloat16* act = reinterpret_cast<__nv_bfloat16*>(
      smem + sizeof(uint32_t) * n_words * kCoutTile);
  const uint8_t* a_img = a + static_cast<size_t>(b) * h * width * cin;
  w1a8::stage_words(w, wsm, n_words, cout, co0, kCoutTile);
  w1a8::stage_rows(a_img, mul, act, y0 - 1, rows + 2, h, width, cin);
  __syncthreads();

  const int n_out = rows * width * kCoutTile;
  for (int i = threadIdx.x; i < n_out; i += blockDim.x) {
    const int col = i % kCoutTile;
    const int x = (i / kCoutTile) % width;
    const int r = i / (kCoutTile * width);
    const int co = co0 + col;
    if (co >= cout) continue;
    const float v = w1a8::conv3x3_output(act + r * row_len, row_len, x, cin,
                                         wsm, kCoutTile, col, __ldg(div + co),
                                         __ldg(bias + co), quant != 0,
                                         out_step);
    const size_t o =
        ((static_cast<size_t>(b) * h + y0 + r) * width + x) * cout + co;
    if (quant) {
      static_cast<uint8_t*>(out)[o] = static_cast<uint8_t>(v);
    } else {
      static_cast<float*>(out)[o] = v;
    }
  }
}

}  // namespace

extern "C" {

// a (b, h, width, cin) uint8; w (ceil(9 * cin / 32), cout) sign words;
// mul (cin,), div and bias (cout,) f32; out (b, h, width, cout), uint8 codes
// when quant != 0, else f32. h % rows == 0. Returns cudaGetLastError().
int w1a8_conv3x3(const void* a, const void* w, const void* mul,
                 const void* div, const void* bias, void* out, int b, int h,
                 int width, int cin, int cout, int rows, float out_step,
                 int quant, void* stream) {
  const int n_words = (9 * cin + w1a8::kPack - 1) / w1a8::kPack;
  const size_t smem = sizeof(uint32_t) * n_words * kCoutTile +
                      sizeof(__nv_bfloat16) * (rows + 2) * (width + 2) * cin;
  cudaError_t err = w1a8::allow_smem(conv3x3_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((cout + kCoutTile - 1) / kCoutTile, h / rows, b);
  conv3x3_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint32_t*>(w),
      static_cast<const float*>(mul), static_cast<const float*>(div),
      static_cast<const float*>(bias), out, h, width, cin, cout, rows,
      out_step, quant);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
