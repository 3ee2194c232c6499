// Fused W1A8 3x3 SAME conv + requant + 2x2 MaxPool (paper §5.2's
// Post+MaxPool stage chain): only the pooled uint8 codes leave the kernel.
//
// Replaces the dot body of the TPU kernel
// repro/kernels/w1a8_conv/fused_pool.py::w1a8_conv3x3_pool2 (_kernel,
// _pool_epilogue).
//
// What bounds it on the H100: as for the conv kernel, the inner loop's
// instruction rate (2 * M * K * N sign-adds on the CUDA cores); the bytes
// are one uint8 read per input element and one write per pooled output,
// a quarter of what the conv kernel followed by a pool would write.
//
// Design: one block per (Cout tile of 32, `rows` pooled rows, image). The
// block stages the 2 * rows + 2 padded input rows of its 2 * rows conv rows
// as bf16 prologue values, and the sign words of its 32 output channels.
// Each thread computes the four conv outputs under one pooled output
// through w1a8::conv3x3_output, the function the conv kernel uses, so each
// code equals the conv kernel's bit for bit; the max of four codes does not
// depend on the order it is taken in.
#include "w1a8_common.cuh"

namespace {

constexpr int kCoutTile = 32;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
conv3x3_pool2_kernel(const uint8_t* __restrict__ a,
                     const uint32_t* __restrict__ w,
                     const float* __restrict__ mul,
                     const float* __restrict__ div,
                     const float* __restrict__ bias,
                     uint8_t* __restrict__ out, int h, int width, int cin,
                     int cout, int rows, float out_step) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int co0 = blockIdx.x * kCoutTile;
  const int py0 = blockIdx.y * rows;
  const int b = blockIdx.z;
  const int n_words = (9 * cin + w1a8::kPack - 1) / w1a8::kPack;
  const int row_len = (width + 2) * cin;
  const int pw = width / 2;

  uint32_t* wsm = reinterpret_cast<uint32_t*>(smem);
  __nv_bfloat16* act = reinterpret_cast<__nv_bfloat16*>(
      smem + sizeof(uint32_t) * n_words * kCoutTile);
  const uint8_t* a_img = a + static_cast<size_t>(b) * h * width * cin;
  w1a8::stage_words(w, wsm, n_words, cout, co0, kCoutTile);
  w1a8::stage_rows(a_img, mul, act, 2 * py0 - 1, 2 * rows + 2, h, width, cin);
  __syncthreads();

  const int n_out = rows * pw * kCoutTile;
  for (int i = threadIdx.x; i < n_out; i += blockDim.x) {
    const int col = i % kCoutTile;
    const int px = (i / kCoutTile) % pw;
    const int r = i / (kCoutTile * pw);
    const int co = co0 + col;
    if (co >= cout) continue;
    const float d = __ldg(div + co);
    const float bs = __ldg(bias + co);
    float best = 0.f;  // codes are >= 0
    for (int dy = 0; dy < 2; ++dy) {
      for (int dx = 0; dx < 2; ++dx) {
        const float q = w1a8::conv3x3_output(
            act + (2 * r + dy) * row_len, row_len, 2 * px + dx, cin, wsm,
            kCoutTile, col, d, bs, true, out_step);
        best = fmaxf(best, q);
      }
    }
    const size_t o =
        ((static_cast<size_t>(b) * (h / 2) + py0 + r) * pw + px) * cout + co;
    out[o] = static_cast<uint8_t>(best);
  }
}

}  // namespace

extern "C" {

// a (b, h, width, cin) uint8 with h and width even; w, mul, div, bias as for
// w1a8_conv3x3; out (b, h / 2, width / 2, cout) uint8 codes.
// (h / 2) % rows == 0. Returns cudaGetLastError().
int w1a8_conv3x3_pool2(const void* a, const void* w, const void* mul,
                       const void* div, const void* bias, void* out, int b,
                       int h, int width, int cin, int cout, int rows,
                       float out_step, void* stream) {
  const int n_words = (9 * cin + w1a8::kPack - 1) / w1a8::kPack;
  const size_t smem =
      sizeof(uint32_t) * n_words * kCoutTile +
      sizeof(__nv_bfloat16) * (2 * rows + 2) * (width + 2) * cin;
  cudaError_t err = w1a8::allow_smem(conv3x3_pool2_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((cout + kCoutTile - 1) / kCoutTile, (h / 2) / rows, b);
  conv3x3_pool2_kernel<<<grid, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint32_t*>(w),
      static_cast<const float*>(mul), static_cast<const float*>(div),
      static_cast<const float*>(bias), static_cast<uint8_t*>(out), h, width,
      cin, cout, rows, out_step);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
