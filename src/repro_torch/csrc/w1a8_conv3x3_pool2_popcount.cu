// Fused binary-domain W1A8 3x3 SAME conv + requant + 2x2 MaxPool: the codes
// stay in the bit domain from line buffer to pooled output, the paper's
// whole §5.2 stage chain in one kernel.
//
// Replaces the popcount body of the TPU kernel
// repro/kernels/w1a8_conv/fused_pool.py::w1a8_conv3x3_pool2
// (_popcount_kernel, _pool_epilogue).
//
// What bounds it on the H100: as for the popcount conv kernel, the inner
// loop's instruction rate; the bytes are one uint8 read per input element
// and one write per pooled output.
//
// Design: one block per (Cout tile of 32, `rows` pooled rows, image),
// staging the 2 * rows + 2 padded input rows as raw codes and the tile's
// sign words. A warp computes the 32 output channels of one pooled pixel:
// the four conv outputs under it, each through
// w1a8::conv3x3_popcount_output, the function the popcount conv kernel
// uses, so each code equals that kernel's bit for bit, then their max.
#include "w1a8_common.cuh"

namespace {

constexpr int kCoutTile = 32;  // one warp spans the tile: lane = column
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
conv3x3_pool2_popcount_kernel(const uint8_t* __restrict__ a,
                              const uint32_t* __restrict__ w,
                              const float* __restrict__ div,
                              const float* __restrict__ bias,
                              uint8_t* __restrict__ out, int h, int width,
                              int cin, int cout, int rows, float out_step) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int co0 = blockIdx.x * kCoutTile;
  const int py0 = blockIdx.y * rows;
  const int b = blockIdx.z;
  const int n_words = (9 * cin + w1a8::kPack - 1) / w1a8::kPack;
  const int row_len = (width + 2) * cin;
  const int pw = width / 2;

  uint32_t* wsm = reinterpret_cast<uint32_t*>(smem);
  uint8_t* act = smem + sizeof(uint32_t) * n_words * kCoutTile;
  const uint8_t* a_img = a + static_cast<size_t>(b) * h * width * cin;
  w1a8::stage_words(w, wsm, n_words, cout, co0, kCoutTile);
  w1a8::stage_codes(a_img, act, 2 * py0 - 1, 2 * rows + 2, h, width, cin);
  __syncthreads();

  // Warp-uniform loop, as in the popcount conv kernel.
  const int n_out = rows * pw * kCoutTile;
  for (int i = threadIdx.x; i < n_out; i += blockDim.x) {
    const int col = i % kCoutTile;
    const int px = (i / kCoutTile) % pw;
    const int r = i / (kCoutTile * pw);
    const int co = co0 + col;
    const bool live = co < cout;
    const float d = live ? __ldg(div + co) : 1.f;
    const float bs = live ? __ldg(bias + co) : 0.f;
    float best = 0.f;  // codes are >= 0
    for (int dy = 0; dy < 2; ++dy) {
      for (int dx = 0; dx < 2; ++dx) {
        const float q = w1a8::conv3x3_popcount_output(
            act + (2 * r + dy) * row_len, row_len, 2 * px + dx, cin, wsm,
            kCoutTile, col, d, bs, true, out_step);
        best = fmaxf(best, q);
      }
    }
    if (!live) continue;
    const size_t o =
        ((static_cast<size_t>(b) * (h / 2) + py0 + r) * pw + px) * cout + co;
    out[o] = static_cast<uint8_t>(best);
  }
}

}  // namespace

extern "C" {

// a (b, h, width, cin) uint8 codes on one grid, h and width even; w, div,
// bias as for w1a8_conv3x3_popcount; out (b, h / 2, width / 2, cout) uint8
// codes. (h / 2) % rows == 0. Returns cudaGetLastError().
int w1a8_conv3x3_pool2_popcount(const void* a, const void* w,
                                const void* div, const void* bias, void* out,
                                int b, int h, int width, int cin, int cout,
                                int rows, float out_step, void* stream) {
  const int n_words = (9 * cin + w1a8::kPack - 1) / w1a8::kPack;
  const size_t smem = sizeof(uint32_t) * n_words * kCoutTile +
                      sizeof(uint8_t) * (2 * rows + 2) * (width + 2) * cin;
  cudaError_t err = w1a8::allow_smem(conv3x3_pool2_popcount_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((cout + kCoutTile - 1) / kCoutTile, (h / 2) / rows, b);
  conv3x3_pool2_popcount_kernel<<<grid, kThreads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint32_t*>(w),
      static_cast<const float*>(div), static_cast<const float*>(bias),
      static_cast<uint8_t*>(out), h, width, cin, cout, rows, out_step);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
