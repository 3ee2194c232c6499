// Fused W1A8 3x3 SAME conv + requant + 2x2 MaxPool (paper §5.2's
// Post+MaxPool stage chain): only the pooled uint8 codes leave the kernel.
//
// Replaces the dot body of the TPU kernel
// repro/kernels/w1a8_conv/fused_pool.py::w1a8_conv3x3_pool2 (_kernel,
// _pool_epilogue). The TPU kernel's jnp.dot on the MXU becomes an implicit
// GEMM on the tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate).
//
// What bounds it on the H100: as for the conv kernel, latency rather than
// bytes (one uint8 read per input element, one write per pooled output, a
// quarter of what the conv kernel followed by a pool would write) or the
// tensor-core rate: the warps in flight, the block's staging and the
// launch.
//
// Design: the conv kernel's, with `rows` pooled rows a block and its
// 2 * rows + 2 padded input rows staged. M is ordered (pooled pixel, quad
// member): M row 4p + q is conv output (2 * py + q / 2, 2 * px + q % 2) of
// pooled pixel p = (py, px), so the four conv outputs under a pooled
// output sit in rows g, g ^ 1, g ^ 2, g ^ 3 of an accumulator fragment,
// held by the lanes whose bits 2 and 3 differ. Each output's accumulator
// comes from w1a8::conv3x3_mma_tile, the function the conv kernel uses.
// The requant is monotone in the accumulator, so w1a8::store_pool_tile
// takes the quad's largest (or, where the requant falls, smallest)
// accumulator with two __shfl_xor_sync, whose code is the max of the four
// codes the conv kernel would write, bit for bit, and requants once.
#include "w1a8_common.cuh"

namespace {

constexpr int kMaxThreads = 256;

template <int WM, int WN>
__global__ void __launch_bounds__(kMaxThreads)
conv3x3_pool2_kernel(const uint8_t* __restrict__ a,
                     const uint32_t* __restrict__ w,
                     const float* __restrict__ mul,
                     const float* __restrict__ div,
                     const float* __restrict__ bias,
                     uint8_t* __restrict__ out, int h, int width, int cin,
                     int cout, int rows, int bn, int row_px, float out_step) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int co0 = blockIdx.x * bn;
  const int py0 = blockIdx.y * rows;
  const int b = blockIdx.z;
  const int ph = h / 2;
  const int pw = width / 2;
  const int n_rows = min(rows, ph - py0);
  const int n_words = w1a8::words_of(9 * cin);
  const int ps = w1a8::pixel_stride(cin);
  const int row_stride = row_px * ps;

  uint32_t* wsm = reinterpret_cast<uint32_t*>(smem);
  __nv_bfloat16* act = reinterpret_cast<__nv_bfloat16*>(
      smem + (sizeof(uint32_t) * (n_words + 1) * bn + 15) / 16 * 16);
  w1a8::stage_conv_words(w, wsm, n_words, cout, co0, bn);
  w1a8::stage_act(a + static_cast<size_t>(b) * h * width * cin, mul, act,
                  2 * py0 - 1, 2 * n_rows + 2, h, width, cin, row_px);
  w1a8::cp_async_wait_all();
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int m_blk = 4 * n_rows * pw;
  const int m_items = w1a8::ceil_div(w1a8::ceil_div(m_blk, 16), WM);
  const int items = m_items * (bn / (8 * WN));
  for (int item = threadIdx.x / 32; item < items; item += blockDim.x / 32) {
    const int m0 = (item % m_items) * WM * 16;
    const int col0 = (item / m_items) * 8 * WN;
    int a_off[WM];
#pragma unroll
    for (int mt = 0; mt < WM; ++mt) {
      // rows past the block's outputs read a valid pixel; never stored
      const int i = min(m0 + mt * 16 + (lane & 15), m_blk - 1);
      const int p = i >> 2;
      const int sr = 2 * (p / pw) + ((i >> 1) & 1);
      const int sc = 2 * (p % pw) + (i & 1);
      a_off[mt] = sr * row_stride + sc * ps + (lane >> 4) * 8;
    }
    float acc[WM][WN][4];
    w1a8::conv3x3_mma_tile<WM, WN>(act, a_off, row_stride, ps, cin, wsm, bn,
                                   col0, acc);

    w1a8::store_pool_tile<WM, WN>(acc, div, bias, out, b, ph, pw, cout, py0,
                                  co0 + col0, m0, m_blk, out_step);
  }
}

// The kernel's instantiation for warp tile (wm, wn), or nullptr.
auto pick(int wm, int wn) -> decltype(&conv3x3_pool2_kernel<1, 1>) {
  switch (wm * 10 + wn) {
    case 11: return conv3x3_pool2_kernel<1, 1>;
    case 12: return conv3x3_pool2_kernel<1, 2>;
    case 14: return conv3x3_pool2_kernel<1, 4>;
    case 21: return conv3x3_pool2_kernel<2, 1>;
    case 22: return conv3x3_pool2_kernel<2, 2>;
    case 24: return conv3x3_pool2_kernel<2, 4>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// a (b, h, width, cin) uint8 with h and width even; w, mul, div, bias as for
// w1a8_conv3x3; out (b, h / 2, width / 2, cout) uint8 codes. The launch
// geometry comes from kernels/w1a8_conv/geometry.py as for w1a8_conv3x3,
// with `rows` counting pooled rows; one that does not cover the output
// exactly or does not hold the block's staging is refused with
// cudaErrorInvalidValue. Returns cudaGetLastError() otherwise.
int w1a8_conv3x3_pool2(const void* a, const void* w, const void* mul,
                       const void* div, const void* bias, void* out, int b,
                       int h, int width, int cin, int cout, int rows,
                       float out_step, int grid_x, int grid_y, int bn,
                       int wm, int wn, int row_px, int threads, int smem,
                       void* stream) {
  const int ph = h / 2;
  if (h % 2 || width % 2 || rows < 1 || bn < 8 * wn ||
      bn % (8 * wn) || grid_x * bn < cout ||
      (grid_x - 1) * bn >= cout || grid_y * rows < ph ||
      (grid_y - 1) * rows >= ph || threads < 32 || threads > kMaxThreads ||
      threads % 32 || row_px < width + 2 || !pick(wm, wn) ||
      smem < 0 ||
      static_cast<size_t>(smem) <
          w1a8::dot_conv_smem(cin, bn, 2 * rows + 2, row_px)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel = pick(wm, wn);
  cudaError_t err = w1a8::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(grid_x, grid_y, b), threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint32_t*>(w),
      static_cast<const float*>(mul), static_cast<const float*>(div),
      static_cast<const float*>(bias), static_cast<uint8_t*>(out), h, width,
      cin, cout, rows, bn, row_px, out_step);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
