// Fused binary-domain W1A8 3x3 SAME conv + requant + 2x2 MaxPool: the codes
// stay in the integer domain from line buffer to pooled output, the paper's
// whole §5.2 stage chain in one kernel.
//
// Replaces the popcount body of the TPU kernel
// repro/kernels/w1a8_conv/fused_pool.py::w1a8_conv3x3_pool2
// (_popcount_kernel, _pool_epilogue). As in the popcount conv kernel, the
// plane-by-plane AND + popcount becomes one int8 product on the tensor
// cores (mma.sync m16n8k32), which forms the same integer sum.
//
// What bounds it on the H100: as for the popcount conv kernel, latency
// rather than bytes (one uint8 read per input element, one write per
// pooled output, a quarter of what the conv kernel followed by a pool
// would write) or the int8 tensor-core rate.
//
// Design: the dot fused kernel's (w1a8_conv3x3_pool2.cu), with `rows`
// pooled rows a block and its 2 * rows + 2 padded input rows staged as raw
// codes. M is ordered (pooled pixel, quad member), and each accumulator
// comes from w1a8::conv3x3_imma_tile, the function the popcount conv
// kernel uses. w1a8::store_pool_tile reduces the quad's four integer
// accumulators to the one whose code is the largest (the requant is
// monotone in the accumulator) and requants once per pooled output, so
// each code equals the max of the four the conv kernel writes, bit for
// bit.
#include "w1a8_common.cuh"

namespace {

constexpr int kMaxThreads = 256;

template <int WM, int WN>
__global__ void __launch_bounds__(kMaxThreads)
conv3x3_pool2_popcount_kernel(const uint8_t* __restrict__ a,
                              const uint32_t* __restrict__ w,
                              const float* __restrict__ div,
                              const float* __restrict__ bias,
                              uint8_t* __restrict__ out, int h, int width,
                              int cin, int cout, int rows, int bn,
                              int row_px, float out_step) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int co0 = blockIdx.x * bn;
  const int py0 = blockIdx.y * rows;
  const int b = blockIdx.z;
  const int ph = h / 2;
  const int pw = width / 2;
  const int n_rows = min(rows, ph - py0);
  const int pairs = w1a8::pair_words(cin);
  const int units = 9 * w1a8::code_units(cin);
  const int ps = w1a8::code_stride(cin);
  const int row_stride = row_px * ps;

  uint32_t* wsm = reinterpret_cast<uint32_t*>(smem);
  int* uoff = reinterpret_cast<int*>(
      smem + (sizeof(uint32_t) * (pairs + 1) * bn + 15) / 16 * 16);
  uint8_t* act = reinterpret_cast<uint8_t*>(uoff) +
                 (sizeof(int) * 2 * pairs + 15) / 16 * 16;
  w1a8::stage_pair_words(w, wsm, cin, cout, co0, bn);
  w1a8::stage_raw_codes(a + static_cast<size_t>(b) * h * width * cin, act,
                        2 * py0 - 1, 2 * n_rows + 2, h, width, cin, row_px);
  w1a8::stage_unit_offsets(uoff, cin, row_stride);
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
      a_off[mt] = sr * row_stride + sc * ps;
    }
    int acc[WM][WN][4];
    w1a8::conv3x3_imma_tile<WM, WN>(act, a_off, uoff, units, wsm, bn, col0,
                                    acc);
    w1a8::store_pool_tile<WM, WN>(acc, div, bias, out, b, ph, pw, cout, py0,
                                  co0 + col0, m0, m_blk, out_step);
  }
}

// The kernel's instantiation for warp tile (wm, wn), or nullptr.
auto pick(int wm, int wn) -> decltype(&conv3x3_pool2_popcount_kernel<1, 1>) {
  switch (wm * 10 + wn) {
    case 11: return conv3x3_pool2_popcount_kernel<1, 1>;
    case 12: return conv3x3_pool2_popcount_kernel<1, 2>;
    case 14: return conv3x3_pool2_popcount_kernel<1, 4>;
    case 21: return conv3x3_pool2_popcount_kernel<2, 1>;
    case 22: return conv3x3_pool2_popcount_kernel<2, 2>;
    case 24: return conv3x3_pool2_popcount_kernel<2, 4>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// a (b, h, width, cin) uint8 codes on one grid, h and width even; w, div,
// bias as for w1a8_conv3x3_popcount; out (b, h / 2, width / 2, cout) uint8
// codes. The launch geometry comes from kernels/w1a8_conv/geometry.py
// (accum "popcount", pool), with `rows` counting pooled rows; one that does
// not cover the output exactly or does not hold the block's staging is
// refused with cudaErrorInvalidValue. Returns cudaGetLastError() otherwise.
int w1a8_conv3x3_pool2_popcount(const void* a, const void* w,
                                const void* div, const void* bias, void* out,
                                int b, int h, int width, int cin, int cout,
                                int rows, float out_step, int grid_x,
                                int grid_y, int bn, int wm, int wn,
                                int row_px, int threads, int smem,
                                void* stream) {
  const int ph = h / 2;
  if (h % 2 || width % 2 || rows < 1 || bn < 8 * wn ||
      bn % (8 * wn) || grid_x * bn < cout ||
      (grid_x - 1) * bn >= cout || grid_y * rows < ph ||
      (grid_y - 1) * rows >= ph || threads < 32 || threads > kMaxThreads ||
      threads % 32 || row_px < width + 2 || !pick(wm, wn) ||
      smem < 0 ||
      static_cast<size_t>(smem) <
          w1a8::popcount_conv_smem(cin, bn, 2 * rows + 2, row_px)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel = pick(wm, wn);
  cudaError_t err = w1a8::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(grid_x, grid_y, b), threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint32_t*>(w),
      static_cast<const float*>(div), static_cast<const float*>(bias),
      static_cast<uint8_t*>(out), h, width, cin, cout, rows, bn, row_px,
      out_step);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
