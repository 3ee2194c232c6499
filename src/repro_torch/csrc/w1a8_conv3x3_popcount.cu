// Binary-domain W1A8 3x3 SAME conv: the exact int32 sum of uint8 codes
// against packed 1-bit weights (what the paper's FPGA PE forms with its
// XNOR-popcount tree over the codes' 8 bit-planes), then Div/bias and,
// when requested, the requant to uint8 codes.
//
// Replaces the popcount body of the TPU kernel
// repro/kernels/w1a8_conv/kernel.py::w1a8_conv3x3_pallas
// (_conv_popcount_kernel, through _xnor_accumulate): exact int32
// sum_k s_k * a_k over the (dy, dx, cin) im2col of the zero-padded codes,
// converted to f32, then acc * div + bias. The codes must already sit on
// one grid; the wrapper folds a per-channel Mul_prev into them and its
// uniform step into div. The TPU kernel's plane-by-plane AND + popcount
// becomes one int8 product on the tensor cores (mma.sync m16n8k32, u8
// codes times s8 +-1, s32 accumulate), which forms the same integer sum.
//
// What bounds it on the H100: at the detector's shapes (B = 4, Cin <= 128,
// K = 9 * Cin <= 1152) neither the bytes (one uint8 read per input element,
// one write per output) nor the int8 tensor-core rate, but latency, as for
// the dot conv kernel: one warp issues mma.sync far below a tensor core's
// rate, so a layer needs many warps in flight; the block's staging (a
// global round trip of raw codes by cp.async) and the epilogue come on top
// of the launch.
//
// Design: the dot conv kernel's (w1a8_conv3x3.cu), with the grid, warp
// tile and shared memory from kernels/w1a8_conv/geometry.py (accum
// "popcount"). The block stages the rows + 2 padded input rows it needs as
// raw codes, the pair words of its channels and the offsets of the
// window's units; each warp item runs WM M tiles of 16 outputs by WN N
// tiles of 8 channels through w1a8::conv3x3_imma_tile, shared with the
// fused conv+pool kernel, then w1a8::store_conv_tile.
#include "w1a8_common.cuh"

namespace {

constexpr int kMaxThreads = 256;

template <int WM, int WN>
__global__ void __launch_bounds__(kMaxThreads)
conv3x3_popcount_kernel(const uint8_t* __restrict__ a,
                        const uint32_t* __restrict__ w,
                        const float* __restrict__ div,
                        const float* __restrict__ bias,
                        void* __restrict__ out, int h, int width, int cin,
                        int cout, int rows, int bn, int row_px,
                        float out_step, int quant) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int co0 = blockIdx.x * bn;
  const int y0 = blockIdx.y * rows;
  const int b = blockIdx.z;
  const int n_rows = min(rows, h - y0);
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
                        y0 - 1, n_rows + 2, h, width, cin, row_px);
  w1a8::stage_unit_offsets(uoff, cin, row_stride);
  w1a8::cp_async_wait_all();
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int m_blk = n_rows * width;
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
      a_off[mt] = (i / width) * row_stride + (i % width) * ps;
    }
    int acc[WM][WN][4];
    w1a8::conv3x3_imma_tile<WM, WN>(act, a_off, uoff, units, wsm, bn, col0,
                                    acc);
    w1a8::store_conv_tile<WM, WN>(acc, div, bias, out, b, h, width, cout,
                                  y0, co0 + col0, m0, m_blk, out_step, quant);
  }
}

// The kernel's instantiation for warp tile (wm, wn), or nullptr.
auto pick(int wm, int wn) -> decltype(&conv3x3_popcount_kernel<1, 1>) {
  switch (wm * 10 + wn) {
    case 11: return conv3x3_popcount_kernel<1, 1>;
    case 12: return conv3x3_popcount_kernel<1, 2>;
    case 14: return conv3x3_popcount_kernel<1, 4>;
    case 21: return conv3x3_popcount_kernel<2, 1>;
    case 22: return conv3x3_popcount_kernel<2, 2>;
    case 24: return conv3x3_popcount_kernel<2, 4>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// a (b, h, width, cin) uint8 codes on one grid; w (ceil(9 * cin / 32),
// cout) sign words; div and bias (cout,) f32; out (b, h, width, cout),
// uint8 codes when quant != 0, else f32. The launch geometry is
// w1a8_conv3x3's, from kernels/w1a8_conv/geometry.py with accum
// "popcount"; one that does not cover the output exactly or does not hold
// the block's staging is refused with cudaErrorInvalidValue. Returns
// cudaGetLastError() otherwise.
int w1a8_conv3x3_popcount(const void* a, const void* w, const void* div,
                          const void* bias, void* out, int b, int h,
                          int width, int cin, int cout, int rows,
                          float out_step, int quant, int grid_x, int grid_y,
                          int bn, int wm, int wn, int row_px, int threads,
                          int smem, void* stream) {
  if (rows < 1 || bn < 8 * wn || bn % (8 * wn) ||
      grid_x * bn < cout || (grid_x - 1) * bn >= cout ||
      grid_y * rows < h || (grid_y - 1) * rows >= h || threads < 32 ||
      threads > kMaxThreads || threads % 32 || row_px < width + 2 ||
      !pick(wm, wn) || smem < 0 ||
      static_cast<size_t>(smem) <
          w1a8::popcount_conv_smem(cin, bn, rows + 2, row_px)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel = pick(wm, wn);
  cudaError_t err = w1a8::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(grid_x, grid_y, b), threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint32_t*>(w),
      static_cast<const float*>(div), static_cast<const float*>(bias), out,
      h, width, cin, cout, rows, bn, row_px, out_step, quant);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
