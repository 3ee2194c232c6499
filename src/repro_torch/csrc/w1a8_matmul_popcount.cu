// Binary-domain W1A8 matmul: the exact int32 sum of uint8 codes against
// packed 1-bit weights (what the TPU kernel forms with AND + popcount over
// the codes' 8 bit-planes), then the Div/bias epilogue and, when
// requested, the requant to uint8 codes.
//
// Replaces the TPU kernel
// repro/kernels/w1a8_matmul/kernel.py::w1a8_matmul_popcount_pallas
// (_popcount_matmul_kernel, _xnor_accumulate, _pack_act_bitplane): exact
// int32 sum_k s_k * a_k, converted to f32, then acc * div + bias. The codes
// must already sit on one grid; the wrapper folds a per-channel Mul_prev
// into them and its uniform step into div. The TPU kernel's plane-by-plane
// AND + popcount becomes one int8 product on the tensor cores (mma.sync
// m16n8k32, u8 codes times s8 +-1, s32 accumulate), which forms the same
// integer sum: |acc| <= 255 * k stays far inside int32 and, below 2^24,
// converts to f32 exactly.
//
// What bounds it on the H100: at the detector's conv9 (M = 4 * 100,
// K = 128, N = 64) the call moves about 80 KB, a bound of some 23 ns, so
// its time is latency, as for the dot matmul: the launch, the round trip
// of its loads, the chain of dependent mma.sync, the epilogue.
//
// Design: the dot matmul's (w1a8_matmul.cu), with the same geometry from
// kernels/w1a8_matmul/geometry.py and no prologue: per span of 128 codes
// of K each lane loads its 16 codes of each of its rows and one sign word
// per column (w1a8::load_span); the code words are the A registers of its
// mma.sync as loaded (w1a8::matmul_imma_tile). The two warps of an item
// add their int32 sums in a fixed order (w1a8::reduce_split), exactly, and
// each stores its half of the outputs (w1a8::store_tile).
//
// The grouped entry runs the same product for a stack of experts in one
// launch (the MoE FFN's packed experts: the reference's
// einsum("etk,ekn->etn") over quantize_act codes and signs, moe.py:62-69),
// one expert a grid z index, each expert's rows from its count on written
// as zeros without reading its weights.
#include "w1a8_common.cuh"

namespace {

using w1a8::kLaneCodes;
using w1a8::kMatmulThreads;
using w1a8::kSplit;

// One block per SM at the least: without it ptxas held some
// instantiations to 80 registers and spilled.
template <int WM, int WN>
__global__ void __launch_bounds__(kMatmulThreads, 1)
matmul_popcount_kernel(const uint8_t* __restrict__ a,
                       const uint32_t* __restrict__ w,
                       const float* __restrict__ div,
                       const float* __restrict__ bias,
                       void* __restrict__ out, int m, int k, int n, int bn,
                       float out_step, int quant) {
  __shared__ int red[kMatmulThreads * WM * WN * 4];
  const int lane = threadIdx.x & 31;
  const int q = (threadIdx.x / 32) % kSplit;
  const int row0 = blockIdx.x * 16 * WM;
  const int m_blk = min(16 * WM, m - row0);
  const int col = blockIdx.y * bn + (threadIdx.x / 32 / kSplit) * 8 * WN;
  const bool vec = k % 16 == 0 && (reinterpret_cast<uintptr_t>(a) & 15) == 0;
  float dv[WN][2], bs[WN][2];
  w1a8::lane_constants<WN>(div, bias, col, n, dv, bs);
  const uint8_t* rows[WM][2];
  w1a8::row_pointers<WM>(a, k, row0, m_blk, rows);
  int acc[WM][WN][4] = {};
  for (int s = 0; s * w1a8::kSpan < k; ++s) {
    uint32_t code[WM][2][kLaneCodes / 4], word[WN];
    w1a8::load_span<WM, WN>(rows, w, k, n, s, q, col + (lane >> 2), vec, code,
                            word);
    w1a8::matmul_imma_tile<WM, WN>(code, word, q, acc);
  }
  w1a8::reduce_split(acc, red);
  w1a8::store_tile<WM, WN, kSplit>(acc, dv, bs, out, row0, 0, m_blk, n, col,
                                   out_step, quant, q);
}

// The grouped form: blockIdx.z is the expert e, whose operands sit at
// a + e * cap * k, w + e * ceil(k / 32) * n, div, bias + e * n and out +
// e * cap * n. The expert holds counts[e] rows (clamped to [0, cap]): a
// block computes the rows it holds of them as the 2-D kernel does and
// writes its rows from counts[e] on as zeros, so a block past the count
// reads no weight word, and an expert with no row reads none. The count
// is read on the device: no host sync. Every test that returns early is
// uniform over the block, ahead of reduce_split's barrier.
template <int WM, int WN>
__global__ void __launch_bounds__(kMatmulThreads, 1)
matmul_popcount_grouped_kernel(const uint8_t* __restrict__ a,
                               const uint32_t* __restrict__ w,
                               const float* __restrict__ div,
                               const float* __restrict__ bias,
                               const int* __restrict__ counts,
                               float* __restrict__ out, int cap, int k, int n,
                               int bn) {
  __shared__ int red[kMatmulThreads * WM * WN * 4];
  const int e = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int q = (threadIdx.x / 32) % kSplit;
  const int row0 = blockIdx.x * 16 * WM;
  const int rows_blk = min(16 * WM, cap - row0);
  const int held = min(max(__ldg(counts + e), 0), cap);
  const int m_blk = max(min(rows_blk, held - row0), 0);
  float* out_e = out + static_cast<size_t>(e) * cap * n;
  if (m_blk < rows_blk) {
    const int c0 = blockIdx.y * bn;
    const int cols = min(bn, n - c0);
    for (int i = threadIdx.x; i < (rows_blk - m_blk) * cols; i += blockDim.x) {
      out_e[static_cast<size_t>(row0 + m_blk + i / cols) * n + c0 +
            i % cols] = 0.f;
    }
  }
  if (m_blk == 0) return;
  const uint8_t* a_e = a + static_cast<size_t>(e) * cap * k;
  const uint32_t* w_e = w + static_cast<size_t>(e) * w1a8::words_of(k) * n;
  const int col = blockIdx.y * bn + (threadIdx.x / 32 / kSplit) * 8 * WN;
  const bool vec =
      k % 16 == 0 && (reinterpret_cast<uintptr_t>(a_e) & 15) == 0;
  float dv[WN][2], bs[WN][2];
  w1a8::lane_constants<WN>(div + static_cast<size_t>(e) * n,
                           bias + static_cast<size_t>(e) * n, col, n, dv, bs);
  const uint8_t* rows[WM][2];
  w1a8::row_pointers<WM>(a_e, k, row0, m_blk, rows);
  int acc[WM][WN][4] = {};
  for (int s = 0; s * w1a8::kSpan < k; ++s) {
    uint32_t code[WM][2][kLaneCodes / 4], word[WN];
    w1a8::load_span<WM, WN>(rows, w_e, k, n, s, q, col + (lane >> 2), vec,
                            code, word);
    w1a8::matmul_imma_tile<WM, WN>(code, word, q, acc);
  }
  w1a8::reduce_split(acc, red);
  w1a8::store_tile<WM, WN, kSplit>(acc, dv, bs, out_e, row0, 0, m_blk, n, col,
                                   1.f, 0, q);
}

struct Kernels {
  template <int WM, int WN>
  static auto get() { return matmul_popcount_kernel<WM, WN>; }
};

struct GroupedKernels {
  template <int WM, int WN>
  static auto get() { return matmul_popcount_grouped_kernel<WM, WN>; }
};

}  // namespace

extern "C" {

// a (m, k) uint8 codes on one grid; w (ceil(k / 32), n) sign words; div and
// bias (n,) f32; out (m, n), uint8 codes when quant != 0, else f32. The
// launch geometry is w1a8_matmul's, from kernels/w1a8_matmul/geometry.py;
// one that does not cover the output exactly is refused with
// cudaErrorInvalidValue. Returns cudaGetLastError() otherwise.
int w1a8_matmul_popcount(const void* a, const void* w, const void* div,
                         const void* bias, void* out, int m, int k, int n,
                         float out_step, int quant, int grid_x, int grid_y,
                         int bm, int bn, int wm, int wn, int threads,
                         void* stream) {
  const auto kernel = w1a8::pick_matmul<Kernels, 11>(wm, wn);
  if (!kernel || !w1a8::matmul_geometry_ok(m, k, n, grid_x, grid_y, bm, bn,
                                           wm, wn, threads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  kernel<<<dim3(grid_x, grid_y), threads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint32_t*>(w),
      static_cast<const float*>(div), static_cast<const float*>(bias), out,
      m, k, n, bn, out_step, quant);
  return static_cast<int>(cudaGetLastError());
}

// The grouped entry: a (experts, cap, k) uint8 codes on one grid; w
// (experts, ceil(k / 32), n) sign words; div and bias (experts, n) f32;
// counts (experts,) int32, the rows each expert holds; out (experts, cap,
// n) f32, rows from counts[e] on written as zeros. One launch for every
// expert: the 2-D geometry of (cap, n) with the experts on grid z. A
// geometry that does not cover one expert's output exactly, or an expert
// count past grid z's limit, is refused with cudaErrorInvalidValue.
int w1a8_matmul_popcount_grouped(const void* a, const void* w,
                                 const void* div, const void* bias,
                                 const void* counts, void* out, int experts,
                                 int cap, int k, int n, int grid_x,
                                 int grid_y, int bm, int bn, int wm, int wn,
                                 int threads, void* stream) {
  const auto kernel = w1a8::pick_matmul<GroupedKernels, 11>(wm, wn);
  if (!kernel || experts < 1 || experts > 65535 ||
      !w1a8::matmul_geometry_ok(cap, k, n, grid_x, grid_y, bm, bn, wm, wn,
                                threads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  kernel<<<dim3(grid_x, grid_y, experts), threads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint32_t*>(w),
      static_cast<const float*>(div), static_cast<const float*>(bias),
      static_cast<const int*>(counts), static_cast<float*>(out), cap, k, n,
      bn);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
