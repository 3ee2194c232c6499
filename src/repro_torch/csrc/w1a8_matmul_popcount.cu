// Binary-domain W1A8 matmul: uint8 codes contracted against packed 1-bit
// weights with AND + popcount over the codes' 8 bit-planes, then the
// Div/bias epilogue and, when requested, the requant to uint8 codes.
//
// Replaces the TPU kernel
// repro/kernels/w1a8_matmul/kernel.py::w1a8_matmul_popcount_pallas
// (_popcount_matmul_kernel, _xnor_accumulate, _pack_act_bitplane): exact
// int32 sum_k s_k * a_k, converted to f32, then acc * div + bias. The codes
// must already sit on one grid; the wrapper folds a per-channel Mul_prev
// into them and its uniform step into div.
//
// What bounds it on the H100: at the detector's conv9 (M = 4 * 100,
// K = 128, N = 64) the call moves about 60 KB, so the launch itself
// dominates, as for the dot matmul.
//
// Design: one thread per output in a (32 columns x 8 rows) block, a warp
// per row, so the ragged M and N edges are masked in the kernel and nothing
// is padded. Per 32-lane K word, lane l loads the row's code at K lane l
// (a coalesced 32-byte read, 0 past K), __ballot_sync turns the 32 codes
// into the 8 plane words, and each lane ANDs them with its column's sign
// word (w1a8::popcount_word).
#include "w1a8_common.cuh"

namespace {

constexpr int kTileN = 32;  // one warp spans the tile: lane = column
constexpr int kTileM = 8;

__global__ void __launch_bounds__(kTileN * kTileM)
matmul_popcount_kernel(const uint8_t* __restrict__ a,
                       const uint32_t* __restrict__ w,
                       const float* __restrict__ div,
                       const float* __restrict__ bias,
                       void* __restrict__ out, int m, int k, int n,
                       float out_step, int quant) {
  const int lane = threadIdx.x;
  const int col = blockIdx.x * kTileN + lane;
  const int row = blockIdx.y * kTileM + threadIdx.y;
  if (row >= m) return;  // the whole warp: it spans one row
  const uint8_t* arow = a + static_cast<size_t>(row) * k;
  const bool live = col < n;
  const int n_words = (k + w1a8::kPack - 1) / w1a8::kPack;
  int acc = 0;
  for (int j = 0; j < n_words; ++j) {
    const int kk = j * w1a8::kPack + lane;
    const uint32_t code = kk < k ? arow[kk] : 0u;
    const uint32_t word =
        live ? __ldg(w + static_cast<size_t>(j) * n + col) : 0u;
    acc = w1a8::popcount_word(acc, code, word);
  }
  if (!live) return;
  const float v = w1a8::epilogue(static_cast<float>(acc), __ldg(div + col),
                                 __ldg(bias + col), quant != 0, out_step);
  const size_t o = static_cast<size_t>(row) * n + col;
  if (quant) {
    static_cast<uint8_t*>(out)[o] = static_cast<uint8_t>(v);
  } else {
    static_cast<float*>(out)[o] = v;
  }
}

}  // namespace

extern "C" {

// a (m, k) uint8 codes on one grid; w (ceil(k / 32), n) sign words; div and
// bias (n,) f32; out (m, n), uint8 codes when quant != 0, else f32.
// Returns cudaGetLastError().
int w1a8_matmul_popcount(const void* a, const void* w, const void* div,
                         const void* bias, void* out, int m, int k, int n,
                         float out_step, int quant, void* stream) {
  const dim3 block(kTileN, kTileM);
  const dim3 grid((n + kTileN - 1) / kTileN, (m + kTileM - 1) / kTileM);
  matmul_popcount_kernel<<<grid, block, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint32_t*>(w),
      static_cast<const float*>(div), static_cast<const float*>(bias), out,
      m, k, n, out_step, quant);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
