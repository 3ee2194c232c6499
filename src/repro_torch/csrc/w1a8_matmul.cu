// W1A8 matmul: uint8 codes times packed 1-bit weights, with the Mul_prev
// prologue and the Div/bias/requant epilogue fused.
//
// Replaces the TPU kernel
// repro/kernels/w1a8_matmul/kernel.py::w1a8_matmul_pallas (_matmul_kernel,
// _unpack_tile): y = (bf16(a * mul) @ +-1) accumulated in f32, then
// y * div + bias, then optionally the requant to uint8 codes. The TPU
// kernel's jnp.dot on the MXU becomes a GEMM on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulate).
//
// What bounds it on the H100: at the detector's conv9 (M = 4 * 100,
// K = 128, N = 64) the call moves about 80 KB and does 6.6 M operations,
// a bound of some 24 ns, so its time is latency: the launch, the round
// trip of its loads, the bf16 prologue of every code, the chain of
// dependent mma.sync, the epilogue. A first version that staged the
// block's rows in shared memory (a round trip, the prologue, a barrier,
// ldmatrix) measured 3.7 us there, above cuBLAS's 2.3 (PERF.md).
//
// Design: the launch geometry comes whole from the caller
// (kernels/w1a8_matmul/geometry.py): a block covers bm = 16 * WM rows and
// bn columns, in warp items of WM M tiles of 16 rows by WN N tiles of 8
// columns, each item's K split over two warps (w1a8::kSplit). Per span of
// 128 codes of K, each lane loads its 16 codes of each of its rows (one
// 16-byte load where K % 16 == 0 and the rows are aligned, a byte gather
// otherwise), their Mul_prev values and one sign word per column, all in
// flight together and with no shared memory (w1a8::load_span), then forms
// the prologue values in registers and runs its mma.sync
// (w1a8::matmul_mma_tile). The two warps add their partial sums in a fixed
// order through shared memory, each for the half of the item's outputs
// that it then stores (w1a8::reduce_split, w1a8::store_tile); the
// epilogue's Div and bias are loaded first. Every output sums its K in one
// order, whatever its row or tile, so the rows of a call on a prefix of M
// equal the full call's bit for bit.
#include "w1a8_common.cuh"

namespace {

using w1a8::kLaneCodes;
using w1a8::kMatmulThreads;
using w1a8::kSplit;

// One block per SM at the least: without it ptxas held some
// instantiations to 80 registers and spilled.
template <int WM, int WN>
__global__ void __launch_bounds__(kMatmulThreads, 1)
matmul_kernel(const uint8_t* __restrict__ a, const uint32_t* __restrict__ w,
              const float* __restrict__ mul, const float* __restrict__ div,
              const float* __restrict__ bias, void* __restrict__ out, int m,
              int k, int n, int bn, float out_step, int quant) {
  __shared__ float red[kMatmulThreads * WM * WN * 4];
  const int lane = threadIdx.x & 31;
  const int q = (threadIdx.x / 32) % kSplit;
  const int row0 = blockIdx.x * 16 * WM;
  const int m_blk = min(16 * WM, m - row0);
  const int col = blockIdx.y * bn + (threadIdx.x / 32 / kSplit) * 8 * WN;
  const bool vec = k % 16 == 0 && (reinterpret_cast<uintptr_t>(a) & 15) == 0;
  const bool vec_mul =
      k % 4 == 0 && (reinterpret_cast<uintptr_t>(mul) & 15) == 0;
  float dv[WN][2], bs[WN][2];
  w1a8::lane_constants<WN>(div, bias, col, n, dv, bs);
  const uint8_t* rows[WM][2];
  w1a8::row_pointers<WM>(a, k, row0, m_blk, rows);
  float acc[WM][WN][4] = {};
  for (int s = 0; s * w1a8::kSpan < k; ++s) {
    uint32_t code[WM][2][kLaneCodes / 4], word[WN];
    w1a8::load_span<WM, WN>(rows, w, k, n, s, q, col + (lane >> 2), vec, code,
                            word);
    float mv[kLaneCodes];
    const int kb = s * w1a8::kSpan + w1a8::kPack * (lane & 3) + kLaneCodes * q;
    w1a8::load_mul(mv, mul + kb, k - kb, vec_mul);
    w1a8::matmul_mma_tile<WM, WN>(code, mv, word, q, acc);
  }
  w1a8::reduce_split(acc, red);
  w1a8::store_tile<WM, WN, kSplit>(acc, dv, bs, out, row0, 0, m_blk, n, col,
                                   out_step, quant, q);
}

struct Kernels {
  template <int WM, int WN>
  static auto get() { return matmul_kernel<WM, WN>; }
};

}  // namespace

extern "C" {

// a (m, k) uint8; w (ceil(k / 32), n) sign words; mul (k,), div and bias
// (n,) f32; out (m, n), uint8 codes when quant != 0, else f32. The launch
// geometry (grid_x row blocks of bm = 16 * wm rows by grid_y column blocks
// of bn = 8 * wn * threads / 64 columns) comes from
// kernels/w1a8_matmul/geometry.py; one that does not cover the output
// exactly is refused with cudaErrorInvalidValue. Returns
// cudaGetLastError() otherwise.
int w1a8_matmul(const void* a, const void* w, const void* mul,
                const void* div, const void* bias, void* out, int m, int k,
                int n, float out_step, int quant, int grid_x, int grid_y,
                int bm, int bn, int wm, int wn, int threads, void* stream) {
  const auto kernel = w1a8::pick_matmul<Kernels, 14, 11>(wm, wn);
  if (!kernel || !w1a8::matmul_geometry_ok(m, k, n, grid_x, grid_y, bm, bn,
                                           wm, wn, threads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  kernel<<<dim3(grid_x, grid_y), threads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint32_t*>(w),
      static_cast<const float*>(mul), static_cast<const float*>(div),
      static_cast<const float*>(bias), out, m, k, n, bn, out_step, quant);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
