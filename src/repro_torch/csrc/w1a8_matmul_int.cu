// Exact integer W1A8 matmul: int32 sum_k s_k * a_k for uint8 codes and
// packed 1-bit weights, on the int8 tensor cores.
//
// Replaces the TPU kernel
// repro/kernels/w1a8_matmul/kernel.py::w1a8_matmul_int_pallas (_int_kernel):
// (a - 128) fits int8, so the TPU contracts it on the int8 MXU against the
// unpacked signs and adds the zero-point correction 128 * colsum[n],
// colsum[n] = sum_k sign[k, n], in its last K step. Hopper's int8 mma.sync
// takes unsigned codes as they are (u8 * s8, s32 accumulate), so this
// kernel forms sum_k s_k * a_k directly, the same integer, and needs no
// correction: it does not read colsum.
//
// What bounds it on the H100: at the detector's conv9 (M = 4 * 100,
// K = 128, N = 64) the call moves about 155 KB, two thirds of it the
// int32 output, a bound of some 46 ns, so
// its time is latency, as for the popcount matmul: the launch, the round
// trip of its loads, the chain of dependent mma.sync, the store.
//
// Design: the popcount matmul's (w1a8_matmul_popcount.cu), tile for tile,
// with the same geometry from kernels/w1a8_matmul/geometry.py
// (matmul_launch(m, n, "popcount")): per span of 128 codes of K each lane
// loads its 16 codes of each of its rows and one sign word per column
// (w1a8::load_span), the code words are the A registers of its mma.sync
// (w1a8::matmul_imma_tile), the two warps of an item add their int32 sums
// in a fixed order (w1a8::reduce_split), and each stores its half of the
// sums with no epilogue (w1a8::store_int_tile). |sum| <= 255 * k stays far
// inside int32.
#include "w1a8_common.cuh"

namespace {

using w1a8::kLaneCodes;
using w1a8::kMatmulThreads;
using w1a8::kSplit;

// One block per SM at the least, as the other matmuls: no spill.
template <int WM, int WN>
__global__ void __launch_bounds__(kMatmulThreads, 1)
matmul_int_kernel(const uint8_t* __restrict__ a,
                  const uint32_t* __restrict__ w, int* __restrict__ out,
                  int m, int k, int n, int bn) {
  __shared__ int red[kMatmulThreads * WM * WN * 4];
  const int lane = threadIdx.x & 31;
  const int q = (threadIdx.x / 32) % kSplit;
  const int row0 = blockIdx.x * 16 * WM;
  const int m_blk = min(16 * WM, m - row0);
  const int col = blockIdx.y * bn + (threadIdx.x / 32 / kSplit) * 8 * WN;
  const bool vec = k % 16 == 0 && (reinterpret_cast<uintptr_t>(a) & 15) == 0;
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
  w1a8::store_int_tile<WM, WN, kSplit>(acc, out, row0, m_blk, n, col, q);
}

struct Kernels {
  template <int WM, int WN>
  static auto get() { return matmul_int_kernel<WM, WN>; }
};

}  // namespace

extern "C" {

// a (m, k) uint8; w (ceil(k / 32), n) sign words; out (m, n) int32. The
// launch geometry is the popcount matmul's, from
// kernels/w1a8_matmul/geometry.py; one that does not cover the output
// exactly is refused with cudaErrorInvalidValue. Returns cudaGetLastError()
// otherwise.
int w1a8_matmul_int(const void* a, const void* w, void* out, int m, int k,
                    int n, int grid_x, int grid_y, int bm, int bn, int wm,
                    int wn, int threads, void* stream) {
  const auto kernel = w1a8::pick_matmul<Kernels, 11>(wm, wn);
  if (!kernel || !w1a8::matmul_geometry_ok(m, k, n, grid_x, grid_y, bm, bn,
                                           wm, wn, threads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  kernel<<<dim3(grid_x, grid_y), threads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint32_t*>(w),
      static_cast<int*>(out), m, k, n, bn);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
