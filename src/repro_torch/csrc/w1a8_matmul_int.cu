// Exact integer W1A8 matmul: int32 sum_k s_k * a_k for uint8 codes and
// packed 1-bit weights, formed as int8 (a - 128) * (+-1) plus 128 * colsum.
//
// Replaces the TPU kernel
// repro/kernels/w1a8_matmul/kernel.py::w1a8_matmul_int_pallas (_int_kernel):
// (a - 128) fits int8, so the TPU contracts it on the int8 MXU against the
// unpacked signs and adds the zero-point correction 128 * colsum[n],
// colsum[n] = sum_k sign[k, n], in its last K step.
//
// What bounds it on the H100: at conv9's shape (M = 400, K = 128, N = 64)
// the call moves about 60 KB and does 3.3 M multiply-adds, so the launch
// dominates; the int8 tensor cores (mma.sync) are later work.
//
// Design: one thread per output in a (32 columns x 8 rows) block, a warp
// per row: the row's codes are broadcast reads, the sign words of 32
// neighbouring columns one coalesced read per K word. Each word's 32 signs
// go four at a time through __dp4a: the four codes as int8 (a - 128) bytes
// against the four signs as int8 +-1 bytes, accumulated in int32. Ragged
// M, N and K are masked in the kernel.
#include "w1a8_common.cuh"

namespace {

constexpr int kTileN = 32;
constexpr int kTileM = 8;

// Four sign bits (bit i = 1 <=> +1) as four int8 bytes, +1 or -1.
__device__ __forceinline__ int signs4(uint32_t bits) {
  uint32_t s = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s |= (((bits >> i) & 1u) ? 0x01u : 0xFFu) << (8 * i);
  }
  return static_cast<int>(s);
}

// Four codes a[0..3] as four int8 bytes (a - 128); lanes past k are zero
// bytes, which add nothing.
__device__ __forceinline__ int centred4(const uint8_t* a, int valid) {
  uint32_t s = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t c = i < valid ? (static_cast<uint32_t>(a[i]) ^ 0x80u) : 0u;
    s |= c << (8 * i);
  }
  return static_cast<int>(s);
}

__global__ void __launch_bounds__(kTileN * kTileM)
matmul_int_kernel(const uint8_t* __restrict__ a,
                  const uint32_t* __restrict__ w,
                  const int* __restrict__ colsum, int* __restrict__ out,
                  int m, int k, int n) {
  const int col = blockIdx.x * kTileN + threadIdx.x;
  const int row = blockIdx.y * kTileM + threadIdx.y;
  if (row >= m || col >= n) return;
  const uint8_t* arow = a + static_cast<size_t>(row) * k;
  int acc = 0;
  for (int k0 = 0; k0 < k; k0 += w1a8::kPack) {
    const uint32_t word =
        __ldg(w + static_cast<size_t>(k0 / w1a8::kPack) * n + col);
    for (int i = 0; i < w1a8::kPack && k0 + i < k; i += 4) {
      acc = __dp4a(centred4(arow + k0 + i, k - k0 - i), signs4(word >> i),
                   acc);
    }
  }
  out[static_cast<size_t>(row) * n + col] = acc + 128 * __ldg(colsum + col);
}

}  // namespace

extern "C" {

// a (m, k) uint8; w (ceil(k / 32), n) sign words; colsum (n,) int32 =
// sum_{k' < k} sign[k', n]; out (m, n) int32. Returns cudaGetLastError().
int w1a8_matmul_int(const void* a, const void* w, const void* colsum,
                    void* out, int m, int k, int n, void* stream) {
  const dim3 block(kTileN, kTileM);
  const dim3 grid((n + kTileN - 1) / kTileN, (m + kTileM - 1) / kTileM);
  matmul_int_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint32_t*>(w),
      static_cast<const int*>(colsum), static_cast<int*>(out), m, k, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
