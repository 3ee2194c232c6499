// W1A8 matmul: uint8 codes times packed 1-bit weights, with the Mul_prev
// prologue and the Div/bias/requant epilogue fused.
//
// Replaces the TPU kernel
// repro/kernels/w1a8_matmul/kernel.py::w1a8_matmul_pallas (_matmul_kernel,
// _unpack_tile): y = (bf16(a * mul) @ +-1) accumulated in f32, then
// y * div + bias, then optionally the requant to uint8 codes.
//
// What bounds it on the H100: at the detector's conv9 (M = 4 * 100,
// K = 128, N = 64) the call moves about 80 KB and does 6.6 M sign-adds, so
// its floor is a few microseconds and the launch itself dominates; the
// kernel keeps its own work small next to that.
//
// Design: one thread per output in a (32 columns x 8 rows) block, so the
// ragged M and N edges are masked in the kernel and nothing is padded to
// the TPU's 128 lanes. K is walked in chunks of `bk` (a multiple of 32):
// per chunk the block stages its 8 rows of codes as bf16(a * mul) and its
// 32 columns of sign words in shared memory, then each thread adds +-v for
// every k of the chunk, in increasing k, into an f32 accumulator.
#include "w1a8_common.cuh"

namespace {

constexpr int kTileN = 32;
constexpr int kTileM = 8;

__global__ void __launch_bounds__(kTileN * kTileM)
matmul_kernel(const uint8_t* __restrict__ a, const uint32_t* __restrict__ w,
              const float* __restrict__ mul, const float* __restrict__ div,
              const float* __restrict__ bias, void* __restrict__ out, int m,
              int k, int n, int bk, float out_step, int quant) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* wsm = reinterpret_cast<uint32_t*>(smem);
  __nv_bfloat16* asm_ = reinterpret_cast<__nv_bfloat16*>(
      smem + sizeof(uint32_t) * (bk / w1a8::kPack) * kTileN);

  const int tid = threadIdx.y * kTileN + threadIdx.x;
  const int nthreads = kTileN * kTileM;
  const int col = blockIdx.x * kTileN + threadIdx.x;
  const int row = blockIdx.y * kTileM + threadIdx.y;

  float acc = 0.f;
  for (int k0 = 0; k0 < k; k0 += bk) {
    const int kc = min(bk, k - k0);
    const int n_words = (kc + w1a8::kPack - 1) / w1a8::kPack;
    for (int i = tid; i < kTileM * kc; i += nthreads) {
      const int r = blockIdx.y * kTileM + i / kc;
      const int kk = k0 + i % kc;
      asm_[i] = r < m ? w1a8::prologue(a[static_cast<size_t>(r) * k + kk],
                                       __ldg(mul + kk))
                      : __float2bfloat16_rn(0.f);
    }
    for (int i = tid; i < n_words * kTileN; i += nthreads) {
      const int c = blockIdx.x * kTileN + i % kTileN;
      const int j = k0 / w1a8::kPack + i / kTileN;
      wsm[i] = c < n ? w[static_cast<size_t>(j) * n + c] : 0u;
    }
    __syncthreads();
    const __nv_bfloat16* arow = asm_ + threadIdx.y * kc;
    uint32_t word = 0;
    for (int kk = 0; kk < kc; ++kk) {
      if ((kk & (w1a8::kPack - 1)) == 0)
        word = wsm[(kk / w1a8::kPack) * kTileN + threadIdx.x];
      acc = w1a8::signed_add(acc, __bfloat162float(arow[kk]), word, kk);
    }
    __syncthreads();
  }
  if (row >= m || col >= n) return;
  const float v = w1a8::epilogue(acc, __ldg(div + col), __ldg(bias + col),
                                 quant != 0, out_step);
  const size_t o = static_cast<size_t>(row) * n + col;
  if (quant) {
    static_cast<uint8_t*>(out)[o] = static_cast<uint8_t>(v);
  } else {
    static_cast<float*>(out)[o] = v;
  }
}

}  // namespace

extern "C" {

// a (m, k) uint8; w (ceil(k / 32), n) sign words; mul (k,), div and bias
// (n,) f32; out (m, n), uint8 codes when quant != 0, else f32. bk is a
// positive multiple of 32. Returns cudaGetLastError().
int w1a8_matmul(const void* a, const void* w, const void* mul, const void* div,
                const void* bias, void* out, int m, int k, int n, int bk,
                float out_step, int quant, void* stream) {
  const size_t smem = sizeof(uint32_t) * (bk / w1a8::kPack) * kTileN +
                      sizeof(__nv_bfloat16) * kTileM * bk;
  cudaError_t err = w1a8::allow_smem(matmul_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(kTileN, kTileM);
  const dim3 grid((n + kTileN - 1) / kTileN, (m + kTileM - 1) / kTileM);
  matmul_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint32_t*>(w),
      static_cast<const float*>(mul), static_cast<const float*>(div),
      static_cast<const float*>(bias), out, m, k, n, bk, out_step, quant);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
