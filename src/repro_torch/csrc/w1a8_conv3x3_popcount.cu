// Binary-domain W1A8 3x3 SAME conv: uint8 codes contracted against packed
// 1-bit weights with AND + popcount over the codes' 8 bit-planes (the
// paper's FPGA PE XNOR tree), then Div/bias and, when requested, the
// requant to uint8 codes.
//
// Replaces the popcount body of the TPU kernel
// repro/kernels/w1a8_conv/kernel.py::w1a8_conv3x3_pallas
// (_conv_popcount_kernel, through _xnor_accumulate): exact int32
// sum_k s_k * a_k over the (dy, dx, cin) im2col of the zero-padded codes,
// converted to f32, then acc * div + bias. The codes must already sit on
// one grid; the wrapper folds a per-channel Mul_prev into them and its
// uniform step into div.
//
// What bounds it on the H100: the inner loop's instruction rate on the
// CUDA cores, far above the memory bound (one uint8 read per input
// element, one write per output). Per 32 K-lanes of one output it issues
// 8 ballots and 8 AND + 2 popc.
//
// Design: one block per (Cout tile of 32, `rows` output rows, image), the
// rows + 2 padded input rows staged in shared memory as raw codes beside
// the tile's sign words, and a warp per output pixel: lane l loads the code of K lane l of each word, __ballot_sync
// turns the 32 codes into the 8 plane words every lane needs, and each lane
// ANDs them with its own output channel's sign word. The accumulation and
// epilogue live in w1a8_common.cuh, shared with the fused conv+pool kernel.
#include "w1a8_common.cuh"

namespace {

constexpr int kCoutTile = 32;  // one warp spans the tile: lane = column
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
conv3x3_popcount_kernel(const uint8_t* __restrict__ a,
                        const uint32_t* __restrict__ w,
                        const float* __restrict__ div,
                        const float* __restrict__ bias,
                        void* __restrict__ out, int h, int width, int cin,
                        int cout, int rows, float out_step, int quant) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int co0 = blockIdx.x * kCoutTile;
  const int y0 = blockIdx.y * rows;
  const int b = blockIdx.z;
  const int n_words = (9 * cin + w1a8::kPack - 1) / w1a8::kPack;
  const int row_len = (width + 2) * cin;

  uint32_t* wsm = reinterpret_cast<uint32_t*>(smem);
  uint8_t* act = smem + sizeof(uint32_t) * n_words * kCoutTile;
  const uint8_t* a_img = a + static_cast<size_t>(b) * h * width * cin;
  w1a8::stage_words(w, wsm, n_words, cout, co0, kCoutTile);
  w1a8::stage_codes(a_img, act, y0 - 1, rows + 2, h, width, cin);
  __syncthreads();

  // n_out and the stride are multiples of 32, so a warp walks the loop
  // together, as the ballots need; a lane past cout computes (on zero sign
  // words) and stores nothing.
  const int n_out = rows * width * kCoutTile;
  for (int i = threadIdx.x; i < n_out; i += blockDim.x) {
    const int col = i % kCoutTile;
    const int x = (i / kCoutTile) % width;
    const int r = i / (kCoutTile * width);
    const int co = co0 + col;
    const bool live = co < cout;
    const float v = w1a8::conv3x3_popcount_output(
        act + r * row_len, row_len, x, cin, wsm, kCoutTile, col,
        live ? __ldg(div + co) : 1.f, live ? __ldg(bias + co) : 0.f,
        quant != 0, out_step);
    if (!live) continue;
    const size_t o =
        ((static_cast<size_t>(b) * h + y0 + r) * width + x) * cout + co;
    if (quant) {
      static_cast<uint8_t*>(out)[o] = static_cast<uint8_t>(v);
    } else {
      static_cast<float*>(out)[o] = v;
    }
  }
}

}  // namespace

extern "C" {

// a (b, h, width, cin) uint8 codes on one grid; w (ceil(9 * cin / 32),
// cout) sign words; div and bias (cout,) f32; out (b, h, width, cout),
// uint8 codes when quant != 0, else f32. h % rows == 0.
// Returns cudaGetLastError().
int w1a8_conv3x3_popcount(const void* a, const void* w, const void* div,
                          const void* bias, void* out, int b, int h,
                          int width, int cin, int cout, int rows,
                          float out_step, int quant, void* stream) {
  const int n_words = (9 * cin + w1a8::kPack - 1) / w1a8::kPack;
  const size_t smem = sizeof(uint32_t) * n_words * kCoutTile +
                      sizeof(uint8_t) * (rows + 2) * (width + 2) * cin;
  cudaError_t err = w1a8::allow_smem(conv3x3_popcount_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((cout + kCoutTile - 1) / kCoutTile, h / rows, b);
  conv3x3_popcount_kernel<<<grid, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint32_t*>(w),
      static_cast<const float*>(div), static_cast<const float*>(bias), out,
      h, width, cin, cout, rows, out_step, quant);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
