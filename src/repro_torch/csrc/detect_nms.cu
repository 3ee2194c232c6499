// Greedy per-class NMS of a batch of decoded detection heads, one block
// per image: the class argmax and max of every box, the score threshold,
// then max_out rounds of pick-the-best and suppress.
//
// Counterpart of repro/models/detection.py::nms, which the reference jits
// as a lax.fori_loop into the dispatch's executable (it is no Pallas
// kernel); its eager PyTorch twin is models/detection.py::nms_plain, 50
// rounds of small PyTorch ops. Both break argmax ties on the lowest index.
//
// What bounds it on the H100: at the detector's 320x320 bucket an image
// has N = 10 * 10 * 3 = 300 boxes of C = 20 class scores, some 120 KB for
// the 4 images of a dispatch, a bound far under a microsecond. The rounds
// depend on each other, so its time is latency: per round one block-wide
// argmax and one pass of N IoUs. The design keeps each round to two
// barriers and warp shuffles: the block's boxes (their corners and areas,
// as the plain version forms them), scores and classes sit in shared
// memory; each warp reduces its (score, index) pairs with shuffles, posts
// them, and after one barrier every warp reduces the posted pairs itself,
// so all threads learn the pick without a second barrier; the second
// barrier closes the round's suppression.
//
// Bit-exact with the plain version: each IoU is formed in float32 in
// iou_cxcywh's order of operations with every rounding spelled out
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn: no contraction into FMA),
// w / 2 as w * 0.5 (exact, and what PyTorch's CUDA division by a Python
// number does), minimum, maximum and clamp propagate NaN as PyTorch's do,
// and the thresholds compare in float32, as PyTorch's scalar promotion
// does. The outputs depend on the IoUs only through `iou > iou_thresh`.
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kNone = 0x7fffffff;  // index of an empty (score, index) slot

// torch.minimum / maximum / clamp: NaN in, NaN out.
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : (b < a ? b : a));
}
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : (b > a ? b : a));
}

// True when (v, i) beats (best, at): a higher score, or the same score at
// a lower index (argmax's first-index rule).
__device__ __forceinline__ bool beats(float v, int i, float best, int at) {
  return v > best || (v == best && i < at);
}

// The warp's best (score, index): every lane ends with it.
__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float vo = __shfl_xor_sync(0xffffffffu, v, off);
    const int io = __shfl_xor_sync(0xffffffffu, i, off);
    if (beats(vo, io, v, i)) {
      v = vo;
      i = io;
    }
  }
}

// Shared memory of one image's block: n floats each of the boxes' corners
// x1, y1, x2, y2, their areas and their scores, n class ids, then max_out
// picked indices and their scores.
__host__ __device__ constexpr size_t nms_smem(int n, int max_out) {
  return sizeof(float) * 6 * static_cast<size_t>(n) +
         sizeof(int) * static_cast<size_t>(n) +
         (sizeof(int) + sizeof(float)) * static_cast<size_t>(max_out);
}

__global__ void __launch_bounds__(kMaxThreads)
nms_kernel(const float* __restrict__ boxes, const float* __restrict__ scores,
           float* __restrict__ out_b, float* __restrict__ out_s,
           int* __restrict__ out_c, int n, int c, int max_out,
           float iou_thresh, float score_thresh) {
  extern __shared__ float smem[];
  float* x1 = smem;
  float* y1 = x1 + n;
  float* x2 = y1 + n;
  float* y2 = x2 + n;
  float* area = y2 + n;
  float* score = area + n;
  int* cls = reinterpret_cast<int*>(score + n);
  int* pick = cls + n;
  float* pick_s = reinterpret_cast<float*>(pick + max_out);
  __shared__ float post_v[kMaxWarps];
  __shared__ int post_i[kMaxWarps];

  const size_t img = blockIdx.x;
  const float* bx = boxes + img * n * 4;
  const float* sc = scores + img * n * c;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    // argmax and amax over the classes: the first maximum, NaN above all
    const float* s = sc + static_cast<size_t>(j) * c;
    float best = s[0];
    int at = 0;
    for (int k = 1; k < c; ++k) {
      const float x = s[k];
      if (best == best && (x > best || x != x)) {
        best = x;
        at = k;
      }
    }
    score[j] = best >= score_thresh ? best : 0.f;
    cls[j] = at;
    const float cx = bx[4 * j], cy = bx[4 * j + 1];
    const float hw = __fmul_rn(bx[4 * j + 2], 0.5f);
    const float hh = __fmul_rn(bx[4 * j + 3], 0.5f);
    const float a1 = __fsub_rn(cx, hw), b1 = __fsub_rn(cy, hh);
    const float a2 = __fadd_rn(cx, hw), b2 = __fadd_rn(cy, hh);
    x1[j] = a1;
    y1[j] = b1;
    x2[j] = a2;
    y2[j] = b2;
    area[j] = __fmul_rn(__fsub_rn(a2, a1), __fsub_rn(b2, b1));
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  for (int round = 0; round < max_out; ++round) {
    float v = -INFINITY;
    int i = kNone;
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      if (beats(score[j], j, v, i)) {
        v = score[j];
        i = j;
      }
    }
    warp_best(v, i);
    if (lane == 0) {
      post_v[warp] = v;
      post_i[warp] = i;
    }
    __syncthreads();
    v = lane < warps ? post_v[lane] : -INFINITY;
    i = lane < warps ? post_i[lane] : kNone;
    warp_best(v, i);
    const int j = i;
    if (threadIdx.x == 0) {
      pick[round] = j;
      pick_s[round] = v;
    }
    const float ax1 = x1[j], ay1 = y1[j], ax2 = x2[j], ay2 = y2[j];
    const float aa = area[j];
    const int cj = cls[j];
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      if (k == j) {
        score[k] = 0.f;
        continue;
      }
      const float iw =
          tmax(__fsub_rn(tmin(ax2, x2[k]), tmax(ax1, x1[k])), 0.f);
      const float ih =
          tmax(__fsub_rn(tmin(ay2, y2[k]), tmax(ay1, y1[k])), 0.f);
      const float inter = __fmul_rn(iw, ih);
      const float uni = __fsub_rn(__fadd_rn(aa, area[k]), inter);
      const float iou = __fdiv_rn(inter, tmax(uni, 1e-9f));
      if (iou > iou_thresh && cls[k] == cj) score[k] = 0.f;
    }
    __syncthreads();
  }

  // the picks, in order; an empty slot (score not > 0) keeps its box, as
  // the plain version does, with score 0 and class -1
  for (int t = threadIdx.x; t < max_out; t += blockDim.x) {
    const int j = pick[t];
    const float s = pick_s[t];
    const size_t o = img * max_out + t;
#pragma unroll
    for (int e = 0; e < 4; ++e) out_b[4 * o + e] = bx[4 * j + e];
    out_s[o] = s > 0.f ? s : 0.f;
    out_c[o] = s > 0.f ? cls[j] : -1;
  }
}

}  // namespace

extern "C" {

// boxes (batch, n, 4) cxcywh f32; scores (batch, n, c) f32; out_b
// (batch, max_out, 4) f32, out_s (batch, max_out) f32, out_c
// (batch, max_out) int32. One block of min(1024, n rounded up to a warp)
// threads per image. Refused with cudaErrorInvalidValue where an image's
// boxes do not fit in shared memory (n above about 7,000) or a size is
// not positive. Returns cudaGetLastError() otherwise.
int detect_nms(const void* boxes, const void* scores, void* out_b,
               void* out_s, void* out_c, int batch, int n, int c,
               int max_out, float iou_thresh, float score_thresh,
               void* stream) {
  const size_t smem = nms_smem(n, max_out);
  if (batch < 1 || n < 1 || c < 1 || max_out < 1 || smem > 232448) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = n >= kMaxThreads ? kMaxThreads : (n + 31) / 32 * 32;
  nms_kernel<<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const float*>(scores),
      static_cast<float*>(out_b), static_cast<float*>(out_s),
      static_cast<int*>(out_c), n, c, max_out, iou_thresh, score_thresh);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
