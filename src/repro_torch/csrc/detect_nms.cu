// Greedy per-class NMS of a batch of detection heads, one block per image,
// as a ranked, tiled sweep. Two entry points share the kernel:
// `detect_nms` takes decoded boxes and class scores, `detect_postprocess`
// takes the raw head and decodes it in the kernel's prologue, so a batch's
// whole post-processing is one launch.
//
// Counterparts: repro/models/detection.py::nms, a lax.fori_loop of max_out
// rounds of argmax and suppression, and ::postprocess, which the reference
// jits with decode_head into one executable (neither is a Pallas kernel).
// Their PyTorch twins here are models/detection.py::nms_plain and
// ::decode_head, the plain versions this kernel is held to bit for bit.
//
// The design. Scores only ever drop to 0, so the greedy loop visits the
// boxes of positive score in the order (score descending, index
// ascending) -- argmax with first-index ties -- skipping the suppressed
// ones, and once none is left every score is 0 and argmax returns box 0.
// So the kernel ranks the candidates once and sweeps the ranks in tiles of
// 32 instead of taking max_out dependent block-wide argmaxes:
//
// 1. Prologue, one to four threads a box (as many as a block of 1024
//    holds; each takes a share of the classes): the decode
//    (detect_postprocess), the class argmax and max with PyTorch's NaN
//    rule, the score threshold, the corners and the area, into shared
//    memory.
// 2. Rank by counting: each candidate's threads count the candidates that
//    beat it; the index of the box of rank r goes to slot[r].
// 3. Sweep, a tile of 32 ranks at a time, two barriers a tile. First a
//    warp per rank of the tile and a ballot per 32 candidate suppressors:
//    is the rank suppressed by a box kept in an earlier tile, and which
//    earlier ranks of its tile would suppress it if kept (its row mask).
//    Then one warp resolves the tile from the masks with ballots, lowest
//    undecided rank first: a rank is kept when it is alive and no kept
//    rank of the tile suppresses it. The sweep stops at max_out kept boxes
//    or after the last rank. Testing a tile's ranks against all boxes kept
//    so far (at most max_out), and not every later rank against each
//    tile's kept boxes, costs the served heads far fewer IoUs: they reach
//    50 kept boxes within two tiles of their 300 candidates.
// 4. Epilogue: slot t < kept writes kept box t, the others box 0 with
//    score 0 and class -1, as the greedy loop does once every score is 0.
//
// Only candidates of score > 0 are ranked. With score_thresh >= 0 every
// other score is 0 after the threshold, so the empty slots are box 0; a
// negative score_thresh would leave negative scores whose order the
// greedy loop keeps visiting, and is refused.
//
// Bit-exact with the plain versions: each IoU is formed in float32 in
// iou_cxcywh's order, the kept box as its first operand as in the greedy
// loop, with every rounding spelled out (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn: no contraction into FMA), w / 2 as w * 0.5, minimum, maximum
// and clamp with PyTorch's NaN rules, and the thresholds compared in
// float32. The decode follows PyTorch's CUDA ops: sigmoid as
// 1 / (1 + expf(-x)) with IEEE division and the accurate expf (build
// without --use_fast_math), division by the Python int grid as a product
// with the float reciprocal 1 / grid, clamp passing NaN, and box n of
// a G x G head at cell (y, x), anchor a, with n = (y * G + x) * 3 + a.
//
// Shared memory: 28 bytes a box (the slot, five floats of geometry, the
// class) and 8 a kept box, so an image may hold up to about 8,000 boxes;
// past that the entry points return cudaErrorInvalidValue.
#include <climits>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 1024;
// boxes a thread holds at most: the shared-memory limit caps n at
// 232448 / 28 < kMaxBoxesPerThread * kMaxThreads
constexpr int kMaxBoxesPerThread = 9;
constexpr int kAnchors = 3;
constexpr size_t kSmemPerBlock = 232448;
// held back for the static shared memory (the tile's row masks and the
// kept count: 132 bytes and their alignment)
constexpr size_t kStaticSmem = 256;
static_assert(kSmemPerBlock / 28 < kMaxBoxesPerThread * kMaxThreads,
              "a thread must hold every box the shared memory admits");

// torch.minimum / maximum / clamp: NaN in, NaN out.
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : (b < a ? b : a));
}
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : (b > a ? b : a));
}

// torch.sigmoid on a CUDA float: 1 / (1 + exp(-x)), the division by IEEE
// rules, which the correctly rounded reciprocal __frcp_rn gives as well.
__device__ __forceinline__ float sigmoid(float x) {
  return __frcp_rn(__fadd_rn(1.f, expf(-x)));
}

// argmax's order on (score, class) pairs: NaN above all, then the higher
// score, then the lower class. The best pair of a set under it is torch's
// argmax and amax: the first NaN, else the first maximum.
__device__ __forceinline__ bool better(float v, int i, float best, int at) {
  if (v != v) return best == best || i < at;
  if (best != best) return false;
  return v > best || (v == best && i < at);
}

// The best (score, class) among classes u, u + lanes, u + 2 * lanes, ...
// of one box, into (best, at); taken four at a time, so that their loads
// and sigmoids overlap.
template <class Scores>
__device__ __forceinline__ void best_class(const Scores& score, int c, int u,
                                           int lanes, float& best,
                                           int& at) {
  constexpr int kChunk = 4;
  for (int k0 = u; k0 < c; k0 += kChunk * lanes) {
    float x[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int k = k0 + i * lanes;
      x[i] = k < c ? score(k) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int k = k0 + i * lanes;
      if (k < c && better(x[i], k, best, at)) {
        best = x[i];
        at = k;
      }
    }
  }
}

// A source of boxes: box(img, j) is box j's cxcywh, scores(img, j) a
// callable that gives its score in class k; c classes.

// One box: cxcywh.
struct Box {
  float cx, cy, w, h;
};

// detect_nms: boxes (batch, n, 4) cxcywh, scores (batch, n, c).
struct Decoded {
  const float* boxes;
  const float* scores_;
  int n, c;

  struct Scores {
    const float* s;
    __device__ float operator()(int k) const { return s[k]; }
  };
  __device__ Box box(int img, int j) const {
    const float* p = boxes + (static_cast<size_t>(img) * n + j) * 4;
    return Box{p[0], p[1], p[2], p[3]};
  }
  __device__ Scores scores(int img, int j) const {
    return Scores{scores_ + (static_cast<size_t>(img) * n + j) * c};
  }
};

// detect_postprocess: the raw head (batch, grid, grid, 3 * (5 + c)),
// decoded as models/detection.py::decode_head does on the card.
struct RawHead {
  const float* raw;
  int grid, c;
  float inv_grid;  // 1 / grid in float32, what PyTorch multiplies by
  float aw[kAnchors], ah[kAnchors];

  struct Scores {
    const float* r;
    float obj;
    __device__ float operator()(int k) const {
      return __fmul_rn(obj, sigmoid(r[5 + k]));
    }
  };
  __device__ const float* at(int img, int j) const {
    const int n = grid * grid * kAnchors;
    return raw + (static_cast<size_t>(img) * n + j) * (5 + c);
  }
  __device__ Box box(int img, int j) const {
    const float* r = at(img, j);
    const int a = j % kAnchors, cell = j / kAnchors;
    const float x = static_cast<float>(cell % grid);
    const float y = static_cast<float>(cell / grid);
    // selects, not an index, keep the priors in registers
    const float pw = a == 0 ? aw[0] : (a == 1 ? aw[1] : aw[2]);
    const float ph = a == 0 ? ah[0] : (a == 1 ? ah[1] : ah[2]);
    return Box{__fmul_rn(__fadd_rn(sigmoid(r[0]), x), inv_grid),
               __fmul_rn(__fadd_rn(sigmoid(r[1]), y), inv_grid),
               __fmul_rn(pw, expf(tmin(tmax(r[2], -8.f), 8.f))),
               __fmul_rn(ph, expf(tmin(tmax(r[3], -8.f), 8.f)))};
  }
  __device__ Scores scores(int img, int j) const {
    const float* r = at(img, j);
    return Scores{r, sigmoid(r[4])};
  }
};

// A box as iou_cxcywh forms it: its corners and its area.
struct Corners {
  float x1, y1, x2, y2, area;
};

// iou_cxcywh(a, b) > thresh, box a first, as the greedy loop forms it with
// the kept box a. A NaN union makes the IoU NaN, which suppresses
// nothing, and a NaN corner makes its box's area and so the union NaN:
// past that test no operand was NaN, so fminf and fmaxf were
// torch.minimum, maximum and clamp (up to the sign of a zero, which
// `> thresh` does not see). Boxes that do not overlap skip the division:
// 0 over the clamped union is 0, and a zero dividend would take the IEEE
// division's slow path.
__device__ __forceinline__ bool suppresses(const Corners& a, const Corners& b,
                                           float thresh) {
  const float iw =
      fmaxf(__fsub_rn(fminf(a.x2, b.x2), fmaxf(a.x1, b.x1)), 0.f);
  const float ih =
      fmaxf(__fsub_rn(fminf(a.y2, b.y2), fmaxf(a.y1, b.y1)), 0.f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(a.area, b.area), inter);
  if (uni != uni) return false;
  if (inter == 0.f) return 0.f > thresh;
  return __fdiv_rn(inter, fmaxf(uni, 1e-9f)) > thresh;
}

// One image's shared memory, by box index j or by rank r:
//   slot[j]   box j's thresholded score (a float), until the ranking turns
//             slot[r] into the index of the box of rank r;
//   x1, y1, x2, y2, area [j]   the corners and area, as iou_cxcywh forms
//             them;
//   cls[j]    the best class;
//   keep[k], keep_cls[k]   the index and class of the k-th kept box
//             (min(max_out, n) of them).
struct Smem {
  float* score;
  int* slot;
  float *x1, *y1, *x2, *y2, *area;
  int* cls;
  int* keep;
  int* keep_cls;

  __device__ Smem(float* base, int n, int max_out) {
    score = base;
    slot = reinterpret_cast<int*>(base);
    x1 = base + n;
    y1 = x1 + n;
    x2 = y1 + n;
    y2 = x2 + n;
    area = y2 + n;
    cls = reinterpret_cast<int*>(area + n);
    keep = cls + n;
    keep_cls = keep + (max_out < n ? max_out : n);
  }

  __device__ __forceinline__ Corners corners(int j) const {
    return Corners{x1[j], y1[j], x2[j], y2[j], area[j]};
  }
};

__host__ __device__ constexpr size_t nms_smem(int n, int max_out) {
  return (sizeof(float) * 6 + sizeof(int)) * static_cast<size_t>(n) +
         2 * sizeof(int) * static_cast<size_t>(max_out < n ? max_out : n);
}

// Threads that share one box in the prologue and the ranking: as many as
// the block of at most 1024 threads holds, 1, 2 or 4.
__host__ __device__ constexpr int box_lanes(int n) {
  return n <= kMaxThreads / 4 ? 4 : (n <= kMaxThreads / 2 ? 2 : 1);
}

// The number of boxes that the greedy loop takes before box j (higher
// scores, and equal scores at lower indices), counted by lane u of the
// box's `lanes` over the float4 groups u, u + lanes, ...: groups wholly
// before j count scores >= v, groups wholly after it scores > v, and only
// the group that holds j compares indices; lane 0 also takes the n % 4
// scores past the last group. The lanes of a warp hold neighbouring boxes,
// so they take the same branch but near j.
__device__ int count_beating(const float* score, int n, int j, int u,
                             int lanes) {
  const float v = score[j];
  const float4* s4 = reinterpret_cast<const float4*>(score);
  const int groups = n >> 2, qj = j >> 2;
  int r = 0;
  for (int q = u; q < groups; q += lanes) {
    const float4 x = s4[q];
    if (q < qj) {
      r += (x.x >= v) + (x.y >= v) + (x.z >= v) + (x.w >= v);
    } else if (q > qj) {
      r += (x.x > v) + (x.y > v) + (x.z > v) + (x.w > v);
    } else {
      const float e[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int i = 4 * q + t;
        r += i < j ? e[t] >= v : (i > j && e[t] > v);
      }
    }
  }
  if (u == 0) {
    for (int i = 4 * groups; i < n; ++i) {
      r += i < j ? score[i] >= v : (i > j && score[i] > v);
    }
  }
  return r;
}

// The rows of the tile of ranks [base, base + 32), a warp per row r and a
// ballot per 32 candidate suppressors. Bit r of row_mask[r] is set when a
// box kept in an earlier tile suppresses rank base + r (lane l holds kept
// box k0 + l); bit s < r when rank base + s of the tile, kept, would (lane
// s holds rank base + s). A row whose rank is suppressed needs no more.
__device__ void tile_rows(const Smem& sm, int base, int m, int kept,
                          float thresh, unsigned* row_mask) {
  const int lane = threadIdx.x % kWarp;
  const int warps = blockDim.x / kWarp;
  Corners mine{};
  int mc = -1;
  if (base + lane < m) {
    const int s = sm.slot[base + lane];
    mine = sm.corners(s);
    mc = sm.cls[s];
  }
  for (int r = threadIdx.x / kWarp; r < kWarp && base + r < m; r += warps) {
    const int b = sm.slot[base + r];
    const Corners cb = sm.corners(b);
    const int c = sm.cls[b];
    bool dead = false;
    for (int k0 = 0; k0 < kept && !dead; k0 += kWarp) {
      const int k = k0 + lane;
      dead = __ballot_sync(kFull, k < kept && sm.keep_cls[k] == c &&
                                      suppresses(sm.corners(sm.keep[k]), cb,
                                                 thresh)) != 0;
    }
    const unsigned bits =
        dead ? 1u << r
             : __ballot_sync(kFull, lane < r && mc == c &&
                                        suppresses(mine, cb, thresh));
    if (lane == 0) row_mask[r] = bits;
  }
}

template <class Source>
__global__ void __launch_bounds__(kMaxThreads)
nms_kernel(Source src, int n, int max_out, float iou_thresh,
           float score_thresh, float* __restrict__ out_b,
           float* __restrict__ out_s, int* __restrict__ out_c) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(16) unsigned row_mask[kWarp];
  __shared__ int s_kept;
  const Smem sm(smem, n, max_out);
  const int img = blockIdx.x;
  // `lanes` threads share a box: lane u of them takes classes u, u +
  // lanes, ... and a quarter (half) of the ranking's comparisons
  const int lanes = box_lanes(n);
  const int u = threadIdx.x % lanes;
  const int step = blockDim.x / lanes;      // boxes the block holds at once
  const int per = (n + step - 1) / step;    // boxes a thread group holds

  // 1. the prologue; m counts the candidates (score > 0)
  int m = 0;
  for (int k = 0; k < per; ++k) {
    const int j = threadIdx.x / lanes + k * step;
    float best = -INFINITY;
    int at = INT_MAX;
    Box b{};
    if (j < n) {
      if (u == 0) b = src.box(img, j);
      best_class(src.scores(img, j), src.c, u, lanes, best, at);
    }
    for (int off = 1; off < lanes; off <<= 1) {
      const float v = __shfl_xor_sync(kFull, best, off);
      const int i = __shfl_xor_sync(kFull, at, off);
      if (better(v, i, best, at)) {
        best = v;
        at = i;
      }
    }
    bool cand = false;
    if (j < n && u == 0) {
      const float s = best >= score_thresh ? best : 0.f;
      const float hw = __fmul_rn(b.w, 0.5f), hh = __fmul_rn(b.h, 0.5f);
      const float a1 = __fsub_rn(b.cx, hw), b1 = __fsub_rn(b.cy, hh);
      const float a2 = __fadd_rn(b.cx, hw), b2 = __fadd_rn(b.cy, hh);
      sm.score[j] = s;
      sm.cls[j] = at;
      sm.x1[j] = a1;
      sm.y1[j] = b1;
      sm.x2[j] = a2;
      sm.y2[j] = b2;
      sm.area[j] = __fmul_rn(__fsub_rn(a2, a1), __fsub_rn(b2, b1));
      cand = s > 0.f;
    }
    m += __syncthreads_count(cand);
  }

  // 2. the ranks, each counted by the box's lanes, then the boxes by rank
  int rank[kMaxBoxesPerThread];
  for (int k = 0; k < per; ++k) {
    const int j = threadIdx.x / lanes + k * step;
    const bool cand = j < n && sm.score[j] > 0.f;
    int r = cand ? count_beating(sm.score, n, j, u, lanes) : 0;
    for (int off = 1; off < lanes; off <<= 1) {
      r += __shfl_xor_sync(kFull, r, off);
    }
    rank[k] = cand && u == 0 ? r : -1;
  }
  __syncthreads();
  for (int k = 0; k < per; ++k) {
    if (rank[k] >= 0) sm.slot[rank[k]] = threadIdx.x / lanes + k * step;
  }
  __syncthreads();

  // 3. the sweep; `kept` is read after the tile's second barrier and
  // written only after the next tile's first, so every thread sees the same
  // value
  int kept = 0;
  for (int base = 0; base < m && kept < max_out; base += kWarp) {
    tile_rows(sm, base, m, kept, iou_thresh, row_mask);
    __syncthreads();
    if (threadIdx.x < kWarp) {
      // resolve the tile: a rank is decided once every alive rank that
      // could suppress it is; it is dropped if a kept one does, else kept.
      // The lowest undecided rank is decided in each round.
      const int lane = threadIdx.x;
      const bool valid = base + lane < m;
      const unsigned rm = valid ? row_mask[lane] : 0u;
      const unsigned alive = __ballot_sync(kFull, valid && !(rm >> lane & 1));
      const unsigned row = rm & alive;
      unsigned bits = 0, decided = ~alive;
      while (decided != kFull) {
        const bool open = !(decided >> lane & 1);
        const bool drop = open && (row & bits);
        const bool keep = open && !drop && !(row & ~decided);
        bits |= __ballot_sync(kFull, keep);
        decided |= __ballot_sync(kFull, keep || drop);
      }
      // past max_out nothing counts: keep the first ranks that fit
      while (__popc(bits) > max_out - kept) {
        bits &= ~(0x80000000u >> __clz(bits));
      }
      if (bits >> lane & 1) {
        const int k = kept + __popc(bits & ((1u << lane) - 1));
        const int v = sm.slot[base + lane];
        sm.keep[k] = v;
        sm.keep_cls[k] = sm.cls[v];
      }
      if (lane == 0) s_kept = kept + __popc(bits);
    }
    __syncthreads();
    kept = s_kept;
  }

  // 4. the outputs in rank order; an empty slot is box 0, score 0, class
  // -1, and a kept box's score its best class's, as the prologue took it
  for (int t = threadIdx.x; t < max_out; t += blockDim.x) {
    const size_t o = static_cast<size_t>(img) * max_out + t;
    const int j = t < kept ? sm.keep[t] : 0;
    const Box b = src.box(img, j);
    out_b[4 * o] = b.cx;
    out_b[4 * o + 1] = b.cy;
    out_b[4 * o + 2] = b.w;
    out_b[4 * o + 3] = b.h;
    out_s[o] = t < kept ? src.scores(img, j)(sm.keep_cls[t]) : 0.f;
    out_c[o] = t < kept ? sm.keep_cls[t] : -1;
  }
}

template <class Source>
int launch(const Source& src, int batch, int n, int max_out,
           float iou_thresh, float score_thresh, void* out_b, void* out_s,
           void* out_c, void* stream) {
  if (batch < 1 || n < 1 || src.c < 1 || max_out < 1 ||
      score_thresh < 0.f) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = nms_smem(n, max_out);
  if (smem + kStaticSmem > kSmemPerBlock) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_kernel<Source>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int lanes = box_lanes(n);
  const int threads = n * lanes >= kMaxThreads
                          ? kMaxThreads
                          : (n * lanes + kWarp - 1) / kWarp * kWarp;
  nms_kernel<Source><<<batch, threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      src, n, max_out, iou_thresh, score_thresh, static_cast<float*>(out_b),
      static_cast<float*>(out_s), static_cast<int*>(out_c));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// boxes (batch, n, 4) cxcywh f32; scores (batch, n, c) f32; out_b
// (batch, max_out, 4) f32, out_s (batch, max_out) f32, out_c
// (batch, max_out) int32. One block of min(1024, n rounded up to a warp)
// threads per image. Refused with cudaErrorInvalidValue where an image's
// boxes do not fit in shared memory (n above about 8,000), a size is not
// positive or score_thresh is negative. Returns cudaGetLastError()
// otherwise.
int detect_nms(const void* boxes, const void* scores, void* out_b,
               void* out_s, void* out_c, int batch, int n, int c,
               int max_out, float iou_thresh, float score_thresh,
               void* stream) {
  const Decoded src{static_cast<const float*>(boxes),
                    static_cast<const float*>(scores), n, c};
  return launch(src, batch, n, max_out, iou_thresh, score_thresh, out_b,
                out_s, out_c, stream);
}

// raw (batch, grid, grid, 3 * (5 + c)) f32, the detector's head; anchors:
// 6 floats in host memory, (w, h) of each of the 3 anchors; outputs and
// refusals as detect_nms's, with n = grid * grid * 3 boxes an image.
int detect_postprocess(const void* raw, const void* anchors, void* out_b,
                       void* out_s, void* out_c, int batch, int grid, int c,
                       int max_out, float iou_thresh, float score_thresh,
                       void* stream) {
  // grid <= 1024 keeps grid * grid * 3 in an int; the shared memory
  // refuses far smaller grids
  if (grid < 1 || grid > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RawHead src{static_cast<const float*>(raw), grid, c,
              1.f / static_cast<float>(grid), {}, {}};
  const float* a = static_cast<const float*>(anchors);
  for (int i = 0; i < kAnchors; ++i) {
    src.aw[i] = a[2 * i];
    src.ah[i] = a[2 * i + 1];
  }
  return launch(src, batch, grid * grid * kAnchors, max_out, iou_thresh,
                score_thresh, out_b, out_s, out_c, stream);
}

}  // extern "C"
