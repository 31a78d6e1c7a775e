// K1: single-shot greedy front-prune extension, one warp per task.
//
// Replaces the Pallas kernel genometools_tpu/ops/greedy_pallas.py
// _make_kernel(single_shot=True) (pl.pallas_call at greedy_pallas.py:531)
// and recomputes what it computes: generation 0 in the kernel, then per
// generation the ins > mis > del predecessor pick, the 64-bit history
// shift, the match run, the percmathistory / maxalignedlendifference
// trim, the 2x15-bit polishing walk and the completion test
// (ref: ft-front-prune.c:633, ft-polish.c). The plain PyTorch version is
// genometools_torch/ops/greedy_full.py::greedy_full_plain.
//
// The recurrence itself is in greedy_common.cuh, shared with K2.
//
// What bounds it on the H100: the serial generation chain of each task
// (integer, popcount and shuffle instructions); memory traffic is one
// read of the task's 6*W/32 plane words and 7 result words. The design
// keeps everything else on chip: the planes sit in shared memory, match
// words are recomputed from them (the TPU kernel's (W/32, K, N) bitmask
// is never built), the slot state lives in registers (NG slots per
// thread), and each warp leaves as soon as its task is done, so long
// tasks do not hold short ones back.
#include "greedy_common.cuh"

namespace {

template <int NG>
__global__ void __launch_bounds__(128)
greedy_full_kernel(const uint32_t* __restrict__ PK, int32_t* __restrict__ out,
                   int N, int W, int D, int gcap, int cut_depth, int mmp128,
                   int mad, int ms, int ds, int hist_cap) {
  extern __shared__ uint32_t smem[];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int task = blockIdx.x * (blockDim.x >> 5) + wib;
  if (task >= N) return;                     // uniform over the warp
  GreedyArgs a = gt_greedy_args(W, D, gcap, cut_depth, mmp128, mad, ms, ds,
                                hist_cap);
  const int nwords = 6 * a.W32;
  uint32_t* P = smem + (size_t)wib * nwords;
  const uint32_t* src = PK + (size_t)task * (nwords + 3);
  gt_load_planes(P, src, nwords, lane);
  const int seedl = (int)src[nwords];
  gt_greedy_task(a, (int)src[nwords + 1], (int)src[nwords + 2], 0, 0);

  // generation 0: the seed's all-match history at the centre slot, then
  // its first match run
  int row[NG], hs[NG], mm[NG], val[NG];
  uint64_t h[NG];
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    bool center = 32 * g + lane == D;
    row[g] = center ? 0 : GT_NEGINF;
    h[g] = center ? gt_ones64(seedl) : 0ull;
    hs[g] = center ? min(seedl, hist_cap) : 0;
    mm[g] = 0;
    val[g] = center;
  }
  add_matches<NG>(row, h, hs, val, P, a, lane);
  int best[4] = {0, 0, 0, 0};
  bool died_now, complete_now;
  trim_and_score<NG>(row, h, hs, mm, val, 0, best, false, a, lane, died_now,
                     complete_now);
  bool died = died_now;
  bool done = died_now || complete_now;
  int d_lane = 0;
  // a lane paused at the slot edge or at the generation cap is undone
  gt_generations<NG>(row, h, hs, mm, val, d_lane, best, done, died, P, a,
                     lane);
  if (lane == 0) {
    out[task] = best[0];
    out[N + task] = best[1];
    out[2 * N + task] = best[2];
    out[3 * N + task] = best[3];
    out[4 * N + task] = done ? 1 : 0;
    out[5 * N + task] = (died && done) ? 1 : 0;
    out[6 * N + task] = done ? 0 : 1;
  }
}

}  // namespace

extern "C" int gt_greedy_full(const void* PK, void* out, int N, int W, int D,
                              int gcap, int cut_depth, int mmp128, int mad,
                              int ms, int ds, int hist_cap, void* stream) {
  if (N <= 0) return 0;
  if (W <= 0 || (W & 31) || D < 1 || cut_depth != 15 || hist_cap < 30 ||
      hist_cap > 64)
    return (int)cudaErrorInvalidValue;
  const int ng = (2 * D + 1 + 31) / 32;
  cudaStream_t st = (cudaStream_t)stream;
#define GT_LAUNCH(NGV)                                                      \
  GT_GREEDY_LAUNCH(greedy_full_kernel, NGV, N, W, st, (const uint32_t*)PK,  \
                   (int32_t*)out, N, W, D, gcap, cut_depth, mmp128, mad,    \
                   ms, ds, hist_cap)
  GT_NG_DISPATCH(ng, GT_LAUNCH)
#undef GT_LAUNCH
  return (int)cudaGetLastError();
}

extern "C" const char* gt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
