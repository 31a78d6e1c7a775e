// K2: resumable greedy front-prune chunk, one warp per task.
//
// Replaces the Pallas kernel genometools_tpu/ops/greedy_pallas.py
// _make_kernel(single_shot=False) (pl.pallas_call at greedy_pallas.py:456,
// launched by _chunk_pallas / greedy_chunk_pallas). It runs K1's
// generation body (greedy_common.cuh) on the state that the windowed
// loop carries from chunk to chunk (genometools_torch/ops/chunk_loop.py;
// since the resident kernel greedy_resident.cu, only on the RESIDENT =
// False route):
//   (a) the (N, K) slot state and the per-lane state are loaded from
//       device memory, the window's six bit-planes into shared memory;
//   (b) the input state is scored first (trim, polished point,
//       completion; idempotent on a scored state), with no generation 0;
//   (c) a generation whose front touches the window end (urem > W or
//       vrem > W) or the slot edge is rolled back and the lane pauses;
//   (d) the whole state is stored back, in place.
// The plain PyTorch version is
// genometools_torch/ops/greedy_chunk.py::greedy_chunk_plain.
//
// What bounds it on the H100: as K1, the serial generation chain of each
// task (integer, popcount and shuffle instructions). Memory traffic is
// one read of the 6*W/32 plane words and of the state (21 bytes a slot,
// 32 a lane) and one write of the state. The design keeps the rest on
// chip: match words are computed from the planes in shared memory (the
// TPU kernel's (W/32, K, N) match bitmask, 396 KB a lane at W=24,576 and
// D=64, is never built), the slot state lives in registers, and a warp
// leaves as soon as its task is done or paused. At W=24,576 the planes
// take 18 KB a warp (72 KB a block), so the launch opts in to more than
// 48 KB of dynamic shared memory.
#include "greedy_common.cuh"

namespace {

template <int NG>
__global__ void __launch_bounds__(128)
greedy_chunk_kernel(const uint32_t* __restrict__ PW,
                    int32_t* __restrict__ row_g, uint64_t* __restrict__ h_g,
                    int32_t* __restrict__ hs_g, int32_t* __restrict__ mm_g,
                    uint8_t* __restrict__ val_g,
                    int32_t* __restrict__ d_g, uint8_t* __restrict__ done_g,
                    uint8_t* __restrict__ died_g,
                    uint8_t* __restrict__ paused_g,
                    int32_t* __restrict__ best_g,
                    const int32_t* __restrict__ urem_g,
                    const int32_t* __restrict__ vrem_g,
                    const int32_t* __restrict__ kbase_g,
                    const int32_t* __restrict__ rowbase_g, int N, int W,
                    int D, int gcap, int cut_depth, int mmp128, int mad,
                    int ms, int ds, int hist_cap) {
  extern __shared__ uint32_t smem[];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int task = blockIdx.x * (blockDim.x >> 5) + wib;
  if (task >= N) return;                     // uniform over the warp
  GreedyArgs a = gt_greedy_args(W, D, gcap, cut_depth, mmp128, mad, ms, ds,
                                hist_cap);
  const int nwords = 6 * a.W32;
  uint32_t* P = smem + (size_t)wib * nwords;
  gt_load_planes(P, PW + (size_t)task * nwords, nwords, lane);
  gt_greedy_task(a, urem_g[task], vrem_g[task], kbase_g[task],
                 rowbase_g[task]);

  // (a) the slot state: slots s >= K are dead
  const size_t base = (size_t)task * a.K;
  int row[NG], hs[NG], mm[NG], val[NG];
  uint64_t h[NG];
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    int s = 32 * g + lane;
    bool in = s < a.K;
    row[g] = in ? row_g[base + s] : GT_NEGINF;
    h[g] = in ? h_g[base + s] : 0ull;
    hs[g] = in ? hs_g[base + s] : 0;
    mm[g] = in ? mm_g[base + s] : 0;
    val[g] = in ? (int)val_g[base + s] : 0;
  }
  int best[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) best[i] = best_g[4 * (size_t)task + i];
  int d_lane = d_g[task];
  bool done = done_g[task] != 0;
  bool died = died_g[task] != 0;

  // (b) score the input state
  bool died_now, complete_now;
  trim_and_score<NG>(row, h, hs, mm, val, d_lane, best, done, a, lane,
                     died_now, complete_now);
  died = died || died_now;
  done = done || died_now || complete_now;
  // (c) run, pausing on window or slot-edge contact
  const bool paused = gt_generations<NG>(row, h, hs, mm, val, d_lane, best,
                                         done, died, P, a, lane);
  // (d) store the state back
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    int s = 32 * g + lane;
    if (s < a.K) {
      row_g[base + s] = row[g];
      h_g[base + s] = h[g];
      hs_g[base + s] = hs[g];
      mm_g[base + s] = mm[g];
      val_g[base + s] = val[g] ? 1 : 0;
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) best_g[4 * (size_t)task + i] = best[i];
    d_g[task] = d_lane;
    done_g[task] = done ? 1 : 0;
    died_g[task] = died ? 1 : 0;
    paused_g[task] = paused ? 1 : 0;
  }
}

}  // namespace

extern "C" int gt_greedy_chunk(const void* PW, void* row, void* h, void* hs,
                               void* mm, void* valid, void* d_lane,
                               void* done, void* died, void* paused,
                               void* best, const void* urem,
                               const void* vrem, const void* kbase,
                               const void* rowbase, int N, int W, int D,
                               int gcap, int cut_depth, int mmp128, int mad,
                               int ms, int ds, int hist_cap, void* stream) {
  if (N <= 0) return 0;
  if (W <= 0 || (W & 31) || D < 1 || cut_depth != 15 || hist_cap < 30 ||
      hist_cap > 64)
    return (int)cudaErrorInvalidValue;
  const int ng = (2 * D + 1 + 31) / 32;
  cudaStream_t st = (cudaStream_t)stream;
#define GT_LAUNCH(NGV)                                                       \
  GT_GREEDY_LAUNCH(greedy_chunk_kernel, NGV, N, W, st, (const uint32_t*)PW,  \
                   (int32_t*)row, (uint64_t*)h, (int32_t*)hs, (int32_t*)mm,  \
                   (uint8_t*)valid, (int32_t*)d_lane, (uint8_t*)done,        \
                   (uint8_t*)died, (uint8_t*)paused, (int32_t*)best,         \
                   (const int32_t*)urem, (const int32_t*)vrem,               \
                   (const int32_t*)kbase, (const int32_t*)rowbase, N, W, D,  \
                   gcap, cut_depth, mmp128, mad, ms, ds, hist_cap)
  GT_NG_DISPATCH(ng, GT_LAUNCH)
#undef GT_LAUNCH
  return (int)cudaGetLastError();
}
