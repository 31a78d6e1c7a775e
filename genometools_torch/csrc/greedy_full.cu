// K1: single-shot greedy front-prune extension, persistent warps fed by a
// queue, windows read straight from the pool.
//
// Replaces the Pallas kernel genometools_tpu/ops/greedy_pallas.py
// _make_kernel(single_shot=True) (pl.pallas_call at greedy_pallas.py:531)
// and recomputes what it computes: generation 0 in the kernel, then per
// generation the ins > mis > del predecessor pick, the 64-bit history
// shift, the match run, the percmathistory / maxalignedlendifference
// trim, the 2x15-bit polishing walk and the completion test
// (ref: ft-front-prune.c:633, ft-polish.c). The recurrence is in
// greedy_common.cuh, shared with K2 and K2r. The plain PyTorch version is
// genometools_torch/ops/greedy_full.py::greedy_full_plain.
//
// What bounds it on the H100: the serial generation chain of each lane
// (integer, popcount and shuffle instructions); memory traffic is the
// lane's two flanks (6 plane words per 32 symbols, once) and 28 bytes of
// result. The design:
//   (a) persistent warps: one wave of resident blocks; a warp takes the
//       next lane from an atomic counter over the lanes sorted longest
//       first (pool.cuh), so one launch carries every lane of a batch and
//       the tail waits for no block's longest lane;
//   (b) a lane's window is its flanks rounded up to 32 symbols (at most
//       W), read from the pool into the warp's shared memory: no task
//       array is written to and read back from device memory;
//   (c) slot tiers: a lane starts at the first tier D0 (D = 16: two slot
//       groups) and moves to D1 (D = 64: five groups) only when its front
//       touches the slot edge. The paused generation was not committed, so
//       the state shifts by D1 - D0 slots (shuffles) and the lane goes on
//       from there: it finishes where it would have at D1, on the work of
//       D0's two groups for as long as its front stays within 16
//       diagonals;
//   (d) the polishing walk runs only for slots whose alignedlen is above
//       the best so far (greedy_common.cuh trim_and_score);
//   (e) a lane writes its 7 result words at its own index and adds its
//       live slot-generations to one counter (the bound of the run).
#include "greedy_common.cuh"
#include "pool.cuh"

namespace {

constexpr int WARPS = 4;

struct FullConf {
  int W, D0, D1, gcap, cut_depth, mmp128, mad, ms, ds, hist_cap;
};

// Tier 1 of a lane paused at tier 0's slot edge: new slot s (D1) takes
// old slot s - (D1 - D0); slots from outside tier 0 are invalid.
template <int NG0, int NG1, typename T>
__device__ __forceinline__ void widen(const T (&a)[NG0], T (&out)[NG1],
                                      const int (&val)[NG0], int D0, int D1,
                                      T fill, int lane) {
  const int delta = D0 - D1;
  int xv[NG1];
  gt_slot_shift<NG0, NG1>(a, out, delta, lane);
  gt_slot_shift<NG0, NG1>(val, xv, delta, lane);
#pragma unroll
  for (int g = 0; g < NG1; ++g) {
    const int src = 32 * g + lane + delta;
    if (!(src >= 0 && src < 2 * D0 + 1 && xv[g])) out[g] = fill;
  }
}

template <int NG0, int NG1>
__global__ void __launch_bounds__(WARPS * 32)
greedy_full_kernel(const int64_t* __restrict__ pool, long long stride,
                   const int64_t* __restrict__ su_g,
                   const int64_t* __restrict__ ul_g,
                   const int64_t* __restrict__ sv_g,
                   const int64_t* __restrict__ vl_g,
                   const uint8_t* __restrict__ rev_g,
                   const int64_t* __restrict__ seed_g,
                   const int32_t* __restrict__ order,
                   int32_t* __restrict__ ctr, int32_t* __restrict__ out,
                   unsigned long long* __restrict__ work, const FullConf c,
                   int N) {
  extern __shared__ uint32_t smem[];
  const int lane = threadIdx.x & 31;
  uint32_t* P = smem + (size_t)(threadIdx.x >> 5) * 6 * (c.W >> 5);
  for (;;) {
    const int i = gt_next_lane(ctr, lane);
    if (i >= N) break;
    const int t = order[i];
    const Lane L = gt_lane(pool, stride, su_g, ul_g, sv_g, vl_g, rev_g, t);
    const long long mx = max(max(L.ulen, L.vlen), 1LL);
    const int W = (int)min((mx + 31) & ~31LL, (long long)c.W);
    load_window(P, L, stride, 0, 0, W >> 5, lane);
    GreedyArgs a = gt_greedy_args(W, c.D0, c.gcap, c.cut_depth, c.mmp128,
                                  c.mad, c.ms, c.ds, c.hist_cap);
    gt_greedy_task(a, (int)min(L.ulen, 1LL << 30),
                   (int)min(L.vlen, 1LL << 30), 0, 0);
    const int seedl = (int)min((long long)seed_g[t], 1LL << 30);

    // generation 0: the seed's all-match history at the centre slot,
    // then its first match run
    int row[NG0], hs[NG0], mm[NG0], val[NG0];
    uint64_t h[NG0];
#pragma unroll
    for (int g = 0; g < NG0; ++g) {
      const bool centre = 32 * g + lane == c.D0;
      row[g] = centre ? 0 : GT_NEGINF;
      h[g] = centre ? gt_ones64(seedl) : 0ull;
      hs[g] = centre ? min(seedl, c.hist_cap) : 0;
      mm[g] = 0;
      val[g] = centre;
    }
    add_matches<NG0>(row, h, hs, val, P, a, lane);
    int best[4] = {0, 0, 0, 0};
    bool died_now, complete_now;
    trim_and_score<NG0>(row, h, hs, mm, val, 0, best, false, a, lane,
                        died_now, complete_now);
    bool died = died_now;
    bool done = died_now || complete_now;
    int d_lane = 0;
    long long live = 0;
    // a lane paused at the slot edge or at the generation cap is undone
    const bool paused = gt_generations<NG0, true>(
        row, h, hs, mm, val, d_lane, best, done, died, P, a, lane, &live);
    if constexpr (NG1 > 0) {
      if (paused && c.D1 > 0) {
        int r1[NG1], hs1[NG1], mm1[NG1], v1[NG1];
        uint64_t h1[NG1];
        widen<NG0, NG1>(row, r1, val, c.D0, c.D1, (int)GT_NEGINF, lane);
        widen<NG0, NG1>(h, h1, val, c.D0, c.D1, (uint64_t)0, lane);
        widen<NG0, NG1>(hs, hs1, val, c.D0, c.D1, 0, lane);
        widen<NG0, NG1>(mm, mm1, val, c.D0, c.D1, 0, lane);
        widen<NG0, NG1>(val, v1, val, c.D0, c.D1, 0, lane);
        a.D = c.D1;
        a.K = 2 * c.D1 + 1;
        a.gcap = c.gcap - d_lane;
        gt_generations<NG1, true>(r1, h1, hs1, mm1, v1, d_lane, best, done,
                                  died, P, a, lane, &live);
      }
    }
    if (lane == 0) {
      atomicAdd(work, (unsigned long long)live);
      out[t] = best[0];
      out[N + t] = best[1];
      out[2 * N + t] = best[2];
      out[3 * N + t] = best[3];
      out[4 * N + t] = done ? 1 : 0;
      out[5 * N + t] = (died && done) ? 1 : 0;
      out[6 * N + t] = done ? 0 : 1;
    }
  }
}

size_t window_smem(int W) {
  return (size_t)WARPS * 6 * (W / 32) * sizeof(uint32_t);
}

template <int NG0, int NG1>
int launch(const void* pool, long long stride, const void* const* desc,
           const void* order, void* ctr, void* out, void* work,
           const FullConf& c, int N, cudaStream_t st) {
  auto kern = greedy_full_kernel<NG0, NG1>;
  const size_t smem = window_smem(c.W);
  int grid = 0;
  cudaError_t e = gt_persistent_grid(kern, WARPS, smem, N, &grid);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, WARPS * 32, smem, st>>>(
      (const int64_t*)pool, stride, (const int64_t*)desc[0],
      (const int64_t*)desc[1], (const int64_t*)desc[2],
      (const int64_t*)desc[3], (const uint8_t*)desc[4],
      (const int64_t*)desc[5], (const int32_t*)order, (int32_t*)ctr,
      (int32_t*)out, (unsigned long long*)work, c, N);
  return (int)cudaGetLastError();
}

int ngroups(int D) { return (2 * D + 1 + 31) / 32; }

// Single tiers NG = 1..9, and the default ladder D0 <= 31 -> D1 <= 79.
int dispatch(const void* pool, long long stride, const void* const* desc,
             const void* order, void* ctr, void* out, void* work,
             const FullConf& c, int N, cudaStream_t st, int* occ) {
  const int ng0 = ngroups(c.D0), ng1 = c.D1 > 0 ? ngroups(c.D1) : 0;
#define GT_FULL_CASE(A, B)                                                   \
  if (ng0 == A && ng1 == B) {                                              \
    auto kern = greedy_full_kernel<A, B>;                                  \
    if (occ)                                                               \
      return (int)gt_occupancy(kern, WARPS * 32, window_smem(c.W), occ);   \
    return launch<A, B>(pool, stride, desc, order, ctr, out, work, c, N,   \
                        st);                                               \
  }
  GT_FULL_CASE(2, 5)
  GT_FULL_CASE(1, 0)
  GT_FULL_CASE(2, 0)
  GT_FULL_CASE(3, 0)
  GT_FULL_CASE(4, 0)
  GT_FULL_CASE(5, 0)
  GT_FULL_CASE(6, 0)
  GT_FULL_CASE(7, 0)
  GT_FULL_CASE(8, 0)
  GT_FULL_CASE(9, 0)
#undef GT_FULL_CASE
  return (int)cudaErrorInvalidValue;
}

bool read_conf(const int* conf, FullConf& c) {
  c.W = conf[0];
  c.D0 = conf[1];
  c.D1 = conf[2];
  c.gcap = conf[3];
  c.cut_depth = conf[4];
  c.mmp128 = conf[5];
  c.mad = conf[6];
  c.ms = conf[7];
  c.ds = conf[8];
  c.hist_cap = conf[9];
  return c.W > 0 && (c.W & 31) == 0 && c.D0 >= 1 &&
         (c.D1 == 0 || c.D1 > c.D0) && c.cut_depth == 15 &&
         c.hist_cap >= 30 && c.hist_cap <= 64 && c.gcap >= 0;
}

}  // namespace

// conf: W (the widest window), D0, D1 (0: one slot tier), GENS,
// cut_depth, mmp128, mad, match_score, difference_score, hist_cap.
// desc: ustart, ulen, vstart, vlen (int64), rev (uint8), seedlen (int64).
// out: (7, N) int32 at each lane's own index.
extern "C" int gt_greedy_full(const void* pool, long long stride,
                              const void* const* desc, const void* order,
                              void* ctr, void* out, void* work,
                              const int* conf, int N, void* stream) {
  if (N <= 0) return 0;
  FullConf c;
  if (!read_conf(conf, c) || stride < 2) return (int)cudaErrorInvalidValue;
  return dispatch(pool, stride, desc, order, ctr, out, work, c, N,
                  (cudaStream_t)stream, nullptr);
}

// out: resident blocks per SM, registers a thread, SMs for the kernel
// the same conf launches.
extern "C" int gt_greedy_full_occupancy(const int* conf, int* out) {
  FullConf c;
  if (!read_conf(conf, c)) return (int)cudaErrorInvalidValue;
  return dispatch(nullptr, 0, nullptr, nullptr, nullptr, nullptr, nullptr,
                  c, 0, nullptr, out);
}

extern "C" const char* gt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
