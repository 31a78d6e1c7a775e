// K2, resident: long greedy extensions from generation 0 to the end in
// one launch, one persistent warp per lane at a time.
//
// A redesign of K2 (greedy_chunk.cu; it replaces the Pallas kernel
// genometools_tpu/ops/greedy_pallas.py _make_kernel(single_shot=False),
// pl.pallas_call at greedy_pallas.py:456) together with the windowed chunk
// loop around it (genometools_tpu/ops/greedy_batch.py:688-868;
// genometools_torch/ops/chunk_loop.py). The TPU design stops every lane
// after each chunk and rebases its window on the host. Here a warp keeps
// its lane:
//   (a) it takes the next lane from a global counter over the lanes
//       sorted longest first (the wrapper sorts), so a warp that finishes
//       takes new work and the launch's tail is short;
//   (b) generation 0: the seed's first match run is read from the pool's
//       planes 1,024 symbols (one word a thread) at a time;
//   (c) each chunk reads its W-symbol windows straight from the pool
//       (int64 words holding uint32 plane words; word start >> 5 and a
//       funnel shift by start & 31; rev picks the reversed planes; symbols
//       past a flank are special) into the warp's shared memory, scores
//       the state and runs up to GENS generations of K2's recurrence
//       (greedy_common.cuh) at the lane's slot tier D (2 slot groups for
//       D <= 31, else 5);
//   (d) the rebase: warp reductions give the live front's extremes, the
//       slots move by shift = cmin - rmin with shuffles, the window origin
//       advances and the window and slot tiers follow chunk_loop.rebase;
//   (e) a lane writes best[4], died, its route and its chunks, and adds
//       its live slot-generations to one counter (for the bound). A lane
//       that the tier rules give up on, or that runs max_chunks chunks,
//       falls back (to the host engine), as in the chunk loop.
// The queue, the pool reader and generation 0's match run are pool.cuh's,
// shared with K1 and K3. The plain PyTorch version is
// genometools_torch/ops/greedy_resident.py::greedy_resident_plain.
//
// What bounds it on the H100: the serial generation chain of each lane,
// as in K1 and K2 (integer, popcount and shuffle instructions); memory
// traffic is the windows' pool words (read once per chunk) and 28 bytes a
// finished lane. The state never leaves the registers between chunks, no
// (N, K) state is kept in HBM, and the host takes no part between
// generation 0 and the end of a lane. Shared memory holds one window of the
// widest tier per warp (18 KB at W = 24,576), which with the registers sets
// how many warps an SM keeps (gt_greedy_resident_occupancy reports it; on
// the H100 the registers set it, at every tier).
#include <climits>

#include "greedy_common.cuh"
#include "pool.cuh"

namespace {

constexpr int R = 5;            // slot groups held: D <= 64 (K <= 160)
constexpr int WARPS = 4;
enum { kDone = 0, kFallback = 1 };     // chunk_loop's DONE, FALLBACK

struct ResConf {
  int nwt, wt[4], ndt, dt[4], gcap, max_chunks, cut_depth, mmp128, mad, ms,
      ds, hist_cap;
};

// One chunk of K2 on the first NG slot groups: score the state, then up
// to a.gcap generations, pausing on window or slot-edge contact.
template <int NG>
__device__ __forceinline__ void run_chunk(int (&row)[R], uint64_t (&h)[R],
                                          int (&hs)[R], int (&mm)[R],
                                          int (&val)[R], int& d,
                                          int (&best)[4], bool& done,
                                          bool& died, const uint32_t* P,
                                          const GreedyArgs& a, int lane,
                                          long long& live) {
  int r[NG], s[NG], m[NG], v[NG];
  uint64_t hh[NG];
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    r[g] = row[g];
    hh[g] = h[g];
    s[g] = hs[g];
    m[g] = mm[g];
    v[g] = val[g];
  }
  bool died_now, complete_now;
  trim_and_score<NG>(r, hh, s, m, v, d, best, done, a, lane, died_now,
                     complete_now);
  died = died || died_now;
  done = done || died_now || complete_now;
  gt_generations<NG, true>(r, hh, s, m, v, d, best, done, died, P, a, lane,
                           &live);
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    row[g] = r[g];
    h[g] = hh[g];
    hs[g] = s[g];
    mm[g] = m[g];
    val[g] = v[g];
  }
}

__global__ void __launch_bounds__(WARPS * 32)
greedy_resident_kernel(const int64_t* __restrict__ pool, long long stride,
                       const int64_t* __restrict__ su_g,
                       const int64_t* __restrict__ ul_g,
                       const int64_t* __restrict__ sv_g,
                       const int64_t* __restrict__ vl_g,
                       const uint8_t* __restrict__ rev_g,
                       const int64_t* __restrict__ seed_g,
                       const int32_t* __restrict__ order,
                       int32_t* __restrict__ ctr,
                       int32_t* __restrict__ best_g,
                       uint8_t* __restrict__ died_g,
                       int8_t* __restrict__ route_g,
                       int32_t* __restrict__ chunks_g,
                       unsigned long long* __restrict__ work,
                       const ResConf c, int N) {
  extern __shared__ uint32_t smem[];
  const int lane = threadIdx.x & 31;
  uint32_t* P =
      smem + (size_t)(threadIdx.x >> 5) * 6 * (c.wt[c.nwt - 1] >> 5);
  for (;;) {
    // (a) the next lane
    const int i = gt_next_lane(ctr, lane);
    if (i >= N) break;
    const int t = order[i];
    const Lane L = gt_lane(pool, stride, su_g, ul_g, sv_g, vl_g, rev_g, t);
    const long long seed = seed_g[t];

    // (b) generation 0: the seed's all-match history shifted by the
    // first match run, at the centre of the first slot tier
    const long long c0 = first_run(L, stride, lane);
    uint64_t h0 = gt_ones64(seed >= 64 ? 64 : (int)seed);
    h0 = c0 < 64 ? ((h0 << c0) | gt_ones64((int)c0)) : ~0ull;
    const int hs0 = (int)min(seed + c0, (long long)c.hist_cap);
    int tier = 0, dtier = 0;
    int Dw = c.dt[0];
    int row[R], hs[R], mm[R], val[R];
    uint64_t h[R];
#pragma unroll
    for (int g = 0; g < R; ++g) {
      const bool centre = 32 * g + lane == Dw;
      row[g] = centre ? 0 : GT_NEGINF;
      h[g] = centre ? h0 : 0ull;
      hs[g] = centre ? hs0 : 0;
      mm[g] = 0;
      val[g] = centre;
    }
    long long du = c0, dv = c0;
    int d = 0, chunks = 0, route = kFallback;
    long long live = 0;             // live slot-generations of the lane
    int best[4] = {0, 0, 0, 0};
    bool done = false, died = false;

    for (;;) {
      if (chunks >= c.max_chunks) {
        route = kFallback;
        break;
      }
      // (c) one chunk in the window at (du, dv)
      const int W = c.wt[tier];
      Dw = c.dt[dtier];
      load_window(P, L, stride, du, dv, W >> 5, lane);
      GreedyArgs a = gt_greedy_args(W, Dw, c.gcap, c.cut_depth, c.mmp128,
                                    c.mad, c.ms, c.ds, c.hist_cap);
      gt_greedy_task(a, (int)min(L.ulen - du, 1LL << 30),
                     (int)min(L.vlen - dv, 1LL << 30), (int)(dv - du),
                     (int)min(du, 1LL << 30));
      const int d_before = d;
      if (a.K <= 64)
        run_chunk<2>(row, h, hs, mm, val, d, best, done, died, P, a, lane,
                     live);
      else
        run_chunk<R>(row, h, hs, mm, val, d, best, done, died, P, a, lane,
                     live);
      ++chunks;
      if (done) {
        route = kDone;
        break;
      }
      // (d) the live front's extremes: rows, columns, slot offsets
      int rmn = INT_MAX, rmx = INT_MIN, cmn = INT_MAX, kmn = INT_MAX,
          kmx = INT_MIN;
#pragma unroll
      for (int g = 0; g < R; ++g) {
        const int s = 32 * g + lane;
        if (s < a.K && val[g]) {
          const int k = s - Dw;
          rmn = min(rmn, row[g]);
          rmx = max(rmx, row[g]);
          cmn = min(cmn, row[g] + k);
          kmn = min(kmn, k);
          kmx = max(kmx, k);
        }
      }
      rmn = __reduce_min_sync(GT_FULL, rmn);
      rmx = __reduce_max_sync(GT_FULL, rmx);
      cmn = __reduce_min_sync(GT_FULL, cmn);
      kmn = __reduce_min_sync(GT_FULL, kmn);
      kmx = __reduce_max_sync(GT_FULL, kmx);
      // the tier rules (chunk_loop.rebase)
      const int shift = cmn - rmn;
      const int amax = max(abs(kmn - shift), abs(kmx - shift));
      int ndt = -1;
      for (int j = c.ndt - 1; j >= 0; --j)
        if (amax <= c.dt[j] - 1) ndt = j;
      bool fb = ndt < 0;
      const bool no_prog = d == d_before && rmn == 0 && cmn == 0;
      const bool wider =
          !fb && no_prog && ndt < c.ndt - 1 && amax >= Dw - 2;
      if (wider) ++ndt;
      const bool grow = !fb && !wider && (no_prog || rmx - rmn >= W - 64);
      const bool top = grow && tier + 1 >= c.nwt;
      fb = fb || top;
      if (grow && !top) ++tier;
      if (!fb && !wider && !grow && tier > 0) --tier;
      if (fb) {
        route = kFallback;
        break;
      }
      // recentre: new slot s (tier ndt) takes old slot s + delta
      const int Dn = c.dt[ndt];
      const int Kn = 2 * Dn + 1;
      const int delta = Dw - Dn + shift;
      int xr[R], xs[R], xm[R], xv[R];
      uint64_t xh[R];
      gt_slot_shift<R, R>(row, xr, delta, lane);
      gt_slot_shift<R, R>(h, xh, delta, lane);
      gt_slot_shift<R, R>(hs, xs, delta, lane);
      gt_slot_shift<R, R>(mm, xm, delta, lane);
      gt_slot_shift<R, R>(val, xv, delta, lane);
#pragma unroll
      for (int g = 0; g < R; ++g) {
        const int s = 32 * g + lane;
        const int src = s + delta;
        const bool v = s < Kn && src >= 0 && src < a.K && xv[g];
        row[g] = v ? xr[g] - rmn : GT_NEGINF;
        h[g] = v ? xh[g] : 0ull;
        hs[g] = v ? xs[g] : 0;
        mm[g] = v ? xm[g] : 0;
        val[g] = v;
      }
      du += rmn;
      dv += cmn;
      dtier = ndt;
      Dw = Dn;
    }

    // (e) results
    if (lane == 0) {
      atomicAdd(work, (unsigned long long)live);
#pragma unroll
      for (int k = 0; k < 4; ++k) best_g[4 * (size_t)t + k] = best[k];
      died_g[t] = died ? 1 : 0;
      route_g[t] = (int8_t)route;
      chunks_g[t] = chunks;
    }
  }
}

size_t window_smem(int wmax) {
  return (size_t)WARPS * 6 * (wmax / 32) * sizeof(uint32_t);
}

}  // namespace

// out: resident blocks per SM with windows of up to wmax symbols,
// registers a thread, SMs on the card.
extern "C" int gt_greedy_resident_occupancy(int wmax, int* out) {
  if (wmax <= 0 || (wmax & 31)) return (int)cudaErrorInvalidValue;
  return (int)gt_occupancy(greedy_resident_kernel, WARPS * 32,
                           window_smem(wmax), out);
}

// conf: nwt, wt[4], ndt, dt[4], GENS, max_chunks, cut_depth, mmp128, mad,
// match_score, difference_score, hist_cap. Shared memory holds a window
// of the widest tier wt[nwt - 1] per warp.
extern "C" int gt_greedy_resident(
    const void* pool, long long stride, const void* su, const void* ul,
    const void* sv, const void* vl, const void* rev, const void* seed,
    const void* order, void* ctr, void* best, void* died, void* route,
    void* chunks, void* work, const int* conf, int N, void* stream) {
  if (N <= 0) return 0;
  ResConf c;
  c.nwt = conf[0];
  for (int j = 0; j < 4; ++j) c.wt[j] = conf[1 + j];
  c.ndt = conf[5];
  for (int j = 0; j < 4; ++j) c.dt[j] = conf[6 + j];
  c.gcap = conf[10];
  c.max_chunks = conf[11];
  c.cut_depth = conf[12];
  c.mmp128 = conf[13];
  c.mad = conf[14];
  c.ms = conf[15];
  c.ds = conf[16];
  c.hist_cap = conf[17];
  bool ok = c.nwt >= 1 && c.nwt <= 4 && c.ndt >= 1 && c.ndt <= 4 &&
            c.cut_depth == 15 && c.hist_cap >= 30 && c.hist_cap <= 64 &&
            stride >= 2;
  for (int j = 0; ok && j < c.nwt; ++j)
    ok = c.wt[j] > 0 && (c.wt[j] & 31) == 0 &&
         (j == 0 || c.wt[j] > c.wt[j - 1]);
  for (int j = 0; ok && j < c.ndt; ++j) ok = c.dt[j] >= 1 && c.dt[j] <= 64;
  if (!ok) return (int)cudaErrorInvalidValue;
  const size_t smem = window_smem(c.wt[c.nwt - 1]);
  int grid = 0;
  cudaError_t e =
      gt_persistent_grid(greedy_resident_kernel, WARPS, smem, N, &grid);
  if (e != cudaSuccess) return (int)e;
  greedy_resident_kernel<<<grid, WARPS * 32, smem,
                           (cudaStream_t)stream>>>(
      (const int64_t*)pool, stride, (const int64_t*)su, (const int64_t*)ul,
      (const int64_t*)sv, (const int64_t*)vl, (const uint8_t*)rev,
      (const int64_t*)seed, (const int32_t*)order, (int32_t*)ctr,
      (int32_t*)best, (uint8_t*)died, (int8_t*)route, (int32_t*)chunks,
      (unsigned long long*)work, c, N);
  return (int)cudaGetLastError();
}
