// K3: single-shot unit-score xdrop extension, persistent warps fed by a
// queue, windows read straight from the pool and clipped at a tier.
//
// Replaces the Pallas kernel genometools_tpu/ops/xdrop_pallas.py
// _make_kernel (pl.pallas_call at xdrop_pallas.py:301) and recomputes
// what it computes (ref: xdrop.c:224-430) for any scores whose unit
// distances are (1, 1, 1): EVAL(i+j, d) = half*(i+j) - quantum*d, with
// quantum and half from the conf (3 and 1 for match 2, mismatch -1, indel
// -2; 4 and 1 for ltrharvest's 2, -2, -3): generation 0 is the first lcp on
// the centre diagonal; each generation picks the candidate row with the
// DEL > MIS > INS priority, prunes against the best score dback
// generations back, extends taken cells by their match runs, updates the
// best score (strictly greater, first slot), tests completion and
// narrows the [lb, ub] window. The plain PyTorch version is
// genometools_torch/ops/xdrop_full.py::xdrop_full_plain.
//
// Slot s holds diagonal kk = s - D with j = i - kk: the match words of
// the shared planes are read on diagonal -kk (the TPU kernel flips the
// slot axis of the greedy bitmask for the same effect).
//
// What bounds it on the H100: the serial generation chain of each lane
// (shuffles, warp reductions, the match words from shared memory);
// memory traffic is the lane's flanks up to its window and 20 bytes of
// result. The design:
//   (a) persistent warps over a queue of lanes sorted longest first
//       (pool.cuh): one launch carries every lane and every tier;
//   (b) a lane's window is its flanks rounded up to 32 symbols, clipped
//       at the tier's W, read from the pool into the warp's shared
//       memory. The true flank lengths drive every test; a taken cell
//       whose match run reaches the clip of a flank that goes on makes
//       the lane unsafe (its run might go on). Such a lane, or one still
//       alive at the tier's generation cap, runs again at the next tier,
//       in the same warp; a lane whose front reaches the slot edge is
//       unsafe (the host engine takes it). Off-band lanes (|ulen - vlen|
//       > D) need no filter: a cell leaves the band only through an edge
//       slot;
//   (c) the dback-entry score ring lives in registers, spread over the
//       warp (entry r in lane r mod 32, at most two registers a lane),
//       read with one shuffle: no local memory. dback =
//       (belowscore + half) / quantum + 1 <= 64 bounds belowscore;
//   (d) only the slot groups that hold [lb-1, ub+1] compute;
//   (e) a lane writes its result at its own index and adds its candidate
//       slot-generations to one counter (the bound of the run).
#include "common.cuh"
#include "pool.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int kRingMax = 64;          // dback <= 64: two registers a lane
constexpr int kMaxTiers = 4;
enum { kSafe = 0, kEdge = 1, kCap = 2, kClip = 3 };

struct XConf {
  int nt, wt[kMaxTiers], gcap[kMaxTiers], D, belowscore, quantum, half;
};

template <int NG>
__device__ __forceinline__ void run_extend(int (&row)[NG],
                                           const int (&cond)[NG],
                                           const uint32_t* P, int W, int W32,
                                           int D, int lane) {
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    int r = row[g];
    if (!cond[g] || r < 0 || r >= W) continue;
    int diag = -(32 * g + lane - D);
    int c;
    do {
      c = gt_ctz_not(gt_match_bits(P, W32, r, diag));
      r += c;
    } while (c == 32);
    row[g] = r;
  }
}

struct XBest {
  int i, j, s;
};

// One lane in a window of W symbols (flanks of ulen, vlen clipped there):
// the best point and why the lane is unsafe (kSafe: it is not). live
// gains the candidate slots of every generation.
template <int NG>
__device__ __forceinline__ int xdrop_lane(const uint32_t* P, int W, int ulen,
                                          int vlen, int D, int gcap,
                                          int belowscore, int quantum,
                                          int half, int lane, XBest& b,
                                          int& live) {
  const int W32 = W >> 5;
  const int K = 2 * D + 1;
  const int dback = (belowscore + half) / quantum + 1;
  const bool uclip = ulen > W, vclip = vlen > W;
  int row[NG], cond[NG];
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    const bool centre = 32 * g + lane == D;
    row[g] = centre ? 0 : GT_NEGINF;
    cond[g] = centre;
  }
  run_extend<NG>(row, cond, P, W, W32, D, lane);
  const int init_lcp = gt_pick(row, D);
  const bool clip0 = (uclip || vclip) && init_lcp >= W;
  const bool finished0 = init_lcp >= ulen || init_lcp >= vlen || clip0;
  int lb = finished0 ? 1 : 0;
  int ub = finished0 ? -1 : 0;
#pragma unroll
  for (int g = 0; g < NG; ++g)
    row[g] = (32 * g + lane == D) ? init_lcp : GT_NEGINF;
  b.i = init_lcp;
  b.j = init_lcp;
  b.s = 2 * half * init_lcp;
  // ring entry r (the best score dback generations back) in lane r & 31,
  // register r >> 5
  int ring0 = b.s, ring1 = b.s;
  int reason = clip0 ? kClip : kSafe;

  for (int d = 1; lb <= ub && d <= gcap; ++d) {
    live += ub - lb + 3;
    const int dd = d - 1;
    const int glo = max(lb - 1 + D, 0) >> 5;
    const int ghi = min(ub + 1 + D, K - 1) >> 5;
    const int ridx = d % dback;
    const int tref =
        __shfl_sync(GT_FULL, ridx >= 32 ? ring1 : ring0, ridx & 31);
    int i_ext[NG], takes[NG], new_row[NG];
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      i_ext[g] = GT_NEGINF;
      takes[g] = 0;
      cond[g] = 0;
      new_row[g] = GT_NEGINF;
      if (g < glo || g > ghi) continue;        // uniform over the warp
      // row[k-1] and row[k+1]: shuffles within the group, the group's
      // neighbours at its ends
      const int left = (lane == 31) ? (g > 0 ? row[g > 0 ? g - 1 : 0]
                                             : (int)GT_NEGINF)
                                    : row[g];
      const int right = (lane == 0) ? (g + 1 < NG ? row[g + 1 < NG ? g + 1
                                                                  : g]
                                                  : (int)GT_NEGINF)
                                    : row[g];
      const int del_row = __shfl_sync(GT_FULL, left, (lane + 31) & 31);
      const int ins_row = __shfl_sync(GT_FULL, right, (lane + 1) & 31);
      const int s = 32 * g + lane;
      const int kk = s - D;
      const bool in_prev = kk >= -dd && kk <= dd;
      const bool in_prev_m1 = kk - 1 >= -dd && kk - 1 <= dd;
      const bool in_prev_p1 = kk + 1 >= -dd && kk + 1 <= dd;
      const int cand_del =
          (lb < kk && in_prev_m1) ? del_row + 1 : GT_NEGINF;
      const int cand_mis =
          (lb <= kk && kk <= ub && in_prev) ? row[g] + 1 : GT_NEGINF;
      const int cand_ins = (kk < ub && in_prev_p1) ? ins_row : GT_NEGINF;
      int i_new = cand_del;
      if (cand_mis > i_new) i_new = cand_mis;
      if (cand_ins > i_new) i_new = cand_ins;
      if (!(lb - 1 <= kk && kk <= ub + 1) || s >= K) i_new = GT_NEGINF;
      bool has = i_new >= 0;
      const int j_new = i_new - kk;
      const bool pruned =
          d > dback && has &&
          (half * (i_new + j_new) - quantum * d < tref - belowscore);
      if (pruned) i_new = GT_NEGINF;
      has = i_new >= 0;
      const int minuv = min(ulen, vlen + kk);
      const bool cond_edge = kk <= -d || kk >= d;
      const bool cond_mid = row[g] < i_new && i_new <= minuv;
      const bool tk = has && (cond_edge || cond_mid);
      const bool keeps = has && !tk;
      takes[g] = tk;
      cond[g] = tk && i_new < ulen && (i_new - kk) < vlen;
      i_ext[g] = i_new;
      new_row[g] = tk ? 0 : (keeps ? row[g] : GT_NEGINF);
    }
    run_extend<NG>(i_ext, cond, P, W, W32, D, lane);
    int lmax = GT_NEGINF;
    int sc[NG];
    bool clip_l = false;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int kk = 32 * g + lane - D;
      if (takes[g]) new_row[g] = i_ext[g];
      // a run that reaches the clip of a flank that goes on
      clip_l |= cond[g] && ((uclip && i_ext[g] >= W) ||
                            (vclip && i_ext[g] - kk >= W));
      sc[g] = takes[g] ? half * (i_ext[g] + (i_ext[g] - kk)) - quantum * d
                       : GT_NEGINF;
      lmax = max(lmax, sc[g]);
    }
    const int scbest = gt_wmax(lmax);
    if (scbest > b.s) {
      int fi = 1 << 30;
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const int s = 32 * g + lane;
        if (s < K && sc[g] == scbest) fi = min(fi, s);
      }
      const int fidx = gt_wmin(fi);
      const int ib = gt_pick(i_ext, fidx);
      b.i = ib;
      b.j = ib - (fidx - D);
      b.s = scbest;
    }
    if (lane == (ridx & 31)) {
      if (ridx >= 32)
        ring1 = b.s;
      else
        ring0 = b.s;
    }

    const int end_k = ulen - vlen;
    const int eidx = min(max(end_k + D, 0), K - 1);
    const int row_at_end = gt_pick(new_row, eidx);
    const bool done_align = abs(end_k) <= min(d, D) && row_at_end == ulen;
    int kf = 1 << 30, kl = -1;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int s = 32 * g + lane;
      if (new_row[g] > GT_NEGINF) {
        kf = min(kf, s);
        kl = max(kl, s);
      }
    }
    const int first_k = gt_wmin(kf);
    const int last_k = gt_wmax(kl);
    const bool any_row = last_k >= 0;
    int new_lb = any_row ? first_k - D : 1;
    int new_ub = any_row ? last_k - D : -1;
    int kv_l = -1, ku_l = 1 << 30;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int s = 32 * g + lane;
      const int kk = s - D;
      const bool has_row = new_row[g] > GT_NEGINF;
      if (has_row && new_row[g] == vlen + kk && kk <= 0 && kk >= new_lb)
        kv_l = max(kv_l, s);
      if (has_row && new_row[g] == ulen && kk >= 0 && kk <= new_ub)
        ku_l = min(ku_l, s);
    }
    const int kv = gt_wmax(kv_l);
    const int ku = gt_wmin(ku_l);
    if (kv >= 0) new_lb = max(new_lb, kv - D);
    if (ku < K) new_ub = min(new_ub, ku - D);
    const bool edge = any_row && (first_k == 0 || last_k == K - 1);
    const bool clip = __any_sync(GT_FULL, clip_l);
    if (clip)
      reason = kClip;
    else if (edge)
      reason = kEdge;
    const bool stop = done_align || !any_row || edge || clip;
    lb = stop ? 1 : new_lb;
    ub = stop ? -1 : new_ub;
#pragma unroll
    for (int g = 0; g < NG; ++g) row[g] = new_row[g];
  }
  // a lane still alive at the generation cap is unverified too
  if (reason == kSafe && lb <= ub) reason = kCap;
  return reason;
}

// Left to itself, ptxas holds NG = 2, 4, 5 to 56-80 registers with a
// few bytes of spills, a stack frame; the resident blocks it is promised
// here (6 at NG <= 5, 24 warps an SM; 4 above) let every instance keep
// its state in registers
template <int NG>
__global__ void __launch_bounds__(WARPS * 32, NG <= 5 ? 6 : 4)
xdrop_full_kernel(const int64_t* __restrict__ pool, long long stride,
                  const int64_t* __restrict__ su_g,
                  const int64_t* __restrict__ ul_g,
                  const int64_t* __restrict__ sv_g,
                  const int64_t* __restrict__ vl_g,
                  const uint8_t* __restrict__ rev_g,
                  const int32_t* __restrict__ order,
                  int32_t* __restrict__ ctr, int32_t* __restrict__ out,
                  unsigned long long* __restrict__ work, const XConf c,
                  int N) {
  extern __shared__ uint32_t smem[];
  const int lane = threadIdx.x & 31;
  // tier values are selected, never indexed at run time: an indexed
  // parameter array is copied to local memory
  int wmax = c.wt[0];
#pragma unroll
  for (int j = 1; j < kMaxTiers; ++j)
    if (j < c.nt) wmax = c.wt[j];
  uint32_t* P = smem + (size_t)(threadIdx.x >> 5) * 6 * (wmax >> 5);
  for (;;) {
    const int i = gt_next_lane(ctr, lane);
    if (i >= N) break;
    const int t = order[i];
    const int ulen = (int)min((long long)ul_g[t], 1LL << 30);
    const int vlen = (int)min((long long)vl_g[t], 1LL << 30);
    XBest b;
    // a lane's candidate slots fit 32 bits: a live cell needs half *
    // (i + j) >= quantum * d - belowscore within its window, so d <
    // (2 W half + belowscore) / quantum
    int live = 0;
    int tier = 0, reason;
    for (;;) {
      int wt = c.wt[0], gcap = c.gcap[0];
#pragma unroll
      for (int j = 1; j < kMaxTiers; ++j)
        if (j == tier) {
          wt = c.wt[j];
          gcap = c.gcap[j];
        }
      const int W = min((max(max(ulen, vlen), 1) + 31) & ~31, wt);
      // the lane's pool coordinates are read again at each tier, so that
      // no 64-bit value stays live across the generation loop
      load_window(P, gt_lane(pool, stride, su_g, ul_g, sv_g, vl_g, rev_g, t),
                  stride, 0, 0, W >> 5, lane);
      reason = xdrop_lane<NG>(P, W, ulen, vlen, c.D, gcap, c.belowscore,
                              c.quantum, c.half, lane, b, live);
      if ((reason == kClip || reason == kCap) && tier + 1 < c.nt) {
        ++tier;
        continue;
      }
      break;
    }
    if (lane == 0) {
      atomicAdd(work, (unsigned long long)live);
      out[t] = b.i;
      out[N + t] = b.j;
      out[2 * N + t] = b.s;
      out[3 * N + t] = reason != kSafe;
      out[4 * N + t] = tier;
    }
  }
}

size_t window_smem(int wmax) {
  return (size_t)WARPS * 6 * (wmax / 32) * sizeof(uint32_t);
}

bool read_conf(const int* conf, XConf& c) {
  c.nt = conf[0];
  bool ok = c.nt >= 1 && c.nt <= kMaxTiers;
  for (int j = 0; j < kMaxTiers; ++j) {
    c.wt[j] = conf[1 + j];
    c.gcap[j] = conf[1 + kMaxTiers + j];
  }
  for (int j = 0; ok && j < c.nt; ++j)
    ok = c.wt[j] > 0 && (c.wt[j] & 31) == 0 && c.gcap[j] >= 0 &&
         (j == 0 || c.wt[j] >= c.wt[j - 1]);
  c.D = conf[1 + 2 * kMaxTiers];
  c.belowscore = conf[2 + 2 * kMaxTiers];
  c.quantum = conf[3 + 2 * kMaxTiers];
  c.half = conf[4 + 2 * kMaxTiers];
  return ok && c.D >= 1 && c.belowscore >= 0 && c.quantum >= 1 &&
         c.half >= 1 && (c.belowscore + c.half) / c.quantum + 1 <= kRingMax;
}

template <int NG>
int launch(const void* pool, long long stride, const void* const* desc,
           const void* order, void* ctr, void* out, void* work,
           const XConf& c, int N, cudaStream_t st, int* occ) {
  auto kern = xdrop_full_kernel<NG>;
  const size_t smem = window_smem(c.wt[c.nt - 1]);
  if (occ) return (int)gt_occupancy(kern, WARPS * 32, smem, occ);
  int grid = 0;
  cudaError_t e = gt_persistent_grid(kern, WARPS, smem, N, &grid);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, WARPS * 32, smem, st>>>(
      (const int64_t*)pool, stride, (const int64_t*)desc[0],
      (const int64_t*)desc[1], (const int64_t*)desc[2],
      (const int64_t*)desc[3], (const uint8_t*)desc[4],
      (const int32_t*)order, (int32_t*)ctr, (int32_t*)out,
      (unsigned long long*)work, c, N);
  return (int)cudaGetLastError();
}

int dispatch(const void* pool, long long stride, const void* const* desc,
             const void* order, void* ctr, void* out, void* work,
             const XConf& c, int N, cudaStream_t st, int* occ) {
  const int ng = (2 * c.D + 1 + 31) / 32;
#define GT_LAUNCH(NGV)                                                     \
  return launch<NGV>(pool, stride, desc, order, ctr, out, work, c, N, st,  \
                     occ);
  GT_NG_DISPATCH(ng, GT_LAUNCH)
#undef GT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// conf: ntiers, W[4], GENS[4] (per tier), D, belowscore, quantum, half
// (the score is half * (i + j) - quantum * d). desc: ustart,
// ulen, vstart, vlen (int64), rev (uint8). out: (5, N) int32 at each
// lane's own index: ivalue, jvalue, score, unsafe, the last tier run.
extern "C" int gt_xdrop_full(const void* pool, long long stride,
                             const void* const* desc, const void* order,
                             void* ctr, void* out, void* work,
                             const int* conf, int N, void* stream) {
  if (N <= 0) return 0;
  XConf c;
  if (!read_conf(conf, c) || stride < 2) return (int)cudaErrorInvalidValue;
  return dispatch(pool, stride, desc, order, ctr, out, work, c, N,
                  (cudaStream_t)stream, nullptr);
}

// out: resident blocks per SM, registers a thread, SMs for the kernel
// the same conf launches.
extern "C" int gt_xdrop_full_occupancy(const int* conf, int* out) {
  XConf c;
  if (!read_conf(conf, c)) return (int)cudaErrorInvalidValue;
  return dispatch(nullptr, 0, nullptr, nullptr, nullptr, nullptr, nullptr,
                  c, 0, nullptr, out);
}
