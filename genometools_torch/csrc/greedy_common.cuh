// The greedy front-prune recurrence shared by K1 (greedy_full.cu), K2
// (greedy_chunk.cu) and K2r (greedy_resident.cu): one warp per task, slot
// s = 32*g + lane for g < NG.
//
// Per generation: the ins > mis > del predecessor pick, the 64-bit
// history shift, the match run, the percmathistory /
// maxalignedlendifference trim, the 2x15-bit polishing walk and the
// completion test (ref: ft-front-prune.c:633, ft-polish.c). Rows and
// diagonals are relative to the task's window: kbase = dv - du and
// rowbase = du place them on the extension (both 0 in K1), and
// alignedlen is absolute (albase = 2*rowbase + kbase), as in
// genometools_tpu/ops/greedy_batch.py greedy_chunk_xla.
#pragma once

#include "common.cuh"

struct GreedyArgs {
  int W, W32, D, K, gcap, cut_depth, mmp128, mad, ms, ds, hist_cap;
  int ulen_c, vlen_c, urem, vrem, kbase, rowbase, albase;
  bool u_more, v_more;
  uint64_t hmask;
};

// The run-independent fields of GreedyArgs; the per-task ones
// (ulen_c .. v_more) are set by gt_greedy_task.
__device__ __forceinline__ GreedyArgs gt_greedy_args(int W, int D, int gcap,
                                                     int cut_depth,
                                                     int mmp128, int mad,
                                                     int ms, int ds,
                                                     int hist_cap) {
  GreedyArgs a;
  a.W = W;
  a.W32 = W >> 5;
  a.D = D;
  a.K = 2 * D + 1;
  a.gcap = gcap;
  a.cut_depth = cut_depth;
  a.mmp128 = mmp128;
  a.mad = mad;
  a.ms = ms;
  a.ds = ds;
  a.hist_cap = hist_cap;
  a.hmask = gt_ones64(hist_cap);
  return a;
}

__device__ __forceinline__ void gt_greedy_task(GreedyArgs& a, int urem,
                                               int vrem, int kbase,
                                               int rowbase) {
  a.urem = urem;
  a.vrem = vrem;
  a.ulen_c = min(urem, a.W);
  a.vlen_c = min(vrem, a.W);
  a.u_more = urem > a.W;
  a.v_more = vrem > a.W;
  a.kbase = kbase;
  a.rowbase = rowbase;
  a.albase = 2 * rowbase + kbase;
}

// Copy a task's six window planes (6*W32 words) into shared memory.
__device__ __forceinline__ void gt_load_planes(uint32_t* P,
                                               const uint32_t* src,
                                               int nwords, int lane) {
  for (int i = lane; i < nwords; i += 32) P[i] = src[i];
  __syncwarp();
}

__device__ __forceinline__ void polish_walk(int prefix, int ms, int ds,
                                            int cut_depth, int& dfm,
                                            int& ss) {
  int score = 0, maxscore = 0;
  for (int b = cut_depth - 1; b >= 0; --b) {
    maxscore = max(maxscore, score);
    score += ((prefix >> b) & 1) ? ms : -ds;
  }
  dfm = score - maxscore;
  ss = score;
}

template <int NG>
__device__ __forceinline__ void add_matches(int (&row)[NG], uint64_t (&h)[NG],
                                            int (&hs)[NG],
                                            const int (&cond)[NG],
                                            const uint32_t* P,
                                            const GreedyArgs& a, int lane) {
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    int r = row[g];
    if (!cond[g] || r < 0 || r >= a.W) continue;
    int diag = 32 * g + lane - a.D;
    uint64_t hh = h[g];
    int hz = hs[g];
    int c;
    do {
      c = gt_ctz_not(gt_match_bits(P, a.W32, r, diag));
      hh = (hh << c) | gt_ones64(c);
      hz = min(hz + c, a.hist_cap);
      r += c;
    } while (c == 32);
    row[g] = r;
    h[g] = hh;
    hs[g] = hz;
  }
}

// Trim, polished-point update and completion test (the reference's
// trim_and_score); `val` is trimmed in place. done is the lane's
// done flag as the reference passes it.
template <int NG>
__device__ __forceinline__ void trim_and_score(
    const int (&row)[NG], const uint64_t (&h)[NG], const int (&hs)[NG],
    const int (&mm)[NG], int (&val)[NG], int d, int (&best)[4], bool done,
    const GreedyArgs& a, int lane, bool& died_now, bool& complete_now) {
  int al[NG];
  int lmax = GT_NEGINF;
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    int k = 32 * g + lane - a.D;
    al[g] = val[g] ? 2 * max(row[g], 0) + k + a.albase : GT_NEGINF;
    lmax = max(lmax, al[g]);
  }
  int maxal = gt_wmax(lmax);
  int minlen = max(maxal - a.mad, 0);
  int kfirst = 1 << 30, klast = -1;
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    int s = 32 * g + lane;
    int k = s - a.D;
    int need = (hs[g] * a.mmp128) >> 7;
    bool keep = val[g] && row[g] <= a.ulen_c && row[g] + k <= a.vlen_c &&
                al[g] >= minlen && __popcll(h[g] & a.hmask) >= need;
    if (keep) {
      kfirst = min(kfirst, s);
      klast = max(klast, s);
    }
  }
  int first = gt_wmin(kfirst);
  int last = gt_wmax(klast);
  bool anyk = last >= 0;
  died_now = !anyk && !done;
  int cmax = GT_NEGINF;
  int cand[NG];
  const int pol_size = 2 * a.cut_depth;
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    int s = 32 * g + lane;
    val[g] = val[g] && anyk && s >= first && s <= last;
    cand[g] = GT_NEGINF;
    // a slot at or below best[0] cannot move it: no polishing walk
    if (val[g] && !done && al[g] > best[0]) {
      int fill = max(pol_size - hs[g], 0);
      uint64_t shf = hs[g] >= 64 ? 0ull : (gt_ones64(fill) << hs[g]);
      uint32_t filled = (uint32_t)h[g] | (uint32_t)shf;
      int dfm_lo, ss_lo, dfm_hi, ss_hi;
      polish_walk((int)(filled & 0x7FFFu), a.ms, a.ds, a.cut_depth, dfm_lo,
                  ss_lo);
      polish_walk((int)((filled >> a.cut_depth) & 0x7FFFu), a.ms, a.ds,
                  a.cut_depth, dfm_hi, ss_hi);
      if (dfm_lo >= 0 && ss_lo + dfm_hi >= 0) cand[g] = al[g];
    }
    cmax = max(cmax, cand[g]);
  }
  int cbest = gt_wmax(cmax);
  if (cbest > best[0]) {
    int fi = 1 << 30;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      int s = 32 * g + lane;
      if (s < a.K && cand[g] == cbest) fi = min(fi, s);
    }
    int fidx = gt_wmin(fi);
    int rs[NG];
#pragma unroll
    for (int g = 0; g < NG; ++g) rs[g] = max(row[g], 0);
    best[0] = cbest;
    best[1] = gt_pick(rs, fidx) + a.rowbase;
    best[2] = d;
    best[3] = gt_pick(mm, fidx);
  }
  // completion: the front reaches (urem, vrem) on the end diagonal
  int e_rel = a.vrem - a.urem;
  int eidx = min(max(e_rel + a.D, 0), a.K - 1);
  bool inband = e_rel >= -a.D && e_rel <= a.D;
  int v_e = gt_pick(val, eidx);
  int r_e = gt_pick(row, eidx);
  bool ok_k = abs(e_rel + a.kbase) <= d && inband && v_e &&
              r_e == (inband ? a.urem : GT_NEGINF);
  complete_now = ok_k && !done;
}

// out[g] (slot 32g + lane of NO groups) = a[slot + delta] (NI groups),
// for any delta; values of source slots outside [0, 32*NI) are undefined
// (the caller masks them).
template <int NI, int NO, typename T>
__device__ __forceinline__ void gt_slot_shift(const T (&a)[NI], T (&out)[NO],
                                              int delta, int lane) {
  const int dr = delta & 31;
  const int dq = delta >> 5;                 // floor division
  const int src = (lane + dr) & 31;
  const int carry = (lane + dr) >> 5;
  T x[NI];
#pragma unroll
  for (int j = 0; j < NI; ++j) x[j] = __shfl_sync(GT_FULL, a[j], src);
#pragma unroll
  for (int g = 0; g < NO; ++g) {
    const int js = g + dq + carry;
    T v = x[0];
#pragma unroll
    for (int j = 1; j < NI; ++j)
      if (js == j) v = x[j];
    out[g] = v;
  }
}

// Up to a.gcap generations of a scored state. A generation whose front
// touches the window end or the slot edge is not committed: the lane
// stops there and the function returns true (paused). COUNT: *live gains
// the live slots of every generation computed (the work the data needs).
template <int NG, bool COUNT = false>
__device__ __forceinline__ bool gt_generations(
    int (&row)[NG], uint64_t (&h)[NG], int (&hs)[NG], int (&mm)[NG],
    int (&val)[NG], int& d_lane, int (&best)[4], bool& done, bool& died,
    const uint32_t* P, const GreedyArgs& a, int lane,
    long long* live = nullptr) {
  for (int t = 0; !done && t < a.gcap; ++t) {
    int vin[NG], vde[NG], rin[NG], rde[NG], hsin[NG], hsde[NG], mmin[NG],
        mmde[NG];
    uint64_t hin[NG], hde[NG];
    gt_from_left<NG>(val, vin, 0, lane);
    gt_from_right<NG>(val, vde, 0, lane);
    gt_from_left<NG>(row, rin, 0, lane);
    gt_from_right<NG>(row, rde, 0, lane);
    gt_from_left<NG>(h, hin, (uint64_t)0, lane);
    gt_from_right<NG>(h, hde, (uint64_t)0, lane);
    gt_from_left<NG>(hs, hsin, 0, lane);
    gt_from_right<NG>(hs, hsde, 0, lane);
    gt_from_left<NG>(mm, mmin, 0, lane);
    gt_from_right<NG>(mm, mmde, 0, lane);
    int row_n[NG], hs_n[NG], mm_n[NG], anyc[NG];
    uint64_t h_n[NG];
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      int s = 32 * g + lane;
      int r_ins = vin[g] ? rin[g] : GT_NEGINF;
      int r_mis = val[g] ? row[g] + 1 : GT_NEGINF;
      int r_del = vde[g] ? rde[g] + 1 : GT_NEGINF;
      int r_new = max(max(r_ins, r_mis), r_del);
      anyc[g] = (r_new > GT_NEGINF) && s < a.K;
      bool t_ins = vin[g] && r_ins == r_new;
      bool t_mis = val[g] && r_mis == r_new;
      bool t_del = vde[g] && r_del == r_new;
      bool use_ins = t_ins;
      bool use_mis = t_mis && !use_ins;
      bool use_del = t_del && !use_ins && !use_mis;
      uint64_t hn = use_ins ? hin[g] : use_mis ? h[g] : use_del ? hde[g] : 0ull;
      int hsn = use_ins ? hsin[g] : use_mis ? hs[g] : use_del ? hsde[g] : 0;
      int mm_ins = t_ins ? mmin[g] : GT_NEGINF;
      int mm_mis = t_mis ? mm[g] + 1 : GT_NEGINF;
      int mm_del = t_del ? mmde[g] : GT_NEGINF;
      // a deletion's mismatch count only when it wins outright
      // (ref: ft-front-prune.c:395-407)
      int mm_im = max(mm_ins, mm_mis);
      mm_n[g] = mm_im > GT_NEGINF ? mm_im : mm_del;
      hs_n[g] = min(hsn + 1, a.hist_cap);
      h_n[g] = hn << 1;
      row_n[g] = anyc[g] ? r_new : GT_NEGINF;
    }
    if (COUNT) {
#pragma unroll
      for (int g = 0; g < NG; ++g)
        *live += __popc(__ballot_sync(GT_FULL, anyc[g]));
    }
    add_matches<NG>(row_n, h_n, hs_n, anyc, P, a, lane);
    bool contact_l = false;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      int s = 32 * g + lane;
      int k = s - a.D;
      contact_l |= anyc[g] && ((a.u_more && row_n[g] >= a.W) ||
                               (a.v_more && row_n[g] + k >= a.W) || s <= 0 ||
                               s >= a.K - 1);
    }
    if (__any_sync(GT_FULL, contact_l)) return true;
    d_lane += 1;
    bool died_now, complete_now;
    trim_and_score<NG>(row_n, h_n, hs_n, mm_n, anyc, d_lane, best, false, a,
                       lane, died_now, complete_now);
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      row[g] = row_n[g];
      h[g] = h_n[g];
      hs[g] = hs_n[g];
      mm[g] = mm_n[g];
      val[g] = anyc[g];
    }
    died = died || died_now;
    done = done || died_now || complete_now;
  }
  return false;
}

// K2's launch: KERNEL<NG> (NG = ceil(K/32)) over N tasks, 4 warps a block, with
// the tasks' window planes as dynamic shared memory (opted in above
// 48 KB). ARGS is the kernel's argument list.
#define GT_GREEDY_LAUNCH(KERNEL, NGV, N, W, ST, ...)                      \
  {                                                                       \
    const int warps = 4;                                                  \
    const size_t smem = (size_t)warps * 6 * ((W) / 32) * sizeof(uint32_t); \
    const dim3 grid(((N) + warps - 1) / warps), block(32 * warps);        \
    auto kern = KERNEL<NGV>;                                              \
    if (smem > 48 * 1024) {                                               \
      cudaError_t e = cudaFuncSetAttribute(                               \
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);  \
      if (e != cudaSuccess) return (int)e;                                \
    }                                                                     \
    kern<<<grid, block, smem, (ST)>>>(__VA_ARGS__);                       \
  }
