// The pool reader, the work queue and the occupancy query shared by the
// persistent kernels K1 (greedy_full.cu), K2r (greedy_resident.cu) and K3
// (xdrop_full.cu).
//
// The pool (ops/pool.py upload_pool) is six planes of int64 words, each
// holding one uint32 plane word: rows 0-2 the lo, hi and special bits of
// the forward pool, rows 3-5 those of the reversed pool (a left flank is
// a forward flank there). A lane is two flanks given by (start, len) in
// its plane set's coordinates and a rev flag. A warp takes lanes from an
// atomic counter over an order the wrapper chose (longest first), so a
// warp that finishes takes new work and a launch's tail is short; the
// grid is one wave of the blocks the card keeps resident.
#pragma once

#include "common.cuh"

// Word w (32 symbols from start + 32w) of one plane of a flank of `len`
// symbols read from `start` (plane-set coordinates); symbols at or past
// len are special with zero code bits. As ops/pool.py pk_from_pool.
__device__ __forceinline__ uint32_t pool_word(const int64_t* plane,
                                              long long qmax,
                                              long long start,
                                              long long len, int w,
                                              bool special) {
  const long long q = min((start >> 5) + w, qmax);
  const uint32_t x = __funnelshift_r((uint32_t)plane[q],
                                     (uint32_t)plane[q + 1],
                                     (int)(start & 31));
  const long long nb = len - 32LL * w;
  const uint32_t live =
      nb >= 32 ? 0xffffffffu : nb <= 0 ? 0u : ((1u << nb) - 1u);
  return special ? (x | ~live) : (x & live);
}

struct Lane {
  long long su, ulen, sv, vlen;
  const int64_t* planes;        // the plane set: pool rows 0-2 or 3-5
};

__device__ __forceinline__ Lane gt_lane(const int64_t* pool,
                                        long long stride,
                                        const int64_t* su,
                                        const int64_t* ul,
                                        const int64_t* sv,
                                        const int64_t* vl,
                                        const uint8_t* rev, int t) {
  Lane L;
  L.su = su[t];
  L.ulen = ul[t];
  L.sv = sv[t];
  L.vlen = vl[t];
  L.planes = pool + (rev[t] ? 3 : 0) * stride;
  return L;
}

// The six window planes u[du:du+W], v[dv:dv+W] (W = 32*W32) into the
// warp's shared memory P (6*W32 words).
__device__ __forceinline__ void load_window(uint32_t* P, const Lane& L,
                                            long long stride, long long du,
                                            long long dv, int W32,
                                            int lane) {
  __syncwarp();
  const long long qmax = stride - 2;
  for (int i = lane; i < 6 * W32; i += 32) {
    const int pl = i / W32;
    const int w = i - pl * W32;
    const bool vside = pl >= 3;
    const int p = vside ? pl - 3 : pl;
    P[i] = vside ? pool_word(L.planes + p * stride, qmax, L.sv + dv,
                             L.vlen - dv, w, p == 2)
                 : pool_word(L.planes + p * stride, qmax, L.su + du,
                             L.ulen - du, w, p == 2);
  }
  __syncwarp();
}

// The exact match run at the start of the flank pair, read 1,024
// symbols (one word a thread) at a time.
__device__ __forceinline__ long long first_run(const Lane& L,
                                               long long stride, int lane) {
  const long long qmax = stride - 2;
  const int64_t* p = L.planes;
  for (long long c = 0;; c += 1024) {
    const long long us = L.su + c, ul = L.ulen - c;
    const long long vs = L.sv + c, vl = L.vlen - c;
    const uint32_t m =
        ~(pool_word(p, qmax, us, ul, lane, false) ^
          pool_word(p, qmax, vs, vl, lane, false)) &
        ~(pool_word(p + stride, qmax, us, ul, lane, false) ^
          pool_word(p + stride, qmax, vs, vl, lane, false)) &
        ~pool_word(p + 2 * stride, qmax, us, ul, lane, true) &
        ~pool_word(p + 2 * stride, qmax, vs, vl, lane, true);
    const unsigned notfull = __ballot_sync(GT_FULL, m != 0xffffffffu);
    if (notfull) {
      const int f = __ffs(notfull) - 1;
      return c + 32 * f + gt_ctz_not(__shfl_sync(GT_FULL, m, f));
    }
  }
}

// The warp's next queue position (>= N: the queue is empty).
__device__ __forceinline__ int gt_next_lane(int32_t* ctr, int lane) {
  int i = 0;
  if (lane == 0) i = atomicAdd(ctr, 1);
  return __shfl_sync(GT_FULL, i, 0);
}

// Opt KERN in to `smem` bytes of dynamic shared memory and read what the
// card keeps of it: out[0] resident blocks per SM, out[1] registers a
// thread, out[2] SMs.
template <typename Kern>
cudaError_t gt_occupancy(Kern kern, int threads, size_t smem, int* out) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kern, threads,
                                                    smem);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  if ((e = cudaFuncGetAttributes(&attr, kern)) != cudaSuccess) return e;
  out[1] = attr.numRegs;
  int dev = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  return cudaDeviceGetAttribute(&out[2], cudaDevAttrMultiProcessorCount,
                                dev);
}

// The persistent grid for N lanes at `warps` a block: one wave of
// resident blocks, no more than the lanes need.
template <typename Kern>
cudaError_t gt_persistent_grid(Kern kern, int warps, size_t smem, int N,
                               int* grid) {
  int occ[3];
  cudaError_t e = gt_occupancy(kern, 32 * warps, smem, occ);
  if (e != cudaSuccess) return e;
  if (occ[0] < 1) return cudaErrorInvalidConfiguration;
  const int need = (N + warps - 1) / warps;
  *grid = occ[0] * occ[2] < need ? occ[0] * occ[2] : need;
  return cudaSuccess;
}
