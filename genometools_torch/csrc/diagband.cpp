// The diagonal-band filter of seed_extend's wave engine: one linear pass
// over the joined seed pairs (ref: src/match/diagband-struct.c).
//
// The pairs arrive sorted by (aseq, bseq, bpos, apos); a segment is a run
// of equal (aseq, bseq). Within a segment each seed falls in the band
// ((amaxlen + bpos - apos) >> logw) + 1, and the seeds of one band come in
// ascending bpos, so a band's coverage accumulates in one walk: the band's
// first seed adds k, every later one min(k, bpos - the band's last bpos).
// A second walk keeps a seed when its band and the better of the two
// neighbouring bands cover mincov. The band-indexed scratch is cleared at
// the bands the segment touched, so a segment costs O(its seeds).
//
// Outputs (caller-owned, n entries each): idx, the kept pair indices in
// ascending order; sseg, each kept seed's ordinal among the segments that
// keep one; kstart, those segments' first pair indices; g_end, each such
// segment's end in idx. Returns the number of kept seeds and sets *nkept,
// or returns -1 when a seed lies below the lowest band (bpos - apos <
// -amaxlen), which no join of valid k-mer lists gives.
//
// Plain C ABI, loaded via ctypes with the shared host library.

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

struct Band {
  int64_t score, last;    // last: the band's last bpos, -1 before its first
};

template <typename T>
int64_t diagband_select(const T *aseq, const T *bseq, const T *bpos,
                        const T *apos, int64_t n, int64_t k, int64_t amaxlen,
                        int logw, int64_t mincov, int use_filter,
                        int64_t *idx, int64_t *sseg, int64_t *kstart,
                        int64_t *g_end, int64_t *nkept_out) {
  std::vector<Band> bands;      // grows to the highest band seen, plus 2
  std::vector<size_t> touched;
  int64_t nsel = 0, nkept = 0;
  for (int64_t s0 = 0, s1; s0 < n; s0 = s1) {
    s1 = s0 + 1;
    while (s1 < n && aseq[s1] == aseq[s0] && bseq[s1] == bseq[s0]) s1++;
    const int64_t before = nsel;
    if (!use_filter) {
      for (int64_t i = s0; i < s1; i++) {
        idx[nsel] = i;
        sseg[nsel++] = nkept;
      }
    } else {
      for (int64_t i = s0; i < s1; i++) {
        const int64_t diag = amaxlen + (int64_t)bpos[i] - (int64_t)apos[i];
        if (diag < 0) return -1;
        const size_t d = (size_t)(diag >> logw) + 1;
        if (d + 2 > bands.size())
          bands.resize(std::max(d + 2, 2 * bands.size()), Band{0, -1});
        Band &b = bands[d];
        const int64_t key = bpos[i];
        if (b.last < 0) {
          b.score = k;
          touched.push_back(d);
        } else {
          b.score += std::min(k, key - b.last);
        }
        b.last = key;
      }
      for (int64_t i = s0; i < s1; i++) {
        const size_t d = (size_t)((amaxlen + (int64_t)bpos[i] -
                                   (int64_t)apos[i]) >> logw) + 1;
        if (bands[d].score + std::max(bands[d - 1].score,
                                      bands[d + 1].score) >= mincov) {
          idx[nsel] = i;
          sseg[nsel++] = nkept;
        }
      }
      for (size_t d : touched) bands[d] = Band{0, -1};
      touched.clear();
    }
    if (nsel > before) {
      kstart[nkept] = s0;
      g_end[nkept++] = nsel;
    }
  }
  *nkept_out = nkept;
  return nsel;
}

}  // namespace

extern "C" {

// The native seed-pair join's int32 planes.
int64_t gt_diagband_select_i32(const int32_t *aseq, const int32_t *bseq,
                               const int32_t *bpos, const int32_t *apos,
                               int64_t n, int64_t k, int64_t amaxlen,
                               int logw, int64_t mincov, int use_filter,
                               int64_t *idx, int64_t *sseg, int64_t *kstart,
                               int64_t *g_end, int64_t *nkept) {
  return diagband_select(aseq, bseq, bpos, apos, n, k, amaxlen, logw, mincov,
                         use_filter, idx, sseg, kstart, g_end, nkept);
}

// The numpy join's int64 arrays (32-mers, positions past 2^31).
int64_t gt_diagband_select_i64(const int64_t *aseq, const int64_t *bseq,
                               const int64_t *bpos, const int64_t *apos,
                               int64_t n, int64_t k, int64_t amaxlen,
                               int logw, int64_t mincov, int use_filter,
                               int64_t *idx, int64_t *sseg, int64_t *kstart,
                               int64_t *g_end, int64_t *nkept) {
  return diagband_select(aseq, bseq, bpos, apos, n, k, amaxlen, logw, mincov,
                         use_filter, idx, sseg, kstart, g_end, nkept);
}

}  // extern "C"
