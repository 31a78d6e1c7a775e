"""Drive genometools_torch's main path once on one CUDA card.

    python3 chip_smoke.py [--gens 48,384,1536] [--profile]

Run from the root of a checkout. Phases, each printed with its seconds:

  1. setup: build the CUDA kernels from genometools_torch/csrc; nvcc's
     ptxas report of the build in use (registers, spills, stack frames;
     K3 must have no frame: its score ring lives in registers); the
     persistent kernels' occupancy (K2r at each window tier, K1 at its
     slot tiers, K3 at its window tiers);
  2. K1 (greedy), K2 (greedy chunk), K2r (the resident K2) and K3
     (xdrop) against their plain PyTorch versions on the card, at every
     shape the main paths launch (K1's D = 128 rescue on the lanes its
     slot ladder leaves undone, or on 4,096 lanes of each set when it
     leaves none); K1 and K3 also on 131,072 lanes of
     at1MB's own extension workload (some 80 lanes for each persistent
     warp), K3 also on long and off-band lanes (it must take some of
     the lanes the reference routes to the host), and on 65,536 random
     lanes at ltrharvest's and tirvish's scores (2, -2, -3, -3): quantum 4,
     belowscore 5; K2r with window tiers
     up to each tier (the shared memory it holds), under the default and
     weak trims, so that each run covers its widest tier and the weak
     runs both slot tiers (exact: tolerance 0, the outputs are integers,
     the kernels' slot-generation counters included);
  3. `python -m genometools_torch suffixerator -suf -lcp -tis` on the
     at1MB test genome: .suf/.lcp/.llv must equal gt's goldens; then
     build_esa on the card for all nine tests/golden_esa indexes:
     .suf/.lcp/.llv/.prj/.bwt/.bck must equal the goldens;
  4. the suffix array and LCP of a 32 Mbp synthetic genome on the card,
     by the packed pipeline and by prefix doubling, each against the host
     SA-IS and Kasai engines; the pipeline's stages (CUDA events: pack,
     bootstrap sort, refinement rounds with the tied count after each,
     the SA scatter, the lcp base, the deep pairs and their descent), the
     device-to-host copies, and each engine's whole time, warm;
  5. the at1MB extension workload through the greedy and xdrop batches:
     the exactness anchors (alignedlen sum 157,827,064 over 530,140
     tasks; score sum 17,549,780 over 65,536 tasks at belowscore 7),
     and the workload's flank-length histogram;
  6. the seed_extend CLI (greedy, then xdrop) on the phase-3 index
     against the reference's fused host engine, with the kernels'
     launch counts, lanes by route and tier, and the work of their
     launches read around this run (the main path of K1 and K3);
  7. long flanks on g4m_planted_repeats (two 2 Mbp sequences with 150
     planted repeats, numpy seed 2026): (a) the suffixerator and
     seed_extend -extendgreedy CLI against the fused host engine, with
     the launch counts read around the seed_extend run (the main path
     of K2r; K2 must not run there); (b) 65,536 flank tasks of its
     extension workload, clipped at 16,384, through three routes in
     turns: the resident kernel, the host-driven chunk loop with K2
     (RESIDENT = False; K2's launches are read around this route's first
     run) and the host engine (skip_chunked): equal alignedlen sums; then
     K2r against its plain version on all 65,536 tasks, lane by lane (a
     main-path lane count: each resident warp takes some 40 lanes from
     the queue). --gens repeats the two K2 routes at other chunk GENS;
  8. suffixerator_e2e (the library's end-to-end writer) at at1MB and at
     32 Mbp: every file equals the slow path's (Encseq.save + build_esa +
     write_esa), at1MB's index files equal the goldens; its wall time
     beside the host SA-IS + Kasai engines';
  9. `suffixerator -parts 3` and `-memlimit 4MB` through the port's CLI
     on at1MB (two processes at once): .suf/.lcp/.llv/.prj equal the
     goldens;
  10. wide: 2^30 + 2^20 symbols of random ACGT with about 0.1 % specials,
     made on the card from a seeded torch.Generator, through
     build_suffix_array with LCP; held by the device certificate
     (check_sa_lcp: a permutation, and every adjacent pair's first lcp
     keys agree and the next is smaller); the stages, the rounds, and
     the peak device memory, which must stay under 64 GB;
  11. the seed_extend grid on the phase-3 index: the CLI with -parts 3,
     greedy then xdrop, whose sorted lines must equal phase 6's; the
     library's -parts 3 grid through the fused host engine, equal to the
     wave grid line for line; the six -pick cells, whose concatenation
     in grid order must equal the -parts 3 lines; launches and lanes
     read around the CLI runs;
  12. repfind: the CLI's `-l 14 -f -r -p` on the phase-3 index against
     the maximal pairs of ESAs built by the host SA-IS and Kasai
     engines (the text's, and the concatenated texts' for -r/-p); the
     extensions of every maximal pair, greedy and xdrop, through the
     batches (K1, K2r, K3) against the reference's per-pair host route
     (engine="host"): on at1MB through the CLI at -l 14, on phase 7's
     g4m index through the library at -l 30, with the pairs, the
     matches, the launches, the lanes by route, the share of xdrop
     lanes on the host engine (over 1 % on g4m fails) and both routes'
     seconds; then K3 at the wide tiers (8,192 and 32,768) against its
     plain version on 128 of g4m's right flanks that K3 leaves unsafe
     at 2,048;
  13. tallymer (BASELINE config 2) over phase 3's index of at1MB:
     `tallymer mkindex -mersize 19` (index files and the histogram) and
     `tallymer search -strand fp` of Atinsert plus 10,000 reads of 100
     bp sampled from at1MB (numpy seed 7), as CLI calls in process; the
     ESA route (mkindex over load_esa(need_lcp="small")) must write the
     direct route's bytes, the mers and counts must equal the brute
     force, and the search's lines the library's; then at 32 Mbp (phase
     4's synthetic): mkindex over build_esa's ESA on the card against
     mkindex_direct and the brute force, and the device window scan
     (ops/kmer.py) with torch.unique on the card against the brute
     force;
  14. readjoiner (BASELINE config 5): error-free 100 bp reads at 20x
     from g4m_planted_repeats (numpy seed 1, half reverse-complemented,
     reads with n dropped) through `readjoiner prefilter`, `overlap -l
     45`, `assembly -l 45` and `cgraph`, then `encseq2spm -l 45` over an
     in-process `suffixerator -tis` of the kept reads: 10,000 sampled
     SPMs are suffix-prefix matches of 45 or more, 10,000 sampled
     contained reads occur in a kept read or its reverse complement,
     the native SPM join equals the numpy join on the kept reads that
     start in sequence 0's first 500,000 bp, the two SPM counts agree
     (overlap's and encseq2spm's); the reads, contained reads, SPMs,
     contigs, their length, N50 and how many occur verbatim in the
     genome;
  15. genomediff and shulengthdist on g4m's two sequences (one ESA of
     the joined texts sorted on the card, its size printed), uniquesub -min 10 -max 20 and
     matstat with phase 3's at1MB index and Atinsert: each tool's lines
     against the same tool over ESAs built by the host SA-IS and Kasai
     engines, with the seconds of each tool and of its build_esa calls.
  16. ltrharvest, tirvish and ltrclustering on a 32 Mbp genome of planted
     transposons (4 x 8,000,000 bp, numpy seed 2027, 400 LTR elements of 40
     families, 200 TIR elements: utils/synthetic.py): suffixerator -tis
     -suf -lcp, then ltrharvest with the reference's defaults (the
     library, with its maximal pairs, lanes by route, K3 launches,
     distinct similarity candidates and step seconds; the CLI with
     -longoutput -out -outinner against the library), tirvish (its
     mirrored ESA of 64 Mbp + 1 symbols on the card) and ltrclustering
     -psmall 80 -plarge 30 on ltrharvest's GFF3 through the CLI; the batch
     routes against the host routes (one maximal pair at a time) on the
     whole genome (tabout lines, GFF3, FASTA), ltrclustering against seed_extend's
     fused host engine; K3 must launch in ltrharvest and tirvish, K1 in
     ltrclustering; the recall of the planted elements within 3 bp is
     printed;
  17. the packed index: packedindex mkindex of phase 3's at1MB index;
     chkintegrity of gt's four .bdx goldens beside copies of their
     golden indexes (rev.bdx with -dir 1); tagerator -esa and -pck over
     the golden Atinsert index with gt's tags, per-tag rows equal to gt's
     goldens (-maxocc 5, where gt computes prefix matches, must keep rows
     of the full search); tagerator -e 2 of 1,000 24-mers of at1MB with
     0-2 random edits (numpy seed 8), -esa rows equal -pck rows, and so
     of 100 tags of 32-40 bp; FMDeviceRank.backward_search_batch of those tags on the card against
     the host backward search (CUDA events); prebwt -maxdepth 8 against
     one host backward search per code; mergeesa of at1MB and Atinsert against host
     SA-IS + Kasai over the concatenation; sain -check on at1MB.
  18. the multi-device layer (genometools_torch/parallel) on a mesh of
     eight shards of the card: the sharded suffix array of phase 4's
     32 Mbp genome by the sample-sort engine (8 shards and 1, its
     overflow flag 0), the bitonic engine and the int64 lanes (8 shards
     and 1), each equal to the packed pipeline's; build_suffix_array's
     wide route on 2^28 non-canonical keys (UNDEFCHAR runs), held by the
     certificate, with its sort and host Kasai seconds and peak device
     memory; sharded_suffix_sort (as deep as at1MB's largest lcp),
     sharded_kmer_histogram and distributed_build_sa of at1MB against
     phase 3's SA; distributed_seed_extend -parts 3 over 4 lanes, greedy
     then xdrop, equal to phase 11's lines, K1 and K3 launched on every
     lane (the launches a lane printed); sharded_mer_counts at 32 Mbp,
     k = 15, against torch.unique on the card; distributed_find_spms on
     g4m reads at 5x (-l 45, no transitive filter) against find_spms;
     distributed_maxpairs of at1MB at -l 14 against enumerate_maxpairs;
     `suffixerator -dist 8` (the goldens; one card is the one-shard
     route) and `seed_extend -dist 4 -parts 3` (phase 11's lines); then
     dryrun_multichip(8, "cuda"). The kernels' launches in its grid and
     -dist runs are added to the main paths' in the kernels line.
  19. the annotator's pipeline on phase 16's genome, through the port's
     CLI: chseqids (phase 16's seq0..seq3 onto pt.fna's chr_0..chr_3),
     gff3 -sort -retainids, ltrdigest -trnas -seqfile with a library of
     200 tRNA-like sequences of 72-90 bp (numpy seed 2029, 100 of them
     ending in the reverse complement of the 18 bp after a planted 5'
     LTR: utils/synthetic.py::trna_library), ltrdigest -outfileprefix,
     then stat, gff3validator and extractfeat -type LTR_retrotransposon
     on ltrdigest's output; every step must exit 0. The CLI's GFF3 must
     equal the library's (engine="batch"); ltrdigest must find elements
     and annotate planted PBS; the PBS batch's hits must equal the host
     route's (pbs_find, one local_alignment at a time) on 8 elements
     only: the first 8 whose 5' LTR ends within 5 bp of a planted
     primer's (3,200 alignments: the host route takes some 8 ms an
     alignment on the card's host, so all of them would take some 20
     minutes); the batch's raw rows (score, ustart, uend, vstart,
     edist) must equal pbs_align's on 512 lanes drawn with numpy seed
     2030 from all of them, lanes with no hit included; every
     extracted element must equal its slice of pt.fna; gff3validator
     must print "input is valid GFF3". Printed: each step's seconds, the
     PPT search's, the PBS batch's (fill, traceback, host filters), the
     lanes, the peak device memory, and the planted PBS found within 3 bp.

Each kernel's bound is the larger of its bytes (inputs read once,
outputs written once) over 3.35 TB/s and its integer operations over
the H100's INT32 rate (132 SMs x 64 lanes x 1.98 GHz); the
operations are the live slot-generations of the same inputs (the
kernel's own counter for K1, K2r and K3; the plain version's count for
K2), times OPS_PER_SLOT_GEN.

Any mismatch or error exits non-zero before the last line. The last
line is the device JSON; the line before it lists the kernels. Without
a CUDA card, or without the rest of the repository beside it, the
script fails.
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import gzip
import io
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
AT1MB = ROOT / "tests" / "golden_esa" / "at1MB" / "idx"
GREEDY_ANCHOR = (530140, 157827064)
XDROP_ANCHOR = (65536, 17549780)
LONG_ANCHOR = 85172588          # phase 7b's alignedlen sum
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# integer operations one live slot needs per generation, at the least:
# the predecessor pick, the history and counter updates, one match word
# from the six planes and its run, the trim tests (greedy); the
# candidate pick, the prune test, one match word and the score (xdrop).
# The polishing walk and the warp reductions are not counted.
OPS_PER_SLOT_GEN = {"K1": 64, "K2": 64, "K2r": 64, "K3": 48}


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        log(f"== phase {self.name}")
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"== phase {self.name} ok "
                f"{time.perf_counter() - self.t0:.3f}s")
        return False


def ptxas_summary(build_log: str) -> dict:
    """{kernel: {slot groups: (registers, spill store bytes, stack frame
    bytes)}} from nvcc's -Xptxas -v report (K1's two-tier kernel as
    "NG0,NG1")."""
    out, cur = {}, None
    for line in build_log.splitlines():
        m = re.search(r"entry function '\S*?(greedy_full_kernel|"
                      r"greedy_chunk_kernel|xdrop_full_kernel|"
                      r"greedy_resident_kernel)(?:ILi(\d+)E(?:Li(\d+)E)?)?",
                      line)
        if m:
            ng = m.group(2) or "5"
            cur = out.setdefault(m.group(1), {}), \
                ng + (f",{m.group(3)}" if m.group(3) else "")
            spill = frame = 0
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m:
            frame, spill = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            cur[0][cur[1]] = (int(m.group(1)), spill, frame)
            cur = None
    return out


def cuda_ms(fn, reps=1, warm=True):
    """Mean milliseconds of fn() on the card (CUDA events, after one
    warm-up call unless warm is False)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        out = fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps, out


class Kernel:
    """A kernel's phase-2 totals: times, error, and its bound."""

    def __init__(self, kid):
        self.kid = kid
        self.ms = self.plain_ms = 0.0
        self.err = 0
        self.bytes_ms = self.ops_ms = self.bound_ms = 0.0

    def add(self, ms, plain_ms, err, nbytes, slot_gens):
        """One shape: kernel and plain times, the max error and the work
        (bytes moved, live slot-generations) of that shape."""
        self.ms += ms
        self.plain_ms += plain_ms
        self.err = max(self.err, err)
        b = nbytes / HBM_BYTES_PER_S * 1e3
        o = slot_gens * OPS_PER_SLOT_GEN[self.kid] / INT32_OPS_PER_S * 1e3
        self.bytes_ms += b
        self.ops_ms += o
        self.bound_ms += max(b, o)
        if err:
            raise SystemExit(f"{self.kid} disagrees with its plain version")
        return f"bound {max(b, o):.4f} ms (bytes {b:.4f}, operations {o:.4f})"

    @property
    def bound_by(self):
        return "bytes" if self.bytes_ms >= self.ops_ms else "operations"


def k1_check(k1: Kernel, sc, what, gp, desc) -> int:
    """K1 as the batch launches it (the slot ladder, then the rescue on
    the lanes left undone) against its plain version, with the bound
    from the kernel's slot-generation counter. When the ladder leaves no
    lane undone, the rescue runs on the first 4,096 lanes, so that every
    call holds both configurations. Returns the rescue's lane count."""
    from genometools_torch.ops import greedy_batch as gb
    from genometools_torch.ops import greedy_full as gf
    cfg = gb.GreedyBatchConfig()
    lanes = desc
    for d_tiers, GENS in ((cfg.FULL_D, cfg.FULL_GENS),
                          (cfg.RESCUE[:1], cfg.RESCUE[1])):
        n = lanes[0].numel()
        if n == 0:
            lanes = tuple(a[:4096] for a in desc)
            n = lanes[0].numel()
        args = (*sc, cfg.FULL_W, d_tiers, GENS)
        cnt = {}
        ms, (kout, sg) = cuda_ms(lambda: gf.greedy_full(gp, *lanes, *args))
        pms, pout = cuda_ms(lambda: gf.greedy_full_plain(
            gp, *lanes, *args, counts=cnt), warm=False)
        err = max(int((kout.long() - pout.long()).abs().max()),
                  abs(int(sg) - cnt["slot_gens"]))
        b = k1.add(ms, pms, err, lane_bytes(gp, lanes, kout), int(sg))
        log(f"K1 {what} slot tiers {d_tiers} GENS={GENS} N={n}: kernel "
            f"{ms:.3f} ms, plain {pms:.1f} ms, {b}, max_abs_err {err}, "
            f"done {int(kout[4].sum())}, undone {int(kout[6].sum())}")
        undone = kout[6] != 0
        lanes = tuple(a[undone] for a in lanes)
    return n


def k3_check(k3: Kernel, what, gp, desc, tiers=None,
             belowscore: int = 7, quantum: int = 3, half: int = 1) -> int:
    """K3 at the batch's tiers (or `tiers`) and the score quantum and
    half against its plain version, with the bound from the kernel's
    slot-generation counter; returns how many lanes it took that the
    reference routes to the host."""
    from genometools_torch.ops import xdrop_batch as xb
    from genometools_torch.ops import xdrop_full as xf
    desc = desc[:5]
    cnt = {}
    tiers = tiers or xb.TIERS
    args = (belowscore, tiers, xb.D_BAND)
    kq = dict(quantum=quantum, half=half)
    ms, (kout, sg) = cuda_ms(lambda: xf.xdrop_full(gp, *desc, *args, **kq))
    pms, pout = cuda_ms(lambda: xf.xdrop_full_plain(
        gp, *desc, *args, counts=cnt, **kq), warm=False)
    err = max(int((kout.long() - pout.long()).abs().max()),
              abs(int(sg) - cnt["slot_gens"]))
    b = k3.add(ms, pms, err, lane_bytes(gp, desc, kout), int(sg))
    taken = kout[3] == 0
    long = int((taken & (torch.maximum(desc[1], desc[3]) > xb.REF_MAXLEN))
               .sum())
    off = int((taken & ((desc[1] - desc[3]).abs() > xb.REF_BAND)).sum())
    by_tier = torch.bincount(kout[4][taken].long(),
                             minlength=len(tiers)).tolist()
    log(f"K3 {what} tiers {tiers} D={xb.D_BAND} belowscore {belowscore} "
        f"quantum {quantum} half {half} N={desc[0].numel()}: "
        f"kernel {ms:.3f} ms, plain {pms:.1f} ms, {b}, max_abs_err {err}; "
        f"taken by tier {by_tier} (longer than {xb.REF_MAXLEN}: {long}, "
        f"|ulen - vlen| > {xb.REF_BAND}: {off}), unsafe "
        f"{int((~taken).sum())}")
    return long + off


def profile_run(fn) -> None:
    """fn() under cProfile (host: the top functions by cumulative time)
    and torch.profiler (device: busy time and the top kernels)."""
    import cProfile
    import pstats

    from torch.profiler import ProfilerActivity, profile
    pr = cProfile.Profile()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof, \
            contextlib.redirect_stdout(io.StringIO()):
        pr.enable()
        fn()
        pr.disable()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = io.StringIO()
    pstats.Stats(pr, stream=out).sort_stats("cumulative").print_stats(30)
    log(out.getvalue())
    ev = [(getattr(e, "self_device_time_total", 0) or
           getattr(e, "self_cuda_time_total", 0), e.count, e.key)
          for e in prof.key_averages()]
    busy = sum(us for us, _, _ in ev) / 1e6
    log(f"profiled run {wall:.3f}s, device busy {busy:.3f}s "
        f"({100 * busy / wall:.1f} %)")
    for us, count, key in sorted(ev, reverse=True)[:12]:
        log(f"  device {us / 1e6:.4f}s  {count} x {key[:90]}")


def write_fasta(enc, path: Path) -> None:
    """FASTA of an Encseq: descriptions from .des, wildcards as n."""
    lut = np.frombuffer(b"acgtn", np.uint8)
    with open(path, "wb") as f:
        for s in range(enc.num_sequences):
            lo, hi = int(enc.seq_startpos(s)), int(enc.seq_endpos(s))
            c = enc.codes[lo:hi + 1]
            txt = lut[np.where(c < 4, c, 4)]
            f.write(b">" + enc.descs[s].encode("latin-1") + b"\n")
            m = txt.size - txt.size % 70
            body = np.empty((m // 70, 71), np.uint8)
            body[:, :70] = txt[:m].reshape(-1, 70)
            body[:, 70] = 10
            f.write(body.tobytes())
            if txt.size > m:
                f.write(txt[m:].tobytes() + b"\n")


def synthetic_32m(path: Path) -> None:
    """The bench's 32 Mbp random-DNA FASTA (4 sequences, numpy seed 42;
    bench.py _ensure_big)."""
    rng = np.random.default_rng(42)
    n = 32 * 1024 * 1024
    b = np.frombuffer(b"acgt", np.uint8)[rng.integers(0, 4, n,
                                                      dtype=np.uint8)]
    per = n // 4
    with open(path, "wb") as f:
        for s in range(4):
            f.write(b">synthetic_%d\n" % s)
            chunk = b[s * per:(s + 1) * per]
            m = per - per % 70
            out = np.empty((m // 70, 71), np.uint8)
            out[:, :70] = chunk[:m].reshape(-1, 70)
            out[:, 70] = 10
            f.write(out.tobytes())
            if chunk[m:].size:
                f.write(chunk[m:].tobytes() + b"\n")


def random_flanks(rng, n, maxlen, err_lo=0.02, err_hi=0.4):
    """Flank pairs: v is u with 2-40 % substitutions, occasional indels
    and wildcards."""
    us, vs = [], []
    for _ in range(n):
        L = int(rng.integers(1, maxlen))
        u = rng.integers(0, 4, L).astype(np.uint8)
        v = u.copy()
        err = rng.uniform(err_lo, err_hi)
        for p in rng.integers(0, L, int(err * L)):
            v[p] = rng.integers(0, 4)
        if rng.random() < 0.3 and v.size > 3:
            v = np.delete(v, rng.integers(0, v.size, 2))
        if rng.random() < 0.3:
            v = np.insert(v, int(rng.integers(0, v.size + 1)),
                          rng.integers(0, 4, 3).astype(np.uint8))
        if rng.random() < 0.3:
            u[rng.integers(0, u.size)] = 254
        us.append(u)
        vs.append(v[:maxlen])
    return us, vs


def long_flanks(rng, n, lo, hi):
    """Homologous flank pairs of lo..hi symbols: v is u with 1-15 %
    substitutions and 0.5 % indels; some u carry wildcards."""
    from genometools_torch.utils.synthetic import mutate
    us, vs = [], []
    for t in range(n):
        u = rng.integers(0, 4, int(rng.integers(lo, hi))).astype(np.uint8)
        v = mutate(rng, u, rng.uniform(0.01, 0.15))
        if t % 4 == 0:
            u[rng.integers(0, u.size, 3)] = 254
        us.append(u)
        vs.append(v)
    return us, vs


def flank_pool(us, vs):
    pool = np.concatenate(list(us) + list(vs))
    lu = np.asarray([len(u) for u in us], np.int64)
    lv = np.asarray([len(v) for v in vs], np.int64)
    return pool, np.cumsum(lu) - lu, lu, lu.sum() + np.cumsum(lv) - lv, lv


def k2r_check(kout: dict, pout: dict) -> int:
    """The resident kernel's largest difference from its plain version
    over every output; outputs of other keys or shapes fail."""
    if set(kout) != set(pout) or any(kout[k].shape != pout[k].shape
                                     for k in pout):
        raise SystemExit("K2r's outputs differ in keys or shapes")
    return max(int((kout[k].long() - pout[k].long()).abs().max())
               for k in pout)


def pool_lanes(us, vs, seedl, dev):
    """The uploaded pool and the lane tensors (ustart, ulen, vstart,
    vlen, rev, seedlen) of flank pairs read forward."""
    from genometools_torch.ops.pool import upload_pool
    pool, uo, ul, vo, vl = flank_pool(us, vs)
    n = len(us)
    return upload_pool(pool, dev), tuple(
        torch.from_numpy(np.asarray(a)).to(dev) for a in (
            uo, ul, vo, vl, np.zeros(n, bool),
            np.zeros(n, np.int64) + seedl))


def workload_lanes(wl, idx, dev):
    """The lane tensors of the tasks idx of an extension workload
    (collect_extension_pool's result; left flanks read from the reversed
    planes)."""
    pool, uo, ul, vo, vl, rev, k = wl
    T = pool.size
    uo, ul, vo, vl, rev = (a[idx] for a in (uo, ul, vo, vl, rev))
    return tuple(torch.from_numpy(np.asarray(a)).to(dev) for a in (
        np.where(rev, T - uo - ul, uo), ul, np.where(rev, T - vo - vl, vo),
        vl, rev, np.full(idx.size, k, np.int64)))


def lane_bytes(gp, desc, out) -> int:
    """The bytes a persistent launch must move: the pool planes, the lane
    descriptors and the outputs, each once."""
    outs = out.values() if isinstance(out, dict) else [out]
    return sum(a.numel() * a.element_size() for a in (gp, *desc, *outs))


def xdrop_lanes(xb) -> str:
    st = xb.stats
    tiers = dict(zip((W for W, _ in xb.TIERS + xb.WIDE_TIERS),
                     st["tier_lanes"]))
    return (f"K3 {st['kernel_lanes']}, by window tier {tiers} "
            f"(longer than {xb.REF_MAXLEN}: {st['long_lanes']}, |ulen - vlen|"
            f" > {xb.REF_BAND}: {st['offband_lanes']}; run again at the wide "
            f"tiers: {st['wide_lanes']}), host {st['host_lanes']} "
            f"({st['host_symbols']} flank symbols copied for them); lanes "
            f"the reference's filters route to the host: "
            f"{st['filtered_lanes']}")


def host_share(xb) -> float:
    """The share of the xdrop lanes that went to the host engine."""
    st = xb.stats
    n = st["kernel_lanes"] + st["host_lanes"]
    return st["host_lanes"] / n if n else 0.0


def wide_lanes(enc, esa, minlen: int, belowscore: int, dev, n: int = 128):
    """The pool and the descriptors of up to n right flanks of g4m's
    maximal pairs that K3 leaves unsafe at the last of TIERS: the lanes
    the batch runs again at WIDE_TIERS."""
    from genometools_torch.match import repfind as rf
    from genometools_torch.ops import xdrop_batch as xb
    from genometools_torch.ops import xdrop_full as xf
    from genometools_torch.ops.pool import upload_pool
    mp = rf.enumerate_maxpairs(esa, minlen)
    a = np.minimum(mp.pos1, mp.pos2).astype(np.int64)
    b = np.maximum(mp.pos1, mp.pos2).astype(np.int64)
    ln = mp.length.astype(np.int64)
    s1, s2 = enc.seqnum_of_pos(a), enc.seqnum_of_pos(b)
    end1 = enc.seq_startpos(s1) + enc.seq_length(s1)
    end2 = enc.seq_startpos(s2) + enc.seq_length(s2)
    same = s1 == s2
    keep = ~same | (a + ln <= b)
    a, b, ln, same, end1, end2 = (x[keep] for x in
                                  (a, b, ln, same, end1, end2))
    uo, vo = a + ln, b + ln
    ul = np.where(same, b - uo, end1 - uo)
    vl = end2 - vo
    gp = upload_pool(enc.codes, dev)
    desc = [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in
            (uo, ul, vo, vl, np.zeros(uo.size, bool))]
    out, _ = xf.xdrop_full(gp, *desc, belowscore, xb.TIERS, xb.D_BAND)
    sel = torch.nonzero((out[3] != 0) & (out[4] == len(xb.TIERS) - 1)) \
        .view(-1)[:n]
    return gp, [x[sel] for x in desc]


def k2r_summary(kout: dict, cnt: dict) -> str:
    done, fb = np.bincount(kout["route"].cpu().numpy(), minlength=2)
    return (f"lanes done {done}, fallback {fb}; chunks "
            f"{int(kout['chunks'].long().sum())}, lane-chunks by (W, D) "
            f"{dict(sorted(cnt['chunks'].items()))}")


GOLDEN = ROOT / "tests" / "golden_esa"
E2E_EXTS = ("esq", "ssp", "des", "sds", "md5", "suf", "lcp", "llv", "prj")
WIDE_N = 2 ** 30 + 2 ** 20
WIDE_PEAK_BYTES = 64e9


def golden_bytes(db: str, ext: str) -> bytes:
    gold = GOLDEN / db / f"idx.{ext}"
    return gold.read_bytes() if gold.exists() else \
        gzip.open(f"{gold}.gz").read()


def same_files(a: str, b: str, exts) -> None:
    """Fail unless the files a.ext and b.ext are equal (or both absent)."""
    for ext in exts:
        pa, pb = Path(f"{a}.{ext}"), Path(f"{b}.{ext}")
        if pa.exists() != pb.exists() or \
                (pb.exists() and pa.read_bytes() != pb.read_bytes()):
            raise SystemExit(f"{pa} differs from {pb}")


def log_stages(what: str, trace: dict, smi: str) -> None:
    from genometools_torch.index.suffix import stage_ms
    tied = trace["tied"]
    log(f"{what} pipeline stages, ms (CUDA events): "
        + ", ".join(f"{s} {ms:.3f}" for s, ms in stage_ms(trace))
        + f"; refinement rounds {len(tied) - 1}, tied after the bootstrap "
        f"and after each round {tied}; deep pairs {trace['deep']} [{smi}]")


def phase_32m(work: Path, dev, smi: str) -> float:
    """Phase 4; returns the host SA-IS + Kasai seconds."""
    from genometools_torch.index import suffix
    from genometools_torch.index.esa import Encseq, build_esa, host_sa_lcp
    synthetic_32m(work / "big.fna")
    big = Encseq.from_files([str(work / "big.fna")])
    keys = big.suffix_keys()
    kd = torch.from_numpy(keys).to(dev)
    suffix.build_suffix_array(kd, device=dev)            # warm-up
    torch.cuda.synchronize()
    trace = {}
    t0 = time.perf_counter()
    sa, lcp = suffix.build_suffix_array(kd, device=dev, trace=trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if trace["engine"] != "packed":
        raise SystemExit("32 Mbp keys did not take the packed pipeline")
    log_stages("32 Mbp", trace, smi)
    t0 = time.perf_counter()
    sa, lcp = sa.cpu().numpy(), lcp.cpu().numpy()
    log(f"device-to-host copies of sa and lcp (int32): "
        f"{(time.perf_counter() - t0) * 1e3:.3f} ms; the traced run "
        f"{wall:.3f}s on the host clock")
    ms_p, _ = cuda_ms(lambda: suffix.build_suffix_array(kd, device=dev),
                      reps=3)
    ms_d, (dsa, dlcp) = cuda_ms(lambda: suffix.doubling_sa_lcp(kd))
    levels = len(suffix.build_sa_impl(kd.long(), True)[1])
    log(f"32 Mbp whole engine, warm (CUDA events): packed pipeline "
        f"{ms_p:.3f} ms (mean of 3), prefix doubling {ms_d:.3f} ms ("
        f"{levels} rank levels: prefixes of 4 to {4 << (levels - 1)} "
        f"symbols); "
        f"{keys.size / ms_p * 1e3:.0f} and {keys.size / ms_d * 1e3:.0f} "
        f"suffixes/s [{smi}]")
    t0 = time.perf_counter()
    esa = build_esa(big, device=dev)
    dt = time.perf_counter() - t0
    log(f"build_esa 32Mbp (keys, upload, pipeline, copies): {dt:.3f}s, "
        f"{keys.size / dt:.0f} suffixes/s [{smi}]")
    t0 = time.perf_counter()
    sa_ref, lcp_ref = host_sa_lcp(keys)
    host = time.perf_counter() - t0
    log(f"host SA-IS + Kasai: {host:.3f}s")
    for what, (s, l) in (("packed", (sa, lcp)),
                         ("doubling", (dsa.cpu().numpy(),
                                       dlcp.cpu().numpy())),
                         ("build_esa", (esa.suftab, esa.lcptab))):
        if not np.array_equal(s, sa_ref):
            raise SystemExit(f"32 Mbp SA ({what}) differs from host SA-IS")
        if not np.array_equal(l, lcp_ref):
            raise SystemExit(f"32 Mbp LCP ({what}) differs from host Kasai")
    log(f"SA and LCP of the packed pipeline, of prefix doubling and of "
        f"build_esa equal host SA-IS/Kasai ({keys.size} suffixes)")
    return host


def phase_e2e(work: Path, dev, smi: str, host_32m: float) -> None:
    """Phase 8: suffixerator_e2e against the slow path and the goldens."""
    from genometools_torch.index.esa import (Encseq, build_esa, host_sa_lcp,
                                             write_esa)
    from genometools_torch.index.fastpipe import suffixerator_e2e
    for name, fasta in (("at1MB", work / "at1MB.fna"),
                        ("32Mbp", work / "big.fna")):
        enc = Encseq.from_files([str(fasta)])
        if name == "at1MB":
            t0 = time.perf_counter()
            host_sa_lcp(enc.suffix_keys())
            host = time.perf_counter() - t0
        else:
            host = host_32m
        fast = str(work / f"e2e_{name}")
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            suffixerator_e2e([str(fasta)], fast, device=dev)
            walls.append(time.perf_counter() - t0)
        slow = str(work / f"slow_{name}")
        t0 = time.perf_counter()
        enc.save(slow)
        write_esa(build_esa(enc, device=dev), slow)
        slow_s = time.perf_counter() - t0
        same_files(fast, slow, E2E_EXTS)
        if name == "at1MB":
            for ext in ("suf", "lcp", "llv", "prj"):
                if Path(f"{fast}.{ext}").read_bytes() != \
                        golden_bytes("at1MB", ext):
                    raise SystemExit(f"e2e at1MB .{ext} differs from the "
                                     "golden")
        log(f"suffixerator_e2e {name} ({enc.total_length + 1} suffixes): "
            f"{walls[0]:.3f}s, then {walls[1]:.3f}s [{smi}]; host SA-IS + "
            f"Kasai alone {host:.3f}s; slow path (save, build_esa, "
            f"write_esa) {slow_s:.3f}s; every file equals the slow path's"
            + (" and the index files the goldens" if name == "at1MB" else ""))


def phase_parts(work: Path, env: dict) -> None:
    """Phase 9: -parts 3 and -memlimit 4MB on at1MB, two processes at
    once; both must exit 0 and write the goldens' bytes."""
    runs = {"parts3": ["-parts", "3"], "memlimit": ["-memlimit", "4MB"]}
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "genometools_torch", "suffixerator", "-db",
         "at1MB.fna", "-indexname", name, "-suf", "-lcp", "-tis", *extra],
        cwd=work, env=env) for name, extra in runs.items()}
    codes = {name: p.wait() for name, p in procs.items()}
    log(f"suffixerator {runs}: exit codes {codes}, "
        f"{time.perf_counter() - t0:.3f}s for both")
    if any(codes.values()):
        raise SystemExit("a -parts/-memlimit run failed")
    for name in runs:
        for ext in ("suf", "lcp", "llv", "prj"):
            if (work / f"{name}.{ext}").read_bytes() != \
                    golden_bytes("at1MB", ext):
                raise SystemExit(f"{name} .{ext} differs from the golden")
    log("-parts 3 and -memlimit 4MB: .suf/.lcp/.llv/.prj equal the goldens")


def wide_keys(n: int, dev) -> torch.Tensor:
    """int32 canonical keys of n random ACGT symbols (torch.Generator seed
    2026 on the card), about 0.1 % of them specials (4 + position), the
    sentinel last."""
    g = torch.Generator(device=dev)
    g.manual_seed(2026)
    keys = torch.randint(0, 4, (n + 1,), generator=g, dtype=torch.int32,
                         device=dev)
    sp = torch.randint(0, n, (n // 1000,), generator=g, device=dev)
    keys[sp] = (4 + sp).to(torch.int32)
    keys[n] = 4 + n
    return keys


def phase_wide(dev, smi: str) -> None:
    """Phase 10: the pipeline at WIDE_N symbols, held by the certificate."""
    from genometools_torch.index import suffix
    torch.cuda.empty_cache()
    keys = wide_keys(WIDE_N, dev)
    nspec = int((keys >= 4).sum())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trace = {}
    t0 = time.perf_counter()
    sa, lcp = suffix.build_suffix_array(keys, device=dev, trace=trace)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    log_stages("wide", trace, smi)
    log(f"wide: {WIDE_N + 1} suffixes ({nspec} special keys, sentinel "
        f"included) in {dt:.3f}s = {(WIDE_N + 1) / dt:.0f} suffixes/s; "
        f"peak device memory {peak} bytes ({peak / 1e9:.3f} GB, the keys' "
        f"{keys.numel() * 4 / 1e9:.3f} GB included); max lcp "
        f"{int(lcp.max())} [{smi}]")
    if trace["engine"] != "packed":
        raise SystemExit("the wide keys did not take the packed pipeline")
    t0 = time.perf_counter()
    ok = suffix.check_sa_lcp(keys, sa, lcp)
    log(f"certificate (check_sa_lcp): {'passed' if ok else 'FAILED'} in "
        f"{time.perf_counter() - t0:.3f}s")
    if not ok:
        raise SystemExit("the wide SA/LCP failed the certificate")
    if peak >= WIDE_PEAK_BYTES:
        raise SystemExit(f"peak device memory {peak} is over 64 GB")
    del keys, sa, lcp
    torch.cuda.empty_cache()


def route_counts() -> str:
    """Launches of K1, K2r and K3 and the lanes by route since the last
    reset_counts()."""
    from genometools_torch.ops import greedy_batch as gb
    from genometools_torch.ops import greedy_full as gf
    from genometools_torch.ops import greedy_resident as gr
    from genometools_torch.ops import xdrop_batch as xb
    from genometools_torch.ops import xdrop_full as xf
    st = gb.stats
    return (f"launches K1 {gf.launches}, K2r {gr.launches}, K3 "
            f"{xf.launches}; greedy lanes K1 {st['kernel_lanes']}, K2r "
            f"{st['resident_lanes']}, K2 {st['chunk_lanes']}, host "
            f"{st['host_lanes']}; xdrop lanes {xdrop_lanes(xb)}")


def reset_counts() -> None:
    from genometools_torch.ops import greedy_batch as gb
    from genometools_torch.ops import greedy_chunk as gc
    from genometools_torch.ops import greedy_full as gf
    from genometools_torch.ops import greedy_resident as gr
    from genometools_torch.ops import xdrop_batch as xb
    from genometools_torch.ops import xdrop_full as xf
    for mod in (gf, gc, gr, xf):
        mod.launches = 0
    gb.reset_stats()
    xb.reset_stats()


def run_cli(cli, argv) -> tuple[list[str], float]:
    """The port's CLI in this process: (its stdout lines, seconds)."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return buf.getvalue().splitlines(), time.perf_counter() - t0


def phase_grid(cli, dev, se_lines: dict, smi: str) -> dict:
    """Phase 11: the -parts 3 grid on the phase-3 index (cwd); returns
    the CLI's lines by extension."""
    from genometools_torch.index.esa import Encseq
    from genometools_torch.match.seed_extend import (SeedExtendParams,
                                                     seed_extend,
                                                     sequence_ranges)
    at1 = Encseq.load("idx")
    ranges = sequence_ranges(at1, 3)
    log(f"at1MB in 3 parts: sequence ranges {ranges}")
    grid = {}
    for flag, ext in (("-extendgreedy", "greedy"), ("-extendxdrop", "xdrop")):
        reset_counts()
        lines, dt = run_cli(cli, ["seed_extend", "-ii", "idx", "-l", "14",
                                  "-minidentity", "90", flag, "-parts", "3"])
        log(f"seed_extend {flag} -parts 3: {len(lines)} matches in "
            f"{dt:.3f}s [{smi}]; {route_counts()}")
        if sorted(lines) != sorted(se_lines[ext]) or not lines:
            raise SystemExit(f"-parts 3 {flag} differs from phase 6's lines")
        grid[ext] = lines
        p = SeedExtendParams(minidentity=90, userdefinedleastlength=14,
                             extension=ext, parts=3)
        t0 = time.perf_counter()
        fused = [m.line() for m in seed_extend(at1, None, p, engine="fused")]
        log(f"fused grid: {len(fused)} matches in "
            f"{time.perf_counter() - t0:.3f}s")
        if fused != lines:
            raise SystemExit(f"the fused -parts 3 grid differs from the "
                             f"wave grid ({ext})")
        if ext == "greedy":
            cells = []
            for a in range(1, len(ranges) + 1):
                for b in range(a, len(ranges) + 1):
                    p = SeedExtendParams(minidentity=90,
                                         userdefinedleastlength=14,
                                         extension=ext, parts=3,
                                         pick=(a, b))
                    cells += [m.line() for m in seed_extend(
                        at1, None, p, device=dev)]
            log(f"-pick cells: {len(cells)} matches in all")
            if cells != lines:
                raise SystemExit("the -pick cells in grid order differ from "
                                 "the -parts 3 lines")
    log("grid: -parts 3 sorted equals phase 6, the fused grid equals the "
        "wave grid, the -pick cells equal -parts 3")
    return grid


def host_esa_build():
    """build_esa's stand-in for the oracle: the ESA of a text by the host
    SA-IS and Kasai engines."""
    from genometools_torch.index.esa import EnhancedSuffixArray, host_sa_lcp

    def build(enc, readmode=0, **_):
        sa, lcp = host_sa_lcp(enc.suffix_keys(readmode))
        return EnhancedSuffixArray(enc, readmode, sa, lcp)
    return build


def phase_repfind(cli, dev, g4m, smi: str, k3: Kernel) -> None:
    """Phase 12: repfind's pairs and extensions on at1MB and g4m, then K3
    at the wide tiers against its plain version on g4m's lanes past
    2,048."""
    from genometools_torch.index.esa import Encseq, load_esa
    from genometools_torch.match import repfind as rf
    from genometools_torch.ops import greedy_resident as gr
    from genometools_torch.ops import xdrop_batch as xb
    at1 = Encseq.load("idx")
    lines, dt = run_cli(cli, ["repfind", "-l", "14", "-ii", "idx", "-f",
                              "-r", "-p"])
    log(f"repfind -l 14 -f -r -p: {len(lines)} rows in {dt:.3f}s [{smi}]")
    build, rf.build_esa = rf.build_esa, host_esa_build()
    try:
        t0 = time.perf_counter()
        hesa = rf.build_esa(at1)
        want = rf.format_match_lines(rf.repfind_self(at1, 14, esa=hesa), "F")
        want += rf.format_match_lines(
            rf.repfind_reverse(at1, 14, esa=hesa), "R")
        want += rf.format_match_lines(
            rf.repfind_palindromic(at1, 14, esa=hesa), "P")
        log(f"oracle (host SA-IS + Kasai ESAs): {len(want)} rows in "
            f"{time.perf_counter() - t0:.3f}s")
    finally:
        rf.build_esa = build
    if lines != want or not lines:
        raise SystemExit("repfind -f -r -p differs from the host-ESA oracle")
    counts = {d: sum(1 for x in lines if x.split()[3] == d) for d in "FRP"}
    log(f"rows by direction {counts} equal the oracle's")

    for what, enc, esa, minlen in (
            ("at1MB", at1, load_esa("idx", encseq=at1), 14),
            ("g4m", g4m, load_esa("g4m", encseq=g4m), 30)):
        npairs = rf.enumerate_maxpairs(esa, minlen).count
        for ext in ("greedy", "xdrop"):
            reset_counts()
            if what == "at1MB":
                flag = "-extendgreedy" if ext == "greedy" else "-extendxdrop"
                got, dt = run_cli(cli, ["repfind", "-l", str(minlen), "-ii",
                                        "idx", flag])
            else:
                t0 = time.perf_counter()
                got = [m.line() for m in rf.repfind_extend(
                    enc, minlen, ext, minidentity=80, esa=esa, device=dev)]
                dt = time.perf_counter() - t0
            counts, k2r = route_counts(), gr.launches
            share = host_share(xb)
            t0 = time.perf_counter()
            want = [m.line() for m in rf.repfind_extend(
                enc, minlen, ext, minidentity=80, esa=esa, device=dev,
                engine="host")]
            dth = time.perf_counter() - t0
            log(f"repfind {what} -l {minlen} -extend{ext}: {npairs} "
                f"maximal pairs, {len(got)} matches; batch route {dt:.3f}s"
                f"{' (a CLI run)' if what == 'at1MB' else ''}, host route "
                f"{dth:.3f}s [{smi}]; xdrop lanes on the host engine "
                f"{100 * share:.3f} %; {counts}")
            if got != want or not got:
                raise SystemExit(f"repfind {what} -extend{ext}: the batch "
                                 "route differs from the host route")
            if what == "g4m" and ext == "greedy" and k2r == 0:
                raise SystemExit("g4m's greedy repfind launched K2r no time")
            if what == "g4m" and ext == "xdrop" and (
                    share > 0.01 or xb.stats["wide_lanes"] == 0):
                raise SystemExit("g4m's xdrop repfind: the wide tiers took "
                                 "no lane, or over 1 % went to the host")
    from genometools_torch.ops.xdrop import optimal_xdrop_belowscore
    esa = load_esa("g4m", encseq=g4m)
    bs = optimal_xdrop_belowscore(20, 97)
    gp, desc = wide_lanes(g4m, esa, 30, bs, dev)
    if desc[0].numel() == 0:
        raise SystemExit("g4m has no xdrop lane past 2,048")
    k3_check(k3, "g4m lanes past 2,048", gp, desc, xb.WIDE_TIERS, bs)


def reads_fasta(rows: np.ndarray, path: Path, lut=b"acgtn") -> None:
    """FASTA of equal-length code rows (0-3, 4 for n), one line each."""
    rows = np.frombuffer(lut, np.uint8)[rows]
    n, L = rows.shape
    ids = [b">r%d\n" % i for i in range(n)]
    body = np.empty((n, L + 1), np.uint8)
    body[:, :L] = rows
    body[:, L] = 10
    with open(path, "wb") as f:
        f.write(b"".join(h + r.tobytes() for h, r in zip(ids, body)))


def sample_windows(codes: np.ndarray, starts, lens, n: int, L: int, rng):
    """n windows of L symbols drawn uniformly from the positions whose
    window lies inside one sequence (codes 0-3, 4 for a wildcard)."""
    ok = lens >= L
    cnt = (lens - L + 1)[ok]
    first = np.repeat(starts[ok], cnt) + (np.arange(cnt.sum()) - np.repeat(
        np.cumsum(cnt) - cnt, cnt))
    pos = first[rng.integers(0, first.size, n)]
    w = codes[pos[:, None] + np.arange(L)]
    return np.where(w < 4, w, 4).astype(np.uint8)


def tyr_files(name: str) -> list[bytes]:
    return [Path(f"{name}.{ext}").read_bytes()
            for ext in ("mer", "mct", "tyr.json")]


def phase_tallymer(cli, work: Path, dev, smi: str) -> None:
    """Phase 13: tallymer (BASELINE config 2) over phase 3's index of
    at1MB (`suffixerator -suf -lcp -tis` on the card; cwd), then at
    32 Mbp over an ESA that build_esa sorts on the card."""
    from genometools_torch.index.esa import Encseq, build_esa, load_esa
    from genometools_torch.match import tallymer as tm
    from genometools_torch.ops.kmer import kmer_codes, kmer_codes64
    at1 = Encseq.load("idx")
    _, dt = run_cli(cli, ["tallymer", "mkindex", "-esa", "idx", "-mersize",
                          "19", "-minocc", "1", "-indexname", "tyr"])
    hist, dth = run_cli(cli, ["tallymer", "mkindex", "-esa", "idx",
                              "-mersize", "19"])
    t0 = time.perf_counter()
    esa = load_esa("idx", need_lcp="small", signed_suftab=False)
    mi = tm.mkindex(esa, 19)
    mi.save("tyr_esa")
    dte = time.perf_counter() - t0
    t0 = time.perf_counter()
    bf = tm.mkindex_bruteforce(at1, 19)
    dtb = time.perf_counter() - t0
    loaded = tm.MerIndex.load("tyr")
    if tyr_files("tyr") != tyr_files("tyr_esa"):
        raise SystemExit("tallymer at1MB: the ESA route's .mer/.mct/.tyr.json "
                         "differ from the direct route's")
    if not (np.array_equal(loaded.mer_codes, bf.mer_codes)
            and np.array_equal(loaded.counts, bf.counts)):
        raise SystemExit("tallymer at1MB: mers or counts differ from the "
                         "brute force")
    dist = {int(a): int(b) for a, b in (x.split() for x in hist)}
    log(f"tallymer mkindex at1MB k=19: {loaded.num_mers} distinct mers, "
        f"{dist.get(1, 0)} once, {len(dist)} distinct counts; CLI "
        f"-indexname {dt:.3f}s, histogram {dth:.3f}s (ESA-free counter), "
        f"ESA route (load_esa small + mkindex + save) {dte:.3f}s, brute "
        f"force {dtb:.3f}s [{smi}]; index files equal, mers and counts "
        f"equal the brute force")
    # queries: Atinsert, then 10,000 reads of 100 bp from at1MB (seed 7)
    rng = np.random.default_rng(7)
    n = at1.num_sequences
    starts = np.asarray(at1.seq_startpos(np.arange(n)), np.int64)
    lens = np.asarray(at1.seq_length(np.arange(n)), np.int64)
    write_fasta(Encseq.load(str(GOLDEN / "Atinsert.fna" / "idx")),
                work / "q_at.fna")
    reads_fasta(sample_windows(at1.codes, starts, lens, 10000, 100, rng),
                work / "q_reads.fna")
    (work / "queries.fna").write_bytes((work / "q_at.fna").read_bytes()
                                       + (work / "q_reads.fna").read_bytes())
    lines, dts = run_cli(cli, ["tallymer", "search", "-tyr", "tyr", "-q",
                               "queries.fna", "-strand", "fp", "-output",
                               "qseqnum", "qpos", "counts", "sequence"])
    t0 = time.perf_counter()
    res = tm.search(tm.MerIndex.load("tyr"),
                    Encseq.from_files(["queries.fna"]))
    dtl = time.perf_counter() - t0
    acgt = np.frombuffer(b"acgt", np.uint8)
    shifts = np.arange(36, -1, -2, dtype=np.int64)
    seqs = acgt[(res.codes[:, None] >> shifts) & 3]
    want = [f"{a}\t{chr(b)}{c}\t{d}\t{e.tobytes().decode()}" for a, b, c, d, e
            in zip(res.qseqnum.tolist(), res.strand.tolist(),
                   res.qpos.tolist(), res.counts.tolist(), seqs)]
    if lines != want or not lines:
        raise SystemExit("tallymer search: the CLI's lines differ from the "
                         "library's")
    nrev = int((res.strand == ord("-")).sum())
    log(f"tallymer search -strand fp (Atinsert + 10,000 reads of 100 bp): "
        f"{len(lines)} lines ({nrev} on the reverse strand) in {dts:.3f}s "
        f"(CLI in process), library search {dtl:.3f}s [{smi}]; lines equal")
    big = Encseq.from_files([str(work / "big.fna")])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    besa = build_esa(big, device=dev)
    dtb = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesa = tm.mkindex(besa, 19)
    dtm = time.perf_counter() - t0
    t0 = time.perf_counter()
    mdir = tm.mkindex_direct(big, 19)
    dtd = time.perf_counter() - t0
    t0 = time.perf_counter()
    bf = tm.mkindex_bruteforce(big, 19)
    dtf = time.perf_counter() - t0
    if not (np.array_equal(mesa._packed, mdir._packed)
            and np.array_equal(mesa.counts, mdir.counts)
            and np.array_equal(mesa.mer_codes, bf.mer_codes)
            and np.array_equal(mesa.counts, bf.counts)):
        raise SystemExit("tallymer 32 Mbp: the ESA route, the direct route "
                         "and the brute force disagree")
    # the device window scan (ops/kmer.py) against the host codes
    bc = torch.from_numpy(big.codes).to(dev)
    ms, (code, valid) = cuda_ms(lambda: kmer_codes64(bc, 19, device=dev))
    uq, cnt = torch.unique(code[valid], return_counts=True)
    words, wvalid = kmer_codes(bc, 19, device=dev)
    if not (np.array_equal(uq.cpu().numpy(), bf.mer_codes)
            and np.array_equal(cnt.cpu().numpy(), bf.counts)
            and torch.equal(wvalid, valid)
            and torch.equal(words[0].long() * 4 ** 15 + words[1], code)):
        raise SystemExit("kmer_codes on the card differs from the brute "
                         "force")
    log(f"tallymer 32 Mbp k=19: {mesa.num_mers} distinct mers; build_esa "
        f"{dtb:.3f}s, mkindex over it {dtm:.3f}s, mkindex_direct {dtd:.3f}s,"
        f" brute force {dtf:.3f}s; kmer_codes64 on the card {ms:.3f} ms "
        f"({code.numel()} windows; CUDA events) [{smi}]; the routes, the "
        f"brute force and torch.unique over the card's codes agree")


def n50(lengths: np.ndarray) -> int:
    s = np.sort(lengths)[::-1]
    return int(s[np.searchsorted(np.cumsum(s), s.sum() / 2)]) if s.size else 0


def verbatim(contigs: list[bytes], genome: list[bytes]) -> int:
    """How many contigs (or their reverse complements) occur verbatim in
    a genome sequence: candidates from the genome's sorted 31-mer codes,
    then a byte comparison."""
    from genometools_torch.ops.kmer import kmer_codes_np
    lut = np.full(256, 254, np.uint8)
    lut[np.frombuffer(b"acgt", np.uint8)] = np.arange(4)
    comp = bytes.maketrans(b"acgt", b"tgca")
    idx = []
    for s, g in enumerate(genome):
        code, ok = kmer_codes_np(lut[np.frombuffer(g, np.uint8)], 31)
        pos = np.flatnonzero(ok)
        idx.append((code[pos], pos, s))
    keys = np.concatenate([c for c, _, _ in idx])
    pos = np.concatenate([p for _, p, _ in idx])
    seq = np.concatenate([np.full(p.size, s) for _, p, s in idx])
    o = np.argsort(keys, kind="stable")
    keys, pos, seq = keys[o], pos[o], seq[o]
    found = 0
    for c in contigs:
        for v in (c, c.translate(comp)[::-1]):
            k = int(kmer_codes_np(lut[np.frombuffer(v[:31], np.uint8)],
                                  31)[0][0])
            a, b = np.searchsorted(keys, [k, k + 1])
            if any(genome[seq[i]][pos[i]:pos[i] + len(v)] == v
                   for i in range(a, b)):
                found += 1
                break
    return found


def g4m_reads(coverage: int):
    """(reads as code rows, each read's sequence and start position, the
    genome's sequences, the generator after them): error-free 100 bp
    reads at `coverage` from g4m_planted_repeats, start positions uniform
    in each sequence (numpy seed 1), half reverse-complemented, reads
    with n dropped."""
    from genometools_torch.utils.synthetic import planted_repeats
    genome = planted_repeats()
    rng = np.random.default_rng(1)
    lut = np.full(256, 4, np.uint8)
    lut[np.frombuffer(b"acgt", np.uint8)] = np.arange(4)
    rows, seqno, start = [], [], []
    for i, g in enumerate(genome):
        c = lut[np.frombuffer(g, np.uint8)]
        nr = coverage * c.size // 100
        st = rng.integers(0, c.size - 100 + 1, nr)
        w = c[st[:, None] + np.arange(100)]
        flip = rng.random(nr) < 0.5
        w[flip] = np.where(w[flip] < 4, 3 - w[flip], 4)[:, ::-1]
        ok = (w < 4).all(axis=1)
        rows.append(w[ok])
        seqno.append(np.full(int(ok.sum()), i))
        start.append(st[ok])
    return (np.concatenate(rows), np.concatenate(seqno),
            np.concatenate(start), genome, rng)


def spm_witness(rj, krows: np.ndarray, sel: np.ndarray) -> int:
    """The native SPM join against the numpy join (the native binding
    disabled) on the kept reads `sel`, at phase 14's -l 45: every SPM row
    must agree. Returns the number of SPMs."""
    from genometools_torch.core import native
    sub = rj.ReadSet(blob=krows[sel].ravel(), lens=np.full(sel.size, 100))
    got = rj.find_spms(sub, 45)
    join = native.spm_find_native
    native.spm_find_native = lambda *a, **k: None
    try:
        want = rj.find_spms(sub, 45)
    finally:
        native.spm_find_native = join
    for f in ("suf_read", "suf_strand", "pref_read", "pref_strand",
              "length"):
        if not np.array_equal(getattr(got, f), getattr(want, f)):
            raise SystemExit(f"readjoiner: the native join's {f} differs "
                             "from the numpy join's")
    if not got.length.size:
        raise SystemExit("readjoiner: no SPM in the witness window")
    return int(got.length.size)


def phase_readjoiner(cli, work: Path, dev, smi: str) -> None:
    """Phase 14: readjoiner (BASELINE config 5) on error-free 100 bp
    reads at 20x from g4m_planted_repeats (start positions uniform in
    each sequence, numpy seed 1; half reverse-complemented; reads with
    n dropped), then encseq2spm on the kept reads."""
    from genometools_torch.assembly import readjoiner as rj
    t0 = time.perf_counter()
    rows, seqno, start, genome, rng = g4m_reads(20)
    reads_fasta(rows, work / "reads.fna")
    log(f"reads: {rows.shape[0]} of 100 bp at 20x over 2 x 2,000,000 bp, "
        f"{time.perf_counter() - t0:.1f}s to make; host cores "
        f"{os.cpu_count()} (the native SPM join's threads), "
        f"{len(os.sched_getaffinity(0))} usable")
    times = {}
    for sub, extra in (("prefilter", ["-db", "reads.fna"]),
                       ("overlap", ["-l", "45"]),
                       ("assembly", ["-l", "45"]), ("cgraph", [])):
        _, times[sub] = run_cli(cli, ["readjoiner", sub, "-readset", "rs"]
                                + extra)
        log(f"readjoiner {sub}: {times[sub]:.3f}s [{smi}]")
    kept = np.load("rs.reads.npz")
    klens = kept["lens"]
    krows = kept["blob"].reshape(-1, 100)
    spms = rj.SpmList.read("rs.spm")
    contained = rj.find_contained(rj.ReadSet(blob=rows.ravel(), lens=np.full(
        rows.shape[0], 100)), device=dev)
    if not (klens == 100).all() or not np.array_equal(krows,
                                                      rows[~contained]):
        raise SystemExit("readjoiner: the kept reads differ from "
                         "find_contained's")
    # 10,000 sampled SPMs: suffix of the first read == prefix of the second
    pick = rng.choice(spms.length.size, min(10000, spms.length.size),
                      replace=False)
    for i in pick:
        a = krows[spms.suf_read[i]]
        b = krows[spms.pref_read[i]]
        a = a if spms.suf_strand[i] else 3 - a[::-1]
        b = b if spms.pref_strand[i] else 3 - b[::-1]
        L = int(spms.length[i])
        if L < 45 or not np.array_equal(a[100 - L:], b[:L]):
            raise SystemExit(f"readjoiner: SPM {i} is no suffix-prefix "
                             "match of 45 or more")
    # 10,000 sampled contained reads occur in a kept read or its rc (all
    # reads are 100 bp long, so occurring is being equal)
    have = {r.tobytes() for r in krows} | \
        {(3 - r[::-1]).tobytes() for r in krows}
    cidx = np.flatnonzero(contained)
    pick = rng.choice(cidx, min(10000, cidx.size), replace=False)
    if not all(rows[i].tobytes() in have for i in pick):
        raise SystemExit("readjoiner: a contained read occurs in no kept "
                         "read")
    # an independent witness that no SPM is missing: the numpy join on
    # the kept reads that start in sequence 0's first 500,000 bp
    win = np.flatnonzero(((seqno == 0) & (start < 500000))[~contained])
    t0 = time.perf_counter()
    nwit = spm_witness(rj, krows, win)
    log(f"sampled SPMs and contained reads hold; the native and numpy "
        f"joins agree on {nwit} SPMs of {win.size} kept reads "
        f"({time.perf_counter() - t0:.1f}s)")
    contigs = [ln for ln in Path("rs.contigs.fas").read_bytes().split(b"\n")
               if ln and not ln.startswith(b">")]
    clen = np.asarray([len(c) for c in contigs], np.int64)
    t0 = time.perf_counter()
    nverb = verbatim(contigs, genome)
    dtv = time.perf_counter() - t0
    # encseq2spm over the kept reads' index, after an in-process
    # suffixerator (its sort on the card)
    reads_fasta(krows, work / "kept.fna")
    _, dts = run_cli(cli, ["suffixerator", "-db", "kept.fna", "-indexname",
                           "kept", "-tis"])
    log(f"suffixerator -tis on the kept reads: {dts:.3f}s [{smi}]")
    out, dte = run_cli(cli, ["encseq2spm", "-ii", "kept", "-l", "45",
                             "-spm", "count"])
    count = int(out[0].split(":")[1])
    if count != spms.length.size:
        raise SystemExit(f"encseq2spm counts {count} SPMs, overlap "
                         f"{spms.length.size}")
    log(f"readjoiner: {rows.shape[0]} reads, {int(contained.sum())} "
        f"contained, {spms.length.size} SPMs (encseq2spm: {count}), "
        f"{len(contigs)} contigs of {int(clen.sum())} bp, N50 {n50(clen)}, "
        f"{nverb} of them verbatim in the genome ({dtv:.1f}s to check); "
        f"seconds: prefilter {times['prefilter']:.3f}, overlap "
        f"{times['overlap']:.3f}, assembly {times['assembly']:.3f}, cgraph "
        f"{times['cgraph']:.3f}, suffixerator -tis {dts:.3f}, encseq2spm "
        f"{dte:.3f} [{smi}]; 10,000 sampled SPMs and contained reads hold, "
        f"the numpy join agrees on {nwit} SPMs")


def phase_querytools(cli, work: Path, smi: str) -> None:
    """Phase 15: genomediff and shulengthdist on g4m's two sequences,
    uniquesub and matstat with phase 3's at1MB index and Atinsert; each
    tool's lines against the same tool over ESAs built by the host SA-IS
    and Kasai engines."""
    from genometools_torch.index.esa import (EnhancedSuffixArray, Encseq,
                                             host_sa_lcp, write_esa)
    from genometools_torch.match import genomediff as gd
    from genometools_torch.utils.synthetic import planted_repeats
    from genometools_torch.utils.synthetic import write_fasta as fasta
    for i, s in enumerate(planted_repeats()):
        fasta([s], work / f"g4m_{i}.fna", f"g4m_{i}")
    write_fasta(Encseq.load(str(GOLDEN / "Atinsert.fna" / "idx")),
                work / "Atinsert.fna")
    enc = Encseq.load("idx")
    sa, lcp = host_sa_lcp(enc.suffix_keys())
    enc.save("hidx")
    write_esa(EnhancedSuffixArray(enc, 0, sa, lcp), "hidx")
    build, spent, sizes = gd.build_esa, [], []

    def timed(b):
        def run(*a, **k):
            t0 = time.perf_counter()
            out = b(*a, **k)
            spent.append(time.perf_counter() - t0)
            sizes.append(int(out.suftab.size))
            return out
        return run
    for argv in (["genomediff", "g4m_0.fna", "g4m_1.fna"],
                 ["shulengthdist", "-ii", "g4m"],
                 ["uniquesub", "-esa", "{}", "-query", "Atinsert.fna",
                  "-min", "10", "-max", "20"],
                 ["matstat", "-esa", "{}", "-query", "Atinsert.fna"]):
        runs = {}
        try:
            for how, b in (("card", build), ("host", host_esa_build())):
                gd.build_esa = timed(b)
                spent.clear()
                sizes.clear()
                out, dt = run_cli(cli, [a.replace("{}", "idx" if how == "card"
                                                  else "hidx") for a in argv])
                runs[how] = (out, dt, sum(spent), list(sizes))
        finally:
            gd.build_esa = build
        (out, dt, sb, nb), (hout, hdt, hb, _) = runs["card"], runs["host"]
        if out != hout or not out:
            raise SystemExit(f"{argv[0]}: lines differ over host-built ESAs")
        log(f"{' '.join(argv).replace('{}', 'idx')}: {len(out)} lines in "
            f"{dt:.3f}s, of which {len(nb)} build_esa on the card "
            f"(suftab entries {nb}) {sb:.3f}s "
            f"[{smi}]; over host SA-IS + Kasai ESAs {hdt:.3f}s (their "
            f"construction {hb:.3f}s); lines equal"
            + (f"; {out[1:3]}" if argv[0] != "matstat" else ""))


def phase_ltr(cli, work: Path, dev, smi: str):
    """Phase 16: ltrharvest, tirvish and ltrclustering on a 32 Mbp
    planted-transposon genome (4 x 8,000,000 bp, numpy seed 2027, 400
    LTR elements of 40 families, 200 TIR elements): the batch routes'
    outputs (tabout lines, GFF3, FASTA) against the host routes' (one
    maximal pair at a time, as the reference) on the whole genome,
    ltrclustering's GFF3 against seed_extend's fused host engine,
    the launches of K3 (ltrharvest, tirvish) and K1 (ltrclustering) read
    around each run, and the recall of the planted elements within 3 bp
    (printed). Returns the genome's sequences and planted rows."""
    from genometools_torch.anno.gff3 import gff3_to_string, parse_gff3
    from genometools_torch.index.esa import Encseq
    from genometools_torch.ltr import ltrclustering as lc
    from genometools_torch.ltr import ltrharvest as lh
    from genometools_torch.ltr import tirvish as tv
    from genometools_torch.ops import greedy_full as gf
    from genometools_torch.ops import xdrop_batch as xb
    from genometools_torch.ops import xdrop_full as xf
    from genometools_torch.utils.synthetic import planted_transposons
    from genometools_torch.utils.synthetic import write_fasta as fasta
    t0 = time.perf_counter()
    seqs, planted = planted_transposons()
    fasta(seqs, work / "pt.fna", "chr")
    log(f"planted_transposons: 4 x 8,000,000 bp, {len(planted)} elements, "
        f"{time.perf_counter() - t0:.1f}s to generate")
    lines, dt = run_cli(cli, ["suffixerator", "-db", "pt.fna", "-indexname",
                              "pt", "-tis", "-suf", "-lcp"])
    log(f"suffixerator -tis -suf -lcp pt.fna: {dt:.3f}s [{smi}]")
    enc = Encseq.load("pt")

    # ltrharvest: the library with its step times, then the CLI
    params = lh.LTRHarvestParams(with_tsd=True)
    reset_counts()
    tr = {}
    t0 = time.perf_counter()
    preds = lh.ltrharvest(enc, params, device=dev, trace=tr)
    dt = time.perf_counter() - t0
    k3 = xf.launches
    log(f"ltrharvest (defaults, -mintsd 4): {len(preds)} predictions in "
        f"{dt:.3f}s [{smi}]; maximal pairs {tr['maxpairs']}, pairs "
        f"kept {tr['pairs']}, xdrop lanes {tr['lanes']} ("
        f"{xdrop_lanes(xb)}), K3 launches {k3}; candidates "
        f"{tr['candidates']}, distinct {tr['distinct']}; seconds: "
        f"build_esa {tr['build_esa_s']:.3f}, maxpairs "
        f"{tr['maxpairs_s']:.3f}, extensions {tr['extensions_s']:.3f}, "
        f"similarity {tr['similarity_s']:.3f}, filters "
        f"{tr['filters_s']:.3f}, output {tr['output_s']:.3f}")
    if k3 == 0:
        raise SystemExit("ltrharvest launched K3 no time")
    out, dt = run_cli(cli, ["ltrharvest", "-index", "pt", "-longoutput",
                            "-out", "pt.fas", "-outinner", "pt.inner.fas"])
    if out[1:] != lh.tabout_lines(preds, enc, True):
        raise SystemExit("the ltrharvest CLI's lines differ from the "
                         "library's")
    gff3 = gff3_to_string(lh.gff3_nodes(preds, enc))
    (work / "pt.gff3").write_text(gff3)
    fas = lh.fasta_out_entries(preds, enc)
    if (work / "pt.fas").read_text() != "".join(x + "\n" for x in fas):
        raise SystemExit("the ltrharvest CLI's FASTA differs")
    log(f"ltrharvest CLI -tabout -longoutput -out -outinner: {dt:.3f}s, "
        f"{len(out) - 1} lines equal the library's")
    ltrs = planted[planted[:, 0] == 0]
    hit = sum(any(p.seqnum == r[1] and abs(p.start1 - r[2]) <= 3 and
                  abs(p.end2 - r[5]) <= 3 for p in preds) for r in ltrs)
    over = sum(any(p.seqnum == r[1] and p.start1 <= r[5] and
                   r[2] <= p.end2 for p in preds) for r in ltrs)
    log(f"ltrharvest recall: {hit} of {len(ltrs)} planted LTR elements "
        f"within 3 bp, {over} overlapped by a prediction")
    t0 = time.perf_counter()
    h = lh.ltrharvest(enc, params, device=dev, engine="host")
    th = time.perf_counter() - t0
    for what, f in (("tabout", lambda q: lh.tabout_lines(q, enc, True)),
                    ("GFF3", lambda q: gff3_to_string(lh.gff3_nodes(q, enc))),
                    ("FASTA", lambda q: lh.fasta_out_entries(q, enc)),
                    ("inner FASTA",
                     lambda q: lh.fasta_out_entries(q, enc, True))):
        if f(preds) != f(h):
            raise SystemExit(f"ltrharvest {what} differs between the batch "
                             f"and host routes")
    log(f"ltrharvest host route (pair by pair, all {tr['pairs']} pairs the "
        f"filters keep): {th:.3f}s; {len(h)} predictions, tabout, GFF3 and "
        f"FASTA equal the batch route's")

    # tirvish
    reset_counts()
    tr = {}
    t0 = time.perf_counter()
    pairs = tv.tirvish(enc, tv.TIRvishParams(), device=dev, trace=tr)
    dt = time.perf_counter() - t0
    k3 = xf.launches
    log(f"tirvish (defaults, mirrored ESA of {2 * enc.total_length + 1} "
        f"symbols): {len(pairs)} predictions in {dt:.3f}s [{smi}]; maximal "
        f"pairs {tr['maxpairs']}, seeds kept {tr['seeds']}, xdrop lanes "
        f"{tr['lanes']} ({xdrop_lanes(xb)}), K3 launches {k3}; seconds: "
        f"build_esa {tr['build_esa_s']:.3f}, maxpairs {tr['maxpairs_s']:.3f}"
        f", extensions {tr['extensions_s']:.3f}, filters "
        f"{tr['filters_s']:.3f}, TSDs and similarity {tr['pairs_s']:.3f}")
    if k3 == 0:
        raise SystemExit("tirvish launched K3 no time")
    out, dt = run_cli(cli, ["tirvish", "-index", "pt"])
    if "".join(x + "\n" for x in out) != \
            gff3_to_string(tv.gff3_nodes(pairs, enc)):
        raise SystemExit("the tirvish CLI's GFF3 differs from the library's")
    tirs = planted[planted[:, 0] == 1]
    hit = sum(any(q.contignumber == r[1] and
                  abs(q.left_tir_start - int(enc.seq_startpos(r[1])) - r[2])
                  <= 3 for q in pairs) for r in tirs)
    log(f"tirvish CLI: {dt:.3f}s, GFF3 equals the library's; recall: "
        f"{hit} of {len(tirs)} planted TIR elements' left arms within 3 bp")
    t0 = time.perf_counter()
    h = tv.tirvish(enc, tv.TIRvishParams(), device=dev, engine="host")
    th = time.perf_counter() - t0
    if gff3_to_string(tv.gff3_nodes(h, enc)) != \
            gff3_to_string(tv.gff3_nodes(pairs, enc)):
        raise SystemExit("tirvish's GFF3 differs between the batch and host "
                         "routes")
    log(f"tirvish host route (seed by seed, all {tr['seeds']} seeds the "
        f"filters keep): {th:.3f}s; {len(h)} predictions, GFF3 equals the "
        f"batch route's")

    # ltrclustering on ltrharvest's GFF3
    reset_counts()
    out, dt = run_cli(cli, ["ltrclustering", "-psmall", "80", "-plarge",
                            "30", "pt", "pt.gff3"])
    k1 = gf.launches
    t0 = time.perf_counter()
    fused = gff3_to_string(lc.ltrclustering(enc, parse_gff3(gff3), 80, 30,
                                            engine="fused"))
    tf = time.perf_counter() - t0
    if "".join(x + "\n" for x in out) != fused:
        raise SystemExit("ltrclustering differs from its fused host route")
    clids = {x.split("clid=")[1].split(";")[0] for x in out if "clid=" in x}
    log(f"ltrclustering -psmall 80 -plarge 30: {dt:.3f}s [{smi}], K1 "
        f"launches {k1}, {len(clids)} cluster ids; equals the fused host "
        f"route ({tf:.3f}s)")
    if k1 == 0:
        raise SystemExit("ltrclustering launched K1 no time")
    return seqs, planted


def tag_rows(lines) -> dict:
    """Per tag, its sorted rows (tagerator's output, as
    tests/test_tagerator_golden.py compares it)."""
    per, cur = {}, None
    for line in lines:
        if line.startswith("#\t"):
            cur = line.split("\t")[1]
            per.setdefault(cur, [])
        elif not line.startswith("#") and line.strip():
            per[cur].append(tuple(line.split()))
    return {k: sorted(v) for k, v in per.items()}


def phase_packed(cli, work: Path, dev, smi: str) -> None:
    """Phase 17: the packed index and the ESA tools on phase 3's at1MB
    index and gt's goldens."""
    from genometools_torch.index.esa import (EnhancedSuffixArray, Encseq,
                                             host_sa_lcp, write_esa)
    from genometools_torch.index import fmindex as fmi
    gtag = ROOT / "tests" / "golden_tagerator"
    _, dt = run_cli(cli, ["packedindex", "mkindex", "-ii", "idx",
                          "-indexname", "pidx"])
    log(f"packedindex mkindex of at1MB: {dt:.3f}s [{smi}]")
    for gold, db, rm in (("default.bdx", "Atinsert.fna", 0),
                         ("bsize4.bdx", "Duplicate.fna", 0),
                         ("rev.bdx", "Random.fna", 1),
                         ("ttt.bdx", "TTT-small.fna", 0)):
        for f in (GOLDEN / db).iterdir():
            shutil.copy(f, work / f"b_{db}{f.suffix}")
        shutil.copy(ROOT / "tests" / "golden_bdx" / gold,
                    work / f"b_{db}.bdx")
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = cli.main(["packedindex", "chkintegrity", "-ii", f"b_{db}",
                           "-dir", str(rm)])
        if rc != 0:
            raise SystemExit(f"chkintegrity refused gt's {gold}")
        log(f"chkintegrity {gold} (-dir {rm}): {err.getvalue().strip()}")
    atins = str(GOLDEN / "Atinsert.fna" / "idx")
    gold_args = [(["-e", "0"], "golden_e_0.txt"),
                 (["-e", "1"], "golden_e_1.txt"),
                 (["-e", "2"], "golden_e_2.txt"),
                 (["-e", "2", "-best"], "golden_e_2_best.txt"),
                 (["-e", "1", "-nop"], "golden_e_1_nop.txt"),
                 (["-e", "1", "-nod"], "golden_e_1_nod.txt"),
                 (["-e", "1", "-output", "tagnum", "tagseq", "dblength",
                   "dbstartpos", "strand", "edist"],
                  "golden_e_1_output_tagnum_tagseq_dblength_dbstartpos_"
                  "strand_edist.txt"),
                 (["-e", "1", "-maxocc", "5"], "golden_e_1_maxocc_5.txt")]
    for args, gold in gold_args:
        for route in ("-esa", "-pck"):
            out, _ = run_cli(cli, ["tagerator", *args, "-q",
                                   str(gtag / "tags.fna"), route, atins])
            got = tag_rows(out)
            if "-maxocc" in args:
                # gt computes prefix matches here; the port keeps the first
                # 5 rows of each search, as the reference package does
                full = tag_rows(run_cli(cli, [
                    "tagerator", "-e", "1", "-q", str(gtag / "tags.fna"),
                    route, atins])[0])
                if any(not set(v) <= set(full[k]) for k, v in got.items()):
                    raise SystemExit("tagerator -maxocc rows are not rows "
                                     "of the unlimited search")
                continue
            if got != tag_rows((gtag / gold).read_text().splitlines()):
                raise SystemExit(f"tagerator {route} {' '.join(args)} "
                                 f"differs from gt's {gold}")
    log("tagerator -esa and -pck: per-tag rows equal gt's 7 goldens; "
        "-maxocc 5 (gt: prefix matches) keeps rows of the full search")
    # at scale: 1,000 24-mers of at1MB with 0-2 random edits, -e 2
    at1 = Encseq.load("idx")
    rng = np.random.default_rng(8)
    tags = []
    while len(tags) < 1000:
        p = int(rng.integers(0, at1.total_length - 24))
        tag = at1.codes[p:p + 24].copy()
        if (tag >= 4).any():
            continue
        for _ in range(int(rng.integers(0, 3))):
            tag[rng.integers(0, 24)] = rng.integers(0, 4)
        tags.append(tag)
    with open("tags1k.fna", "w") as f:
        for i, tag in enumerate(tags):
            f.write(f">t{i}\n{at1.alphabet.decode(tag)}\n")
    res = {}
    for route in ("-esa", "-pck"):
        out, dt = run_cli(cli, ["tagerator", "-e", "2", "-q", "tags1k.fna",
                                route, "idx"])
        res[route] = (tag_rows(out), dt)
    if res["-esa"][0] != res["-pck"][0]:
        raise SystemExit("tagerator -esa and -pck differ on the 1,000 tags")
    nrows = sum(len(v) for v in res["-esa"][0].values())
    log(f"tagerator -e 2, 1,000 24-mers of at1MB: {nrows} rows; -esa "
        f"{res['-esa'][1]:.3f}s, -pck {res['-pck'][1]:.3f}s [{smi}]; rows "
        f"equal")
    # tags longer than 31 - e symbols, with 0-2 random edits
    with open("tags_long.fna", "w") as f:
        for i in range(100):
            L = int(rng.integers(32, 41))
            p = int(rng.integers(0, at1.total_length - L))
            tag = at1.codes[p:p + L].copy()
            tag[tag >= 4] = 0
            for _ in range(int(rng.integers(0, 3))):
                tag[rng.integers(0, L)] = rng.integers(0, 4)
            f.write(f">l{i}\n{at1.alphabet.decode(tag)}\n")
    res = {}
    for route in ("-esa", "-pck"):
        out, dt = run_cli(cli, ["tagerator", "-e", "2", "-q",
                                "tags_long.fna", route, "idx"])
        res[route] = (tag_rows(out), dt)
    if res["-esa"][0] != res["-pck"][0]:
        raise SystemExit("tagerator -esa and -pck differ on the 32-40 bp "
                         "tags")
    nrows = sum(len(v) for v in res["-esa"][0].values())
    log(f"tagerator -e 2, 100 tags of 32-40 bp of at1MB: {nrows} rows; -esa "
        f"{res['-esa'][1]:.3f}s, -pck {res['-pck'][1]:.3f}s [{smi}]; rows "
        f"equal")
    fm = fmi.fmindex_from_codes(at1.codes, device=dev)
    rank = fmi.FMDeviceRank(fm, device=dev)
    pats = np.stack(tags)
    ms, (lo, hi) = cuda_ms(lambda: rank.backward_search_batch(pats), reps=5)
    t0 = time.perf_counter()
    host = [fm.backward_search(p) for p in pats]
    th = time.perf_counter() - t0
    if [(int(a), int(b)) for a, b in zip(lo, hi)] != host:
        raise SystemExit("FMDeviceRank's batch differs from the host "
                         "backward search")
    log(f"FMDeviceRank.backward_search_batch, 1,000 24-mers (e = 0): "
        f"{ms:.3f} ms (CUDA events, mean of 5, host copies included) "
        f"[{smi}]; host backward_search {th * 1e3:.1f} ms; "
        f"{int((hi > lo).sum())} found, intervals equal")
    at1.save("pbt")
    _, dt = run_cli(cli, ["prebwt", "-pck", "pbt", "-maxdepth", "8"])
    # the reference's route: one host backward search per code
    t0 = time.perf_counter()
    rfm = fmi.fmindex_from_codes(at1.codes[::-1].copy(), device=dev)
    bounds = {}
    for depth in range(1, 9):
        for code in itertools.product(range(4), repeat=depth):
            lo, hi = rfm.backward_search(np.asarray(code, np.uint8))
            if hi > lo:
                bounds["".join(map(str, code))] = [int(lo), int(hi)]
    th = time.perf_counter() - t0
    if (work / "pbt.pbt").read_text() != json.dumps(
            {"maxdepth": 8, "bounds": bounds}):
        raise SystemExit("prebwt's .pbt differs from the host searches'")
    log(f"prebwt -maxdepth 8: {dt:.3f}s [{smi}] (87,380 codes in 8 batches),"
        f" one host backward search per code {th:.3f}s; .pbt equal "
        f"({len(bounds)} buckets)")
    _, dt = run_cli(cli, ["mergeesa", "-indexname", "mrg", "-ii", "idx",
                          atins])
    merged = Encseq.load("mrg")
    sa, lcp = host_sa_lcp(merged.suffix_keys())
    write_esa(EnhancedSuffixArray(merged, 0, sa, lcp), "hmrg")
    for ext in ("suf", "lcp", "llv"):
        if (work / f"mrg.{ext}").read_bytes() != \
                (work / f"hmrg.{ext}").read_bytes():
            raise SystemExit(f"mergeesa .{ext} differs from host SA-IS + "
                             f"Kasai")
    log(f"mergeesa at1MB + Atinsert: {dt:.3f}s [{smi}], "
        f"{merged.total_length + 1} suffixes; .suf/.lcp/.llv equal host "
        f"SA-IS + Kasai")
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli.main(["sain", "-esa", "idx", "-check"])
    if rc != 0:
        raise SystemExit("sain -check failed")
    log(f"sain -check at1MB: {time.perf_counter() - t0:.3f}s; "
        f"{err.getvalue().strip()}")


MESH_SHARDS = 8
MESH_WIDE_N = 2 ** 28           # phase 18's wide keys, sentinel included


def mesh_wide_keys(n: int, dev) -> torch.Tensor:
    """n int32 keys that are not canonical: n - 1 random ACGT symbols
    (torch.Generator seed 2028 on the card) with 4,096 runs of 1 to
    1,000 UNDEFCHAR keys (253, the same key at every position), the
    sentinel (4 + n - 1) last."""
    g = torch.Generator(device=dev)
    g.manual_seed(2028)
    keys = torch.randint(0, 4, (n,), generator=g, dtype=torch.int32,
                         device=dev)
    starts = torch.randint(0, n - 1001, (4096,), generator=g, device=dev)
    lens = torch.randint(1, 1001, (4096,), generator=g, device=dev)
    mark = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    ones = torch.ones(4096, dtype=torch.int32, device=dev)
    mark.index_add_(0, starts, ones)
    mark.index_add_(0, starts + lens, -ones)
    keys[torch.cumsum(mark, 0)[:n] > 0] = 253
    keys[n - 1] = 4 + n - 1
    return keys


def synced(fn):
    """(seconds on the host clock, fn()) with the card synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def phase_mesh(cli, work: Path, dev, smi: str, grid_lines: dict) -> dict:
    """Phase 18: the multi-device layer on a mesh of MESH_SHARDS shards of
    the card (cwd: the phase-3 index); returns the kernels' launches in
    its distributed grid and the -dist CLI run."""
    from genometools_torch import _kernels
    from genometools_torch.assembly import readjoiner as rj
    from genometools_torch.index import suffix
    from genometools_torch.index.esa import Encseq, build_esa, dist_mesh
    from genometools_torch.match.maxpairs import enumerate_maxpairs
    from genometools_torch.match.seed_extend import SeedExtendParams
    from genometools_torch.ops import greedy_full as gf
    from genometools_torch.ops import greedy_resident as gr
    from genometools_torch.ops import xdrop_full as xf
    from genometools_torch.ops.kmer import kmer_codes64
    from genometools_torch.parallel import dist_doubling_sharded as dds
    from genometools_torch.parallel.dist_doubling import distributed_build_sa
    from genometools_torch.parallel.dist_esa import (sharded_kmer_histogram,
                                                     sharded_suffix_sort)
    from genometools_torch.parallel.dist_maxpairs import distributed_maxpairs
    from genometools_torch.parallel.dist_readjoiner import (
        distributed_find_spms, sharded_spm_candidate_count)
    from genometools_torch.parallel.dist_seed_grid import \
        distributed_seed_extend
    from genometools_torch.parallel.dist_tallymer import sharded_mer_counts
    from genometools_torch.parallel.dryrun import dryrun_multichip
    from genometools_torch.parallel.mesh import Mesh, gather
    mesh = Mesh([dev] * MESH_SHARDS)
    one = Mesh([dev])
    log(f"mesh: {mesh}; the single-shard mesh: {one}")

    # 18.1 the sharded suffix sort at 32 Mbp against the packed pipeline
    big = Encseq.from_files([str(work / "big.fna")])
    keys = big.suffix_keys()
    kd = torch.from_numpy(keys).to(dev)
    n1 = keys.size
    dt, packed = synced(lambda: suffix.build_suffix_array(
        kd, with_lcp=False, device=dev)[0])
    packed = packed.cpu().numpy()
    log(f"32 Mbp: {n1} suffixes; packed pipeline {dt:.3f}s")
    npad = -(-n1 // MESH_SHARDS) * MESH_SHARDS
    kp = torch.cat([kd, int(kd.max()) + 1 + torch.arange(
        npad - n1, dtype=torch.int32, device=dev)])
    for label, m, k, n in (("8 shards", mesh, kp, npad),
                           ("1 shard", one, kd, n1)):
        torch.cuda.reset_peak_memory_stats()
        dt, (sa, ovf) = synced(lambda: dds.sharded_build_sa_sample(k, n, m))
        same = np.array_equal(gather(sa)[:n1].cpu().numpy(), packed)
        log(f"sample-sort engine, int32 lanes, {label}: {dt:.3f}s "
            f"[{smi}]; overflow flag {ovf}; peak device memory "
            f"{torch.cuda.max_memory_allocated()} bytes; SA "
            f"{'equals' if same else 'DIFFERS FROM'} the packed pipeline's")
        if ovf or not same:
            raise SystemExit(f"the sample-sort engine ({label}) failed")
        del sa
    for label, kw, m in (("bitonic engine, 8 shards", {"engine": "bitonic"},
                          mesh),
                         ("int64 lanes, 8 shards", {"lanes": "int64"}, mesh),
                         ("int64 lanes, 1 shard", {"lanes": "int64"}, one)):
        dt, sa = synced(lambda: dds.sharded_suffix_array(kd, m, **kw))
        log(f"sharded_suffix_array, {label}: {dt:.3f}s [{smi}] ({sa.dtype})")
        if not np.array_equal(sa, packed):
            raise SystemExit(f"sharded_suffix_array ({label}) differs from "
                             "the packed pipeline")
    log("32 Mbp: every sharded SA equals the packed pipeline's")
    del kd, kp, packed
    torch.cuda.empty_cache()

    # 18.2 the wide route through build_suffix_array
    wk = mesh_wide_keys(MESH_WIDE_N, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trace = {}
    dt, (sa, lcp) = synced(lambda: suffix.build_suffix_array(
        wk, device=dev, engine="wide", trace=trace))
    peak = torch.cuda.max_memory_allocated()
    nund = int((wk == 253).sum())
    log(f"wide route: {MESH_WIDE_N} non-canonical keys ({nund} UNDEFCHAR) "
        f"in {dt:.3f}s [{smi}]: the int64 sample-sort engine on one shard "
        f"{trace['sort_s']:.3f}s, host Kasai {trace['kasai_s']:.3f}s; peak "
        f"device memory {peak} bytes ({peak / MESH_WIDE_N:.1f} bytes a "
        f"position, the keys' included); max lcp {int(lcp.max())}")
    t0 = time.perf_counter()
    ok = suffix.check_sa_lcp(wk, sa, lcp)
    log(f"certificate (check_sa_lcp): {'passed' if ok else 'FAILED'} in "
        f"{time.perf_counter() - t0:.3f}s")
    if trace["engine"] != "wide" or not ok:
        raise SystemExit("the wide route failed")
    del wk, sa, lcp
    torch.cuda.empty_cache()

    # 18.3 the smaller sorts on at1MB against phase 3's SA
    at1 = Encseq.load("idx")
    keys1 = at1.suffix_keys()
    m1 = keys1.size
    ref_sa = np.fromfile("idx.suf", np.uint64).astype(np.int64)
    esa = build_esa(at1, device=dev)
    depth = int(esa.lcptab.max()) + 1
    dt, (sa, hist) = synced(lambda: sharded_suffix_sort(keys1, m1, depth,
                                                        mesh))
    want_hist = np.bincount(np.minimum(keys1, 4), minlength=5)
    log(f"sharded_suffix_sort at1MB, {depth} symbols deep: {dt:.3f}s "
        f"[{smi}]; histogram {hist.tolist()}")
    dt2, hist2 = synced(lambda: sharded_kmer_histogram(keys1, m1, mesh))
    mpad = -(-m1 // MESH_SHARDS) * MESH_SHARDS
    kp1 = np.concatenate([keys1, keys1.max() + 1 + np.arange(
        mpad - m1, dtype=np.int32)])
    dt3, sa3 = synced(lambda: distributed_build_sa(kp1, mpad, mesh))
    log(f"sharded_kmer_histogram {dt2:.3f}s; distributed_build_sa "
        f"{dt3:.3f}s [{smi}]")
    if not (np.array_equal(sa.cpu().numpy(), ref_sa)
            and np.array_equal(sa3.cpu().numpy()[:m1], ref_sa)
            and hist.tolist() == hist2.tolist() == want_hist.tolist()):
        raise SystemExit("a sharded sort of at1MB differs from phase 3's")
    log("at1MB: sharded_suffix_sort and distributed_build_sa equal phase "
        "3's SA, the histograms the host's")

    # 18.4 the distributed grid: K1 and K3 on every lane
    lanes4 = [dev] * 4
    launches = {"K1": 0, "K2r": 0, "K3": 0}
    for ext, kname in (("greedy", "greedy_full"), ("xdrop", "xdrop_full")):
        p = SeedExtendParams(minidentity=90, userdefinedleastlength=14,
                             extension=ext, parts=3)
        reset_counts()
        _kernels.lane_launches.clear()
        dt, ms = synced(lambda: distributed_seed_extend(at1, None, p,
                                                        devices=lanes4))
        per_lane = {lane: _kernels.lane_launches.get((lane, kname), 0)
                    for lane in range(len(lanes4))}
        launches["K1"] += gf.launches
        launches["K2r"] += gr.launches
        launches["K3"] += xf.launches
        lines = [m.line() for m in ms]
        log(f"distributed_seed_extend {ext} -parts 3 over 4 lanes of {dev}: "
            f"{len(lines)} matches in {dt:.3f}s [{smi}]; {route_counts()}; "
            f"{kname} launches per lane {per_lane}; all launches by lane "
            f"{dict(sorted(_kernels.lane_launches.items()))}")
        if lines != grid_lines[ext]:
            raise SystemExit(f"distributed_seed_extend {ext} differs from "
                             "phase 11's lines")
        if min(per_lane.values()) == 0:
            raise SystemExit(f"{kname} did not launch on every lane")

    # 18.5 tallymer's counts, readjoiner's overlaps, maximal pairs
    dt, (code, valid) = synced(lambda: kmer_codes64(big.codes, 15,
                                                    device=dev))
    code = code[valid]
    dt1, (uq, cnt) = synced(lambda: torch.unique(code, return_counts=True))
    codes_h = code.cpu().numpy()
    dt2, (mers, counts) = synced(lambda: sharded_mer_counts(codes_h, 15,
                                                            mesh))
    log(f"sharded_mer_counts 32 Mbp k=15: {codes_h.size} codes, "
        f"{mers.size} mers in {dt2:.3f}s [{smi}]; the card's torch.unique "
        f"{dt1:.3f}s")
    if not (np.array_equal(mers, uq.cpu().numpy())
            and np.array_equal(counts, cnt.cpu().numpy())):
        raise SystemExit("sharded_mer_counts differs from torch.unique")
    del code, valid, uq, cnt
    rows = g4m_reads(5)[0]
    rs = rj.ReadSet(blob=rows.reshape(-1), lens=np.full(rows.shape[0], 100))
    dtc, cand = synced(lambda: sharded_spm_candidate_count(rs, 45, mesh))
    dt, got = synced(lambda: distributed_find_spms(rs, 45, mesh,
                                                   irreducible=False))
    t0 = time.perf_counter()
    want = rj.find_spms(rs, 45, irreducible=False)
    dts = time.perf_counter() - t0
    log(f"distributed_find_spms: {rs.num_reads} reads of 100 bp (g4m at 5x)"
        f", -l 45, no transitive filter: {cand} candidates counted in "
        f"{dtc:.3f}s, {got.length.size} SPMs in {dt:.3f}s [{smi}]; "
        f"find_spms {dts:.3f}s")
    if not all(np.array_equal(getattr(got, f), getattr(want, f)) for f in
               ("suf_read", "suf_strand", "pref_read", "pref_strand",
                "length")):
        raise SystemExit("distributed_find_spms differs from find_spms")
    dt, mp = synced(lambda: distributed_maxpairs(esa, 14, devices=mesh))
    t0 = time.perf_counter()
    mp1 = enumerate_maxpairs(esa, 14)
    log(f"distributed_maxpairs at1MB -l 14: {mp.count} pairs in {dt:.3f}s "
        f"over {MESH_SHARDS} lanes; enumerate_maxpairs "
        f"{time.perf_counter() - t0:.3f}s")
    if not all(np.array_equal(getattr(mp, f), getattr(mp1, f))
               for f in ("pos1", "pos2", "length")):
        raise SystemExit("distributed_maxpairs differs")

    # 18.6 the CLI's -dist
    _, dt = run_cli(cli, ["suffixerator", "-db", "at1MB.fna", "-indexname",
                          "dist8", "-suf", "-lcp", "-tis", "-dist", "8"])
    log(f"suffixerator -dist 8: {dt:.3f}s; {torch.cuda.device_count()} "
        f"card(s), so the mesh has {dist_mesh(8, dev).size} shard(s): "
        + ("the one-shard route (build_suffix_array on the card)"
           if dist_mesh(8, dev).size == 1 else "the sharded engine"))
    for ext in ("suf", "lcp", "llv", "prj"):
        if (work / f"dist8.{ext}").read_bytes() != golden_bytes("at1MB",
                                                                 ext):
            raise SystemExit(f"suffixerator -dist 8 .{ext} differs from the "
                             "golden")
    reset_counts()
    lines, dt = run_cli(cli, ["seed_extend", "-ii", "idx", "-l", "14",
                              "-minidentity", "90", "-extendgreedy",
                              "-dist", "4", "-parts", "3"])
    launches["K1"] += gf.launches
    launches["K2r"] += gr.launches
    launches["K3"] += xf.launches
    log(f"seed_extend -dist 4 -parts 3: {len(lines)} matches in {dt:.3f}s "
        f"[{smi}]; {route_counts()}")
    if lines != grid_lines["greedy"]:
        raise SystemExit("seed_extend -dist 4 -parts 3 differs from phase "
                         "11's lines")

    # 18.7 the dry run
    dt, _ = synced(lambda: dryrun_multichip(MESH_SHARDS, "cuda"))
    log(f"dryrun_multichip: {dt:.3f}s")
    return launches


def pbs_fields(hits) -> list:
    return [(h.rng.start, h.rng.end, h.strand, h.trna, h.trna_offset,
             h.offset, h.edist, h.score) for h in hits]


def pbs_lane_rows(ld, elems, lib, dev, n: int) -> int:
    """The batch's raw rows (_sw_lanes on dev) of n lanes drawn with
    numpy seed 2030 from every (element, strand window, tRNA) lane,
    against the host's pbs_align; lanes that give no hit are held too.
    Returns how many of them the filters keep as hits."""
    from genometools_torch.core.alphabet import dna_alphabet
    from genometools_torch.utils.seqtools import revcomp_str
    p = ld.LTRdigestParams()
    wins = [w for seq, lrel, rrel, _ in elems
            for _, w in ld._pbs_windows(seq, lrel, rrel, p.pbs_radius)]
    trnas = [revcomp_str(t) for _, t in lib]
    rng = np.random.default_rng(2030)
    wk = rng.integers(0, len(wins), n)
    tk = rng.integers(0, len(trnas), n)
    al, ids, V = dna_alphabet(), {}, max(map(len, trnas))
    vc = np.full((n, V), 255, np.int32)
    vi = np.full((n, V), -1, np.int32)
    for k, t in enumerate(tk):
        s = trnas[t]
        vc[k, :len(s)] = al.encode(s.encode())
        vi[k, :len(s)] = ld._symbol_ids(s, ids)
    uc = np.stack([al.encode(wins[w].encode()) for w in wk]).astype(np.int32)
    ui = np.stack([ld._symbol_ids(wins[w], ids) for w in wk])
    vlen = torch.tensor([len(trnas[t]) for t in tk], device=dev)
    got = ld._sw_lanes(*(torch.from_numpy(a).to(dev) for a in (uc, vc)),
                       vlen, *(torch.from_numpy(a).to(dev) for a in (ui, vi)),
                       p, {}).cpu().tolist()
    want = [list(ld.pbs_align(wins[w], trnas[t], p)) for w, t in zip(wk, tk)]
    if got != want:
        bad = next(k for k in range(n) if got[k] != want[k])
        raise SystemExit(f"PBS lane {bad}: batch {got[bad]}, host "
                         f"{want[bad]}")
    return sum(r[0] > 0 and bool(ld._pbs_keep(r[4], abs(p.pbs_radius - r[1]),
                                              r[2] - r[1] + 1, r[3], p))
               for r in want)


def phase_anno(cli, work: Path, dev, smi: str, seqs, planted) -> None:
    """Phase 19: the annotator's pipeline on phase 16's genome (pt.fna,
    pt.gff3): chseqids, gff3 -sort, ltrdigest with a 200-tRNA library,
    ltrdigest -outfileprefix, stat, gff3validator and extractfeat,
    through the port's CLI on the card; every step must exit 0, and
    ltrdigest must find elements and annotate planted PBS. The PBS
    batch is held against the host route on 8 elements only (the first
    8 whose 5' LTR ends within 5 bp of a planted primer's: 3,200
    alignments at some 8 ms each on the host), and its raw rows on 512
    seeded lanes of the whole batch."""
    from genometools_torch.anno.cds import RegionMapping
    from genometools_torch.anno.gff3 import gff3_to_string, parse_gff3
    from genometools_torch.ltr import ltrdigest as ld
    from genometools_torch.utils.seqtools import revcomp_str
    from genometools_torch.utils.synthetic import trna_library
    lib, pairs = trna_library(seqs, planted)
    with open(work / "trna.fa", "w") as f:
        for name, s in lib:
            f.write(f">{name} tRNA-like\n{s}\n")
    log(f"tRNA library: {len(lib)} sequences of "
        f"{min(len(s) for _, s in lib)}-{max(len(s) for _, s in lib)} bp, "
        f"{len(pairs)} with a planted primer")
    (work / "pt.map.lua").write_text(
        "chseqids = {\n" + "".join(f'  seq{k} = "chr_{k}",\n'
                                   for k in range(len(seqs))) + "}\n")
    steps = {}

    def step(name, argv, out=None):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        steps[name] = time.perf_counter() - t0
        if rc:
            raise SystemExit(f"{name} exited {rc}")
        lines = buf.getvalue().splitlines()
        if out is not None:
            (work / out).write_text("".join(x + "\n" for x in lines))
        return lines

    step("chseqids", ["chseqids", "pt.map.lua", "pt.gff3"], "pt.chr.gff3")
    step("gff3 -sort", ["gff3", "-sort", "-retainids", "pt.chr.gff3"],
         "pt.sorted.gff3")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ldo = step("ltrdigest", ["ltrdigest", "-trnas", "trna.fa", "-seqfile",
                             "pt.fna", "pt.sorted.gff3"], "pt.ld.gff3")
    peak = torch.cuda.max_memory_allocated() - base
    if not ldo or ldo[0] != "##gff-version 3":
        raise SystemExit("ltrdigest printed no GFF3")

    # the library on the same input: the CLI's GFF3, the step times
    sorted_text = (work / "pt.sorted.gff3").read_text()
    t0 = time.perf_counter()
    mapping = RegionMapping.from_file("pt.fna")
    tmap = time.perf_counter() - t0
    tr = {}
    t0 = time.perf_counter()
    nodes = ld.ltrdigest(parse_gff3(sorted_text), mapping, lib, device=dev,
                         trace=tr)
    tlib = time.perf_counter() - t0
    if gff3_to_string(nodes, retainids=True) != \
            (work / "pt.ld.gff3").read_text():
        raise SystemExit("the ltrdigest CLI's GFF3 differs from the "
                         "library's")
    log(f"ltrdigest -trnas -seqfile: CLI {steps['ltrdigest']:.3f}s, "
        f"library {tlib:.3f}s (+ {tmap:.3f}s reading pt.fna) [{smi}]; "
        f"{tr['elements']} elements, {tr['lanes']} PBS lanes; PPT search "
        f"{tr['ppt_s']:.3f}s; PBS batch {tr['pbs_s']:.3f}s (fill "
        f"{tr['fill_s']:.3f}s, traceback {tr['traceback_s']:.3f}s, host "
        f"filters {tr['filters_s']:.3f}s); peak device memory of the CLI "
        f"run {peak / 2**20:.1f} MiB; the CLI's GFF3 equals the library's")

    if tr["elements"] == 0:
        raise SystemExit("ltrdigest found no LTR elements")

    # the PBS batch (warm) against the host route: every field of every
    # hit on the first 8 elements whose 5' LTR ends within 5 bp of a
    # planted primer's, then the raw rows of 512 seeded lanes
    elist = ld.ltr_elements(parse_gff3(sorted_text), mapping)
    elems = [(seq, lrel, rrel, fn.range.start) for fn, seq, _, _, lrel, rrel
             in elist]
    t = {}
    batch = ld.pbs_find_batch(elems, lib, device=dev, trace=t)
    log(f"PBS batch (warm): fill {t['fill_s']:.4f}s, traceback "
        f"{t['traceback_s']:.4f}s, host filters {t['filters_s']:.4f}s")
    primed = {(f"chr_{planted[row, 1]}", int(planted[row, 3]) + 1 + d)
              for _, row in pairs for d in range(-5, 6)}
    sample = [e for e, (fn, _, left, _, _, _) in enumerate(elist)
              if (fn.seqid, left.end) in primed][:8]
    if len(sample) < 8:
        raise SystemExit(f"only {len(sample)} elements near a planted "
                         f"primer")
    t0 = time.perf_counter()
    host = [ld.pbs_find(*elems[e], lib) for e in sample]
    th = time.perf_counter() - t0
    if [pbs_fields(h) for h in host] != \
            [pbs_fields(batch[e]) for e in sample]:
        raise SystemExit("the PBS batch differs from the host route")
    if not sum(map(len, host)):
        raise SystemExit("the host route found no PBS on the sample")
    per = th / (len(lib) * 2 * len(sample))
    log(f"PBS host route on {len(sample)} elements near a planted primer: "
        f"{th:.3f}s, {1e3 * per:.3f} ms an alignment ({sum(map(len, host))} "
        f"hits, equal to the batch's field by field); all {tr['lanes']} "
        f"lanes at that rate: {per * tr['lanes']:.0f}s (extrapolated, not "
        f"run)")
    kept = pbs_lane_rows(ld, elems, lib, dev, 512)
    log(f"PBS raw rows: 512 seeded lanes equal pbs_align's (score, ustart, "
        f"uend, vstart, edist); the filters keep {kept} of them")

    step("ltrdigest -outfileprefix",
         ["ltrdigest", "-trnas", "trna.fa", "-seqfile", "pt.fna",
          "-outfileprefix", "ptld", "pt.sorted.gff3"], "pt.ld2.gff3")
    if (work / "pt.ld2.gff3").read_text() != (work / "pt.ld.gff3").read_text():
        raise SystemExit("ltrdigest -outfileprefix printed other GFF3")
    rows = (work / "ptld_tabout.csv").read_text().splitlines()
    if len(rows) != tr["elements"] + 1:
        raise SystemExit(f"ptld_tabout.csv holds {len(rows)} lines for "
                         f"{tr['elements']} elements")
    stat = step("stat", ["stat", "pt.ld.gff3"])
    val = step("gff3validator", ["gff3validator", "pt.ld.gff3"])
    if val != ["input is valid GFF3"]:
        raise SystemExit(f"gff3validator: {val}")
    fa = step("extractfeat", ["extractfeat", "pt.ld.gff3", "-type",
                              "LTR_retrotransposon", "-seqfile", "pt.fna"])
    text = {f"chr_{k}": s.decode() for k, s in enumerate(seqs)}
    got, strands = {}, {}
    for top in nodes:
        for fn in getattr(top, "traverse", lambda: [])():
            if fn.type == "LTR_retrotransposon":
                strands[(fn.seqid, fn.range.start, fn.range.end)] = fn.strand
    for line in fa:
        if line.startswith(">"):
            sid, rng = line[1:].split()[1].rsplit(":", 1)
            a, b = (int(x) for x in rng.split(".."))
            cur = got.setdefault((sid, a, b), [])
        else:
            cur.append(line)
    if set(got) != set(strands):
        raise SystemExit("extractfeat's elements differ from ltrdigest's")
    for (sid, a, b), parts in got.items():
        want = text[sid][a - 1:b]
        if strands[(sid, a, b)] == "-":
            want = revcomp_str(want)
        if "".join(parts) != want:
            raise SystemExit(f"extractfeat's {sid}:{a}..{b} differs from "
                             f"pt.fna")
    pbs = [c for top in nodes for c in getattr(top, "traverse",
                                               lambda: [])()
           if c.type == "primer_binding_site"]
    found = sum(any(c.seqid == f"chr_{planted[row, 1]}" and
                    c.get_attribute("trna") == lib[slot][0] and
                    abs(c.range.start - (int(planted[row, 3]) + 2)) <= 3
                    for c in pbs) for slot, row in pairs)
    # a planted primer can pass the PBS offset filter (0-5) only where
    # ltrharvest's 5' LTR ends within 5 bp of the planted one
    ends = {(fn.seqid, left.end) for fn, _, left, _, _, _ in
            ld.ltr_elements(parse_gff3(sorted_text), mapping)}
    near = sum(any((f"chr_{planted[row, 1]}", int(planted[row, 3]) + 1 + d)
                   in ends for d in range(-5, 6)) for _, row in pairs)
    if not pbs or not found:
        raise SystemExit(f"{len(pbs)} PBS annotated, {found} planted PBS "
                         f"found")
    log(f"steps (s): " + ", ".join(f"{k} {v:.3f}" for k, v in steps.items())
        + f" [{smi}]; stat: {'; '.join(stat[:2])}; gff3validator: valid; "
        f"extractfeat: {len(got)} elements equal their slices of pt.fna; "
        f"PBS annotated on {len(pbs)} of {tr['elements']} elements, planted "
        f"PBS found within 3 bp: {found} of {len(pairs)} ({near} of them "
        f"have a predicted 5' LTR end within 5 bp of the planted one)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gens", default="",
                    help="comma-separated chunk GENS to time the phase-7 "
                         "K2 route at, beside the configured one")
    ap.add_argument("--profile", action="store_true",
                    help="run phase 7a's seed_extend once more under "
                         "cProfile and torch.profiler (device time)")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    sys.path.insert(0, str(ROOT))
    import genometools_torch
    from genometools_torch import _kernels, cli
    from genometools_torch.index.esa import Encseq, build_esa, write_esa
    from genometools_torch.match.ext_workload import collect_extension_pool
    from genometools_torch.match.seed_extend import (SeedExtendParams,
                                                     seed_extend)
    from genometools_torch.ops import greedy_batch as gb
    from genometools_torch.ops import greedy_chunk as gc
    from genometools_torch.ops import greedy_full as gf
    from genometools_torch.ops import greedy_resident as gr
    from genometools_torch.ops import pool as gpl
    from genometools_torch.ops import xdrop_batch as xb
    from genometools_torch.ops import xdrop_full as xf

    from genometools_torch.utils.synthetic import (planted_repeats,
                                                   write_fasta as fasta)
    for name in ("jax", "genometools_tpu"):
        if name in sys.modules:
            raise SystemExit(f"chip_smoke: the port imported {name}")
    dev = genometools_torch.resolve_device("cuda")
    kernels = {}

    with Phase("1 setup"):
        log(f"torch {torch.__version__} cuda {torch.version.cuda} "
            f"device {torch.cuda.get_device_name(0)}")
        t0 = time.perf_counter()
        _kernels.lib()
        log(f"kernels built in {_kernels.build_seconds:.2f}s (load "
            f"{time.perf_counter() - t0:.2f}s)")
        ptxas = ptxas_summary(_kernels.build_log)
        for name, per_ng in ptxas.items():
            log(f"ptxas {name} (registers, spill bytes, stack frame bytes) "
                f"by slot groups: "
                f"{dict(sorted(per_ng.items()))}")
        # K3's dback ring lives in registers: no instance keeps a frame
        frames = {ng: r[2] for ng, r in ptxas.get(
            "xdrop_full_kernel", {}).items() if r[2]}
        if "xdrop_full_kernel" not in ptxas or frames:
            raise SystemExit(f"no ptxas report of K3, or K3 keeps a stack "
                             f"frame: {frames}")
        cfg = gb.GreedyBatchConfig()
        for W in cfg.W_TIERS:
            log(f"K2r occupancy with windows up to {W}: "
                f"{gr.resident_occupancy(W)}")
        for d_tiers in (cfg.FULL_D, cfg.RESCUE[:1]):
            log(f"K1 occupancy, windows up to {cfg.FULL_W}, slot tiers "
                f"{d_tiers}: {gf.occupancy(cfg.FULL_W, d_tiers)}")
        for tiers in (xb.TIERS, xb.WIDE_TIERS):
            log(f"K3 occupancy, window tiers {tiers}: "
                f"{xf.occupancy(tiers, xb.D_BAND)}")

    at1 = Encseq.load(str(AT1MB))
    with Phase("2 kernels against plain versions"):
        rng = np.random.default_rng(7)
        t0 = time.perf_counter()
        wl = collect_extension_pool(at1, SeedExtendParams(
            extension="greedy"))
        sample = np.linspace(0, wl[1].size - 1, 131072).astype(np.int64)
        log(f"at1MB extension workload: {wl[1].size} tasks, "
            f"{time.perf_counter() - t0:.1f}s to collect; 131,072 sampled")
        # the scores and trims of the default greedy run (minidentity 80)
        p80 = SeedExtendParams(extension="greedy")
        pmh, mad = p80.greedy_params()
        pol = p80.polishing_info()
        sc = (gb._mmp128(pmh), mad, pol.match_score, pol.difference_score,
              p80.history)
        t = lambda a: torch.from_numpy(np.asarray(a)).to(dev)
        k1 = kernels["K1"] = Kernel("K1")
        cfg = gb.GreedyBatchConfig()

        rescued = 0
        for W in (256, 768, cfg.FULL_W):
            us, vs = random_flanks(rng, 4096, W)
            rescued += k1_check(k1, sc, f"random flanks up to {W}",
                                *pool_lanes(us, vs, rng.integers(
                                    10, 40, len(us)), dev))
        # the main path's own lanes: 131,072 of at1MB's extension tasks
        gpw = gpl.upload_pool(wl[0], dev)
        rescued += k1_check(k1, sc, "at1MB workload", gpw,
                            workload_lanes(wl, sample, dev))
        if rescued == 0:
            raise SystemExit("K1's rescue configuration was compared on "
                             "no lane")
        k2 = kernels["K2"] = Kernel("K2")
        cfg = gb.GreedyBatchConfig()
        for W in cfg.W_TIERS:
            # generation-0 states of long homologous flank pairs, built
            # as the chunk loop builds them; sized so that the plain
            # version takes seconds
            n = 4096 if W <= 1536 else 256
            us, vs = long_flanks(rng, n, W // 2, 3 * W)
            pool, uo, ul, vo, vl = flank_pool(us, vs)
            gp = gpl.upload_pool(pool, dev)
            su, ulen, sv, vlen = t(uo), t(ul), t(vo), t(vl)
            rv = t(np.zeros(n, bool))
            for D in cfg.D_TIERS:
                c0, state = gpl.chunk_gen0(gp, su, ulen, sv, vlen, rv,
                                          t(rng.integers(10, 40, n)),
                                          p80.history, D)
                c0t = t(c0)
                PW = gpl.chunk_windows(gp, su, ulen, sv, vlen, rv, c0t,
                                       c0t, W)
                z = lambda dt: torch.zeros(n, dtype=dt, device=dev)
                args = (PW, *state, z(torch.int32), z(torch.bool),
                        z(torch.bool), torch.zeros((n, 4), dtype=torch.int32,
                                                   device=dev),
                        (ulen - c0t).int(), (vlen - c0t).int(), z(torch.int32),
                        c0t.int())
                cnt = {}
                ms, kout = cuda_ms(lambda: gc.greedy_chunk(
                    *args, *sc, W, D, cfg.GENS))
                pms, pout = cuda_ms(lambda: gc.greedy_chunk_plain(
                    *args, *sc, W, D, cfg.GENS, counts=cnt))
                err = max(int((k.long() - q.long()).abs().max())
                          for k, q in zip(kout, pout))
                nbytes = sum(a.numel() * a.element_size() for a in args) + \
                    sum(a.numel() * a.element_size() for a in kout)
                b = k2.add(ms, pms, err, nbytes, cnt["slot_gens"] // 2)
                log(f"K2 W={W} D={D} GENS={cfg.GENS} N={n}: kernel "
                    f"{ms:.3f} ms, plain {pms:.1f} ms, {b}, max_abs_err "
                    f"{err}, done {int(kout[6].sum())}, paused "
                    f"{int(kout[8].sum())}, generations "
                    f"{int(kout[9].long().sum())}")
        k2r = kernels["K2r"] = Kernel("K2r")
        # lanes of every kind the resident kernel meets: homologous
        # flanks of 300-4,000 at 1-15 % errors, some reversed, some with
        # long exact runs (window tiers 1,536 .. 24,576), some with a
        # 24-symbol insertion, some unrelated
        n = 512
        us, vs = long_flanks(rng, n, 300, 4000)
        for i in range(0, n, 16):
            L = int(rng.integers(2000, 30000))
            u = rng.integers(0, 4, L).astype(np.uint8)
            v = u.copy()
            v[rng.integers(0, L, 1 + i % 5)] ^= 1
            us[i], vs[i] = u, v
            j = i + 1
            vs[j] = np.concatenate([us[j][:200], rng.integers(
                0, 4, 24).astype(np.uint8), us[j][200:]])
            us[i + 2] = rng.integers(0, 4, us[i + 2].size).astype(np.uint8)
        pool, uo, ul, vo, vl = flank_pool(us, vs)
        rv = rng.integers(0, 2, n).astype(bool)
        T = pool.size
        gp = gpl.upload_pool(pool, dev)
        desc = (t(np.where(rv, T - uo - ul, uo)), t(ul),
                t(np.where(rv, T - vo - vl, vo)), t(vl), t(rv),
                t(rng.integers(10, 40, n)))
        cfg = gb.GreedyBatchConfig()
        # seed_extend's default trims (maxalignedlendifference 5) keep the
        # live front within D = 16; weaker trims a user can set
        # (maxalignedlendifference 30, percmathistory 55) widen it
        pw = SeedExtendParams(extension="greedy", perc_mat_history=55,
                              maxalignedlendifference=30)
        weak = (gb._mmp128(55), 30, pw.polishing_info().match_score,
                pw.polishing_info().difference_score, pw.history)
        for W in cfg.W_TIERS:
            tiers = tuple(w for w in cfg.W_TIERS if w <= W)
            for scw in (sc, weak):
                args = (*scw, tiers, cfg.D_TIERS, cfg.GENS, cfg.MAX_CHUNKS)
                cnt = {}
                ms, kout = cuda_ms(
                    lambda: gr.greedy_resident(gp, *desc, *args))
                pms, pout = cuda_ms(lambda: gr.greedy_resident_plain(
                    gp, *desc, *args, counts=cnt), warm=False)
                err = k2r_check(kout, pout)
                b = k2r.add(ms, pms, err, lane_bytes(gp, desc, kout),
                            int(kout["slot_gens"]))
                log(f"K2r tiers {tiers} N={n} trims (percmathistory, "
                    f"maxalignedlendifference) {(scw[0], scw[1])}: kernel "
                    f"{ms:.3f} ms, plain {pms:.1f} ms, {b}, max_abs_err "
                    f"{err}; {k2r_summary(kout, cnt)}")
                by = cnt["chunks"]
                if W not in {w for w, _ in by} or scw is weak and \
                        {d for _, d in by} != set(cfg.D_TIERS):
                    raise SystemExit(f"K2r's check with tiers {tiers} ran "
                                     f"lane-chunks {by} only")
        k3 = kernels["K3"] = Kernel("K3")

        us, vs = random_flanks(rng, 4096, 512, 0.02, 0.25)
        k3_check(k3, "random flanks up to 512", *pool_lanes(us, vs, 0, dev))
        # flanks beyond the first tier, and end diagonals beyond the band
        us, vs = long_flanks(rng, 2048, 600, 3000)
        for i in range(0, len(us), 2):
            vs[i] = np.concatenate([vs[i][:int(rng.integers(50, 400))],
                                    np.full(int(rng.integers(40, 300)), 254,
                                            np.uint8)])
        k3_check(k3, "long and off-band flanks",
                 *pool_lanes(us, vs, 0, dev))
        if k3_check(k3, "at1MB workload", gpw,
                    workload_lanes(wl, sample, dev)) == 0:
            raise SystemExit("K3 took none of the at1MB lanes the "
                             "reference routes to the host")
        # ltrharvest's and tirvish's scores (2, -2, -3, -3): quantum 4
        us, vs = random_flanks(rng, 65536, 512, 0.02, 0.25)
        k3_check(k3, "random flanks up to 512 at ltrharvest's scores",
                 *pool_lanes(us, vs, 0, dev), belowscore=5, quantum=4)
        for k in kernels.values():
            log(f"{k.kid} over its shapes: kernel {k.ms:.3f} ms, plain "
                f"{k.plain_ms:.1f} ms, bound {k.bound_ms:.4f} ms (bytes "
                f"{k.bytes_ms:.4f}, operations {k.ops_ms:.4f}; bound by "
                f"{k.bound_by}) [{smi}]")

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    atexit.register(shutil.rmtree, work, True)
    with Phase("3 suffixerator CLI on at1MB"):
        write_fasta(at1, work / "at1MB.fna")
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-m", "genometools_torch",
                        "suffixerator", "-db", "at1MB.fna", "-indexname",
                        "idx", "-suf", "-lcp", "-tis"], cwd=work, env=env,
                       check=True)
        dt = time.perf_counter() - t0
        n1 = at1.total_length + 1
        log(f"suffixerator at1MB: {dt:.3f}s for {n1} suffixes "
            "(process start and CUDA init included)")
        for ext in ("suf", "lcp", "llv"):
            got = (work / f"idx.{ext}").read_bytes()
            if got != golden_bytes("at1MB", ext):
                raise SystemExit(f"at1MB .{ext} differs from the golden")
            log(f".{ext} equals the golden ({len(got)} bytes)")
        t0 = time.perf_counter()
        build_esa(at1, device=dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        log(f"build_esa at1MB: {dt:.3f}s, {n1 / dt:.0f} suffixes/s "
            f"[{smi}]")
        dbs = sorted(p.name for p in GOLDEN.iterdir() if p.is_dir())
        for db in dbs:
            esa = build_esa(Encseq.load(str(GOLDEN / db / "idx")),
                            device=dev, with_bck=True)
            write_esa(esa, str(work / f"g_{db}"), bwt=True, bck=True)
            for ext in ("suf", "lcp", "llv", "prj", "bwt", "bck"):
                if (work / f"g_{db}.{ext}").read_bytes() != \
                        golden_bytes(db, ext):
                    raise SystemExit(f"build_esa {db} .{ext} differs from "
                                     "the golden")
        log(f"build_esa on the card: .suf/.lcp/.llv/.prj/.bwt/.bck equal the "
            f"goldens for all {len(dbs)} dbs {dbs}")

    with Phase("4 suffix array at 32 Mbp"):
        host_32m = phase_32m(work, dev, smi)

    with Phase("5 extension anchors on at1MB"):
        params = SeedExtendParams(extension="greedy")
        pool, u_off, u_len, v_off, v_len, rev, k = wl
        L = np.maximum(u_len, v_len)
        edges = (0, 256, 512, 1024, 2048, 8192, 1 << 62)
        hist = {f"{a + 1}-{b}": int(((L > a) & (L <= b)).sum())
                for a, b in zip(edges, edges[1:])}
        dif = np.abs(u_len - v_len) > xb.REF_BAND
        log(f"workload: {u_off.size} tasks, k={k}; longer flank by length "
            f"{hist}; |ulen - vlen| > {xb.REF_BAND}: {int(dif.sum())}; "
            f"both: {int(((L > xb.REF_MAXLEN) & dif).sum())}")
        pmh, mad = params.greedy_params()
        pol = params.polishing_info()
        kw = dict(seedlengths=k, perc_mat_history=pmh,
                  maxalignedlendifference=mad, pol_info=pol,
                  history=params.history, device=dev)
        gb.greedy_extend_batch_pool(pool, u_off[:4096], u_len[:4096],
                                    v_off[:4096], v_len[:4096],
                                    rev[:4096], **kw)     # warm-up
        gb.reset_stats()
        t0 = time.perf_counter()
        res = gb.greedy_extend_batch_pool(pool, u_off, u_len, v_off,
                                          v_len, rev, **kw)
        dt = time.perf_counter() - t0
        total = int(res["alignedlen"].astype(np.int64).sum())
        log(f"greedy: {u_off.size} tasks in {dt:.3f}s = "
            f"{u_off.size / dt:.0f} ext/s [{smi}]; alignedlen sum "
            f"{total}; K1 lanes {gb.stats['kernel_lanes']}, host lanes "
            f"{gb.stats['host_lanes']}")
        if (u_off.size, total) != GREEDY_ANCHOR:
            raise SystemExit(f"greedy anchor mismatch: want {GREEDY_ANCHOR}")
        if gb.stats["kernel_lanes"] == 0:
            raise SystemExit("K1 finished no lane")
        m = min(u_off.size, 65536)
        idx = np.linspace(0, u_off.size - 1, m).astype(np.int64)
        sub = (u_off[idx], u_len[idx], v_off[idx], v_len[idx], rev[idx])
        xb.xdrop_extend_batch_pool(pool, *(a[:256] for a in sub), 7,
                                   device=dev)            # warm-up
        xb.reset_stats()
        t0 = time.perf_counter()
        iv, jv, sv = xb.xdrop_extend_batch_pool(pool, *sub, 7, device=dev)
        dt = time.perf_counter() - t0
        total = int(sv.sum())
        log(f"xdrop: {m} tasks in {dt:.3f}s = {m / dt:.0f} ext/s "
            f"[{smi}]; score sum {total}; {xdrop_lanes(xb)}")
        if (m, total) != XDROP_ANCHOR:
            raise SystemExit(f"xdrop anchor mismatch: want {XDROP_ANCHOR}")
        if xb.stats["kernel_lanes"] == 0:
            raise SystemExit("K3 finished no lane")

    with Phase("6 seed_extend CLI on at1MB (main path)"):
        os.chdir(work)
        for mod in (gf, xf, gr):
            mod.launches = 0
            mod.work.update(slot_gens=0, bytes=0)
        gb.reset_stats()
        xb.reset_stats()
        se_lines = {}
        for flag, ext in (("-extendgreedy", "greedy"),
                          ("-extendxdrop", "xdrop")):
            argv = ["seed_extend", "-ii", "idx", "-l", "14",
                    "-minidentity", "90", flag]
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                cli.main(argv)
            dt = time.perf_counter() - t0
            lines = buf.getvalue().splitlines()
            p = SeedExtendParams(minidentity=90, userdefinedleastlength=14,
                                 extension=ext)
            t0 = time.perf_counter()
            ref = [mm.line() for mm in seed_extend(
                Encseq.load("idx"), None, p, engine="fused")]
            dtf = time.perf_counter() - t0
            log(f"seed_extend {flag}: {len(lines)} matches in {dt:.3f}s "
                f"[{smi}] (fused host engine {dtf:.3f}s)")
            if lines != ref or not lines:
                raise SystemExit(f"seed_extend {flag} differs from the "
                                 "fused engine")
            se_lines[ext] = lines
        log(f"launches: K1 {gf.launches}, K2r {gr.launches}, K3 "
            f"{xf.launches}; greedy lanes: K1 {gb.stats['kernel_lanes']}, "
            f"K2r {gb.stats['resident_lanes']}, host "
            f"{gb.stats['host_lanes']}; xdrop lanes: {xdrop_lanes(xb)}")
        for kid, mod in (("K1", gf), ("K3", xf)):
            b = mod.work["bytes"] / HBM_BYTES_PER_S * 1e3
            o = mod.work["slot_gens"] * OPS_PER_SLOT_GEN[kid] / \
                INT32_OPS_PER_S * 1e3
            log(f"{kid} on this run's work: {mod.work['slot_gens']} "
                f"slot-generations, {mod.work['bytes']} bytes; bound "
                f"{max(b, o):.4f} ms (bytes {b:.4f}, operations {o:.4f})")
        if gf.launches == 0 or xf.launches == 0:
            raise SystemExit("the main path launched a kernel no time")
        if xb.stats["long_lanes"] == 0 or xb.stats["offband_lanes"] == 0:
            raise SystemExit("K3 took no lane longer than 512 or beyond "
                             "the band on the main path")
        launches = {"K1": gf.launches, "K3": xf.launches}

    with Phase("7a long flanks: seed_extend CLI on g4m_planted_repeats"):
        t0 = time.perf_counter()
        fasta(planted_repeats(), work / "g4m.fna", "g4m")
        log(f"g4m_planted_repeats: 2 x 2,000,000 bp, 150 repeats, "
            f"{time.perf_counter() - t0:.1f}s to generate")
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-m", "genometools_torch",
                        "suffixerator", "-db", "g4m.fna", "-indexname",
                        "g4m", "-suf", "-lcp", "-tis"], cwd=work, env=env,
                       check=True)
        log(f"suffixerator g4m: {time.perf_counter() - t0:.3f}s")
        argv = ["seed_extend", "-ii", "g4m", "-extendgreedy", "-l", "500",
                "-minidentity", "80"]
        gf.launches = 0
        gc.launches = 0
        gr.launches = 0
        gr.work.update(slot_gens=0, bytes=0)
        gb.reset_stats()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.main(argv)
        dt = time.perf_counter() - t0
        launches["K2r"] = gr.launches
        lines = buf.getvalue().splitlines()
        log(f"seed_extend g4m -extendgreedy -l 500 -minidentity 80: "
            f"{len(lines)} matches in {dt:.3f}s [{smi}]; launches K1 "
            f"{gf.launches}, K2r {gr.launches}, K2 {gc.launches}; lanes K1 {gb.stats['kernel_lanes']}, K2r "
            f"{gb.stats['resident_lanes']}, K2 {gb.stats['chunk_lanes']}, "
            f"host {gb.stats['host_lanes']}")
        b = gr.work["bytes"] / HBM_BYTES_PER_S * 1e3
        o = gr.work["slot_gens"] * OPS_PER_SLOT_GEN["K2r"] / \
            INT32_OPS_PER_S * 1e3
        log(f"K2r on this run's work: {gr.work['slot_gens']} live "
            f"slot-generations, {gr.work['bytes']} bytes; bound "
            f"{max(b, o):.4f} ms (bytes {b:.4f}, operations {o:.4f})")
        g4m = Encseq.load("g4m")
        p = SeedExtendParams(extension="greedy", userdefinedleastlength=500,
                             minidentity=80)
        t0 = time.perf_counter()
        ref = [mm.line() for mm in seed_extend(g4m, None, p,
                                               engine="fused")]
        log(f"fused host engine: {len(ref)} matches in "
            f"{time.perf_counter() - t0:.3f}s")
        if lines != ref or not lines:
            raise SystemExit("seed_extend g4m differs from the fused engine")
        if gr.launches == 0 or gc.launches:
            raise SystemExit("the long-flank path launched K2r no time, or "
                             "K2")
        if opts.profile:
            profile_run(lambda: cli.main(argv))

    with Phase("7b long flanks: resident, chunk and host routes"):
        t0 = time.perf_counter()
        pool, u_off, u_len, v_off, v_len, rev, k = \
            collect_extension_pool(g4m, p)
        idx = np.linspace(0, u_off.size - 1, 65536).astype(np.int64)
        # clip at 16,384, keeping the end nearest the seed (a reversed,
        # left flank starts its read at off + len)
        cap = 16384
        sub = []
        for off, ln in ((u_off[idx], u_len[idx]), (v_off[idx], v_len[idx])):
            cl = np.minimum(ln, cap)
            sub += [np.where(rev[idx], off + ln - cl, off), cl]
        sub.append(rev[idx])
        log(f"workload: {u_off.size} tasks, k={k}, 65,536 sampled, "
            f"flanks clipped at {cap}; {time.perf_counter() - t0:.1f}s")
        pmh, mad = p.greedy_params()
        kw = dict(seedlengths=k, perc_mat_history=pmh,
                  maxalignedlendifference=mad, pol_info=p.polishing_info(),
                  history=p.history, device=dev,
                  gp=gpl.upload_pool(pool, dev))
        gb.greedy_extend_batch_pool(pool, *(a[:1024] for a in sub),
                                    **kw)                     # warm-up
        gens = [gb.GreedyBatchConfig.GENS] + \
            [int(g) for g in opts.gens.split(",") if g]
        sums = {}
        for route in ("resident", "chunk", "host", "host", "chunk",
                      "resident"):
            for g in [None] if route == "host" else gens:
                cfg = gb.GreedyBatchConfig()
                cfg.GENS = g or cfg.GENS
                cfg.RESIDENT = route != "chunk"
                gb.reset_stats()
                gc.launches = 0
                gr.launches = 0
                t0 = time.perf_counter()
                res = gb.greedy_extend_batch_pool(
                    pool, *sub, cfg=cfg, skip_chunked=route == "host", **kw)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                total = int(res["alignedlen"].astype(np.int64).sum())
                sums.setdefault(route, set()).add(total)
                if route == "chunk" and "K2" not in launches:
                    launches["K2"] = gc.launches      # K2's path
                log(f"long-flank batch, {route} route"
                    + (f" GENS={g}" if g else "") + f": {dt:.3f}s [{smi}]; "
                    f"alignedlen sum {total}; lanes K1 "
                    f"{gb.stats['kernel_lanes']}, K2r "
                    f"{gb.stats['resident_lanes']}, K2 "
                    f"{gb.stats['chunk_lanes']}, host "
                    f"{gb.stats['host_lanes']}; launches K2r {gr.launches}, "
                    f"K2 {gc.launches}")
        if set().union(*sums.values()) != {LONG_ANCHOR}:
            raise SystemExit(f"long-flank alignedlen sums differ from "
                             f"{LONG_ANCHOR}: {sums}")
        if launches["K2"] == 0:
            raise SystemExit("the chunk route launched K2 no time")
        # K2r against its plain version at the main path's lane count
        cfg = gb.GreedyBatchConfig()
        T = pool.size
        uo, ul, vo, vl, rv = (torch.from_numpy(np.asarray(a)) for a in sub)
        desc = tuple(a.to(dev) for a in (
            torch.where(rv, T - uo - ul, uo), ul,
            torch.where(rv, T - vo - vl, vo), vl, rv,
            torch.full_like(uo, k)))
        pol = p.polishing_info()
        args = (gb._mmp128(pmh), mad, pol.match_score, pol.difference_score,
                p.history, cfg.W_TIERS, cfg.D_TIERS, cfg.GENS,
                cfg.MAX_CHUNKS)
        cnt = {}
        ms, kout = cuda_ms(lambda: gr.greedy_resident(kw["gp"], *desc,
                                                      *args))
        pms, pout = cuda_ms(lambda: gr.greedy_resident_plain(
            kw["gp"], *desc, *args, counts=cnt), warm=False)
        err = k2r_check(kout, pout)
        b = kernels["K2r"].add(ms, pms, err, lane_bytes(kw["gp"], desc, kout),
                               int(kout["slot_gens"]))
        log(f"K2r on the 65,536 tasks: kernel {ms:.3f} ms, plain "
            f"{pms:.1f} ms, {b}, max_abs_err {err}; "
            f"{k2r_summary(kout, cnt)} [{smi}]")

    with Phase("8 suffixerator_e2e at at1MB and 32 Mbp"):
        phase_e2e(work, dev, smi, host_32m)

    with Phase("9 suffixerator -parts and -memlimit on at1MB"):
        phase_parts(work, env)

    with Phase("10 wide: 2^30 + 2^20 symbols on the card"):
        phase_wide(dev, smi)

    with Phase("11 seed_extend -parts 3 grid on at1MB"):
        grid_lines = phase_grid(cli, dev, se_lines, smi)

    with Phase("12 repfind on at1MB and g4m"):
        phase_repfind(cli, dev, g4m, smi, kernels["K3"])

    with Phase("13 tallymer on at1MB and 32 Mbp"):
        phase_tallymer(cli, work, dev, smi)

    with Phase("14 readjoiner on g4m reads at 20x"):
        phase_readjoiner(cli, work, dev, smi)

    with Phase("15 genomediff, shulengthdist, uniquesub, matstat"):
        phase_querytools(cli, work, smi)

    with Phase("16 ltrharvest, tirvish, ltrclustering at 32 Mbp"):
        pt = phase_ltr(cli, work, dev, smi)

    with Phase("17 packedindex, tagerator, prebwt, mergeesa, sain"):
        phase_packed(cli, work, dev, smi)

    with Phase("18 mesh: the multi-device layer on 8 shards of the card"):
        for kid, n in phase_mesh(cli, work, dev, smi, grid_lines).items():
            launches[kid] += n

    with Phase("19 the annotator's pipeline: gff3, ltrdigest, stat, "
               "gff3validator, extractfeat"):
        phase_anno(cli, work, dev, smi, *pt)

    src = {"K1": ("greedy_full", "genometools_torch/csrc/greedy_full.cu",
                  "genometools_tpu/ops/greedy_pallas.py:531"),
           "K2": ("greedy_chunk", "genometools_torch/csrc/greedy_chunk.cu",
                  "genometools_tpu/ops/greedy_pallas.py:456"),
           "K2r": ("greedy_resident",
                   "genometools_torch/csrc/greedy_resident.cu",
                   "genometools_tpu/ops/greedy_pallas.py:456"),
           "K3": ("xdrop_full", "genometools_torch/csrc/xdrop_full.cu",
                  "genometools_tpu/ops/xdrop_pallas.py:301")}
    log(json.dumps({"kernels": [
        {"name": f"{kid} {src[kid][0]}", "route": "cuda",
         "source": src[kid][1], "replaces": src[kid][2],
         "launches": launches[kid], "max_abs_err": kernels[kid].err,
         "ms": kernels[kid].ms, "plain_ms": kernels[kid].plain_ms,
         "bound_ms": kernels[kid].bound_ms,
         "bound_by": kernels[kid].bound_by,
         # no single PyTorch call computes a greedy or xdrop front
         "library_ms": None}
        for kid in ("K1", "K2", "K2r", "K3")]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
