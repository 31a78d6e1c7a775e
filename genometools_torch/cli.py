"""gt-style command line for the port: ``python -m genometools_torch``.

The flags are copies of the reference's parsers
(``genometools_tpu/cli.py`` ``_add_suffixerator``, ``_add_seed_extend``,
``_add_repfind``, ``_add_tallymer``, ``_add_readjoiner``,
``_add_encseq2spm``, ``_add_genomediff``, ``_add_shulengthdist``,
``_add_uniquesub``, ``_add_matstat``, ``_add_ltrharvest``,
``_add_tirvish``, ``_add_ltrclustering``, ``_add_packedindex``,
``_add_mkfmindex``, ``_add_prebwt``, ``_add_tagerator``,
``_add_mergeesa``, ``_add_sain`` and ``_add_ltrdigest``), so the tools
accept the same command lines. ``-device {cuda,cpu}`` (default cuda)
picks where the device work runs; asking for cuda without a card fails,
also for the tools whose work is host code. Flags the port does not
support yet raise instead of being ignored.

The GFF3 annotation tools are copies of the reference's too
(``_add_gff3``, ``_add_stat``, ``_add_convert_anno``, ``_add_select``,
``_add_feat_streams``, ``_add_scriptfilter``, ``_add_speck``,
``_add_csa``, ``_add_eval``, ``_add_cds``, ``_add_splicesiteinfo``,
``_add_orffinder``, ``_add_regioncov``, ``_add_seqids``,
``_add_loccheck``, ``_add_gff3validator``, ``_add_inlineseq_split``,
``_add_inlineseq_add``, ``_add_merge``, ``_add_uniq``,
``_add_interfeat``, ``_add_extractfeat``, ``_add_mkfeatureindex``,
``_add_featureindex`` and ``_add_snpper``, with their messages and
exit codes). They run on the host, as in the reference, and take no
``-device``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _add_suffixerator(sub):
    p = sub.add_parser("suffixerator", help="compute enhanced suffix array")
    p.add_argument("-db", nargs="+", required=True, help="input sequence files")
    p.add_argument("-indexname", default=None)
    p.add_argument("-suf", action="store_true", help="output suffix table")
    p.add_argument("-lcp", action="store_true", help="output lcp table")
    p.add_argument("-tis", action="store_true", help="output encoded sequence")
    p.add_argument("-bwt", action="store_true", help="output BWT table")
    p.add_argument("-bck", action="store_true", help="output bucket table")
    p.add_argument("-pl", type=int, nargs="?", const=0, default=0,
                   help="prefix length (0 = auto)")
    p.add_argument("-dna", action="store_true")
    p.add_argument("-protein", action="store_true")
    p.add_argument("-mirrored", action="store_true")
    p.add_argument("-ssp", action="store_true")
    p.add_argument("-des", action="store_true")
    p.add_argument("-sds", action="store_true",
                   help="output sequence description separator table")
    p.add_argument("-md5", action="store_true")
    p.add_argument("-dir", default="fwd", choices=["fwd", "rev", "cpl", "rcl"])
    p.add_argument("-parts", type=int, default=1,
                   help="build the suffix table in N memory-bounded parts")
    p.add_argument("-memlimit", default=None,
                   help="memory budget for part planning, e.g. 512MB")
    p.add_argument("-dist", type=int, default=None, metavar="N",
                   help="route the suffix sort over an N-device mesh "
                        "(0 = off; default: all attached devices; at "
                        "most the attached cards, a power of two)")
    p.add_argument("-showtime", action="store_true")
    p.add_argument("-v", action="store_true", help="verbose logger")
    p.add_argument("--cpu", action="store_true")
    return p


def _add_seed_extend(sub):
    p = sub.add_parser("seed_extend", help="seed and extend matching")
    p.add_argument("-ii", required=True)
    p.add_argument("-qii", default=None, help="query index (default: self)")
    p.add_argument("-l", type=int, default=None,
                   help="minimum alignment len (default: mincoverage)")
    p.add_argument("-estim", choices=["ANI", "JKD"], default=None)
    p.add_argument("-snd_pass", action="store_true")  # implied by -estim
    p.add_argument("-bias-parameters", dest="bias_parameters",
                   action="store_true")
    p.add_argument("-delta-filter", dest="delta_filter",
                   action="store_true")
    p.add_argument("-noinseqseeds", action="store_true")  # implied
    p.add_argument("-histogram", default=None)            # accepted, no-op
    p.add_argument("-cam", default=None)                  # accepted, no-op
    p.add_argument("-parts", type=int, default=1)
    p.add_argument("-pick", default=None, help="run one grid cell: a,b")
    p.add_argument("-diagbandwidth", type=int, default=6)
    p.add_argument("-seedlength", type=int, default=0)
    p.add_argument("-spacedseed", type=int, nargs="?", const=0,
                   default=None,
                   help="use tuned spaced seeds (optional weight; span "
                        "= seedlength)")
    p.add_argument("-minidentity", type=int, default=80)
    p.add_argument("-extendxdrop", type=int, nargs="?", const=97, default=0)
    p.add_argument("-extendgreedy", type=int, nargs="?", const=97, default=0)
    p.add_argument("-maxfreq", type=int, default=None)
    p.add_argument("-no-reverse", dest="no_reverse", action="store_true")
    p.add_argument("-history", type=int, default=64)
    p.add_argument("-percmathistory", type=int, default=None)
    p.add_argument("-maxalilendiff", type=int, default=None)
    p.add_argument("-outfmt", nargs="+", default=None)
    p.add_argument("-maxmat", action="store_true")
    p.add_argument("-dist", type=int, nargs="?", const=0, default=None,
                   metavar="N",
                   help="fan the -parts grid cells out over N mesh "
                        "devices (0 = all attached devices)")
    p.add_argument("--cpu", action="store_true")
    return p


def _add_repfind(sub):
    p = sub.add_parser("repfind", help="maximal exact repeats")
    p.add_argument("-l", type=int, required=True, help="minimum length")
    p.add_argument("-ii", required=True, help="input index")
    p.add_argument("-f", action="store_true", help="forward matches (default)")
    p.add_argument("-r", action="store_true", help="reverse matches")
    p.add_argument("-p", action="store_true", help="reverse-strand matches")
    p.add_argument("-extendgreedy", nargs="?", const=100, default=False,
                   type=int, help="greedy-extend maximal pairs")
    p.add_argument("-extendxdrop", nargs="?", const=97, default=False,
                   type=int, help="xdrop-extend maximal pairs")
    p.add_argument("-minidentity", type=int, default=80)
    p.add_argument("-maxalilendiff", type=int, default=30)
    p.add_argument("-percmathistory", type=int, default=55)
    p.add_argument("-q", nargs="+", default=None,
                   help="query files: report maximal db matches of "
                        "query substrings")
    p.add_argument("--cpu", action="store_true")
    return p


def _refuse(args, flags) -> None:
    for flag, unsupported in flags:
        if unsupported(args):
            raise SystemExit(f"genometools_torch: option {flag} is not "
                             "supported by the port yet")


def _common_refusals(args):
    _refuse(args, [("--cpu (use -device cpu)",
                    lambda a: getattr(a, "cpu", False))])


def cmd_suffixerator(args):
    from .core.encseq import READMODES, Encseq
    from .device import resolve_device
    from .index.esa import build_esa, dist_mesh, write_esa
    from .utils.options import Logger, Showtime
    _common_refusals(args)
    resolve_device(args.device)       # raises on the host -parts route too
    st = Showtime(args.showtime)
    log = Logger(getattr(args, "v", False))
    enc = Encseq.from_files(args.db)
    log.log(f"indexname=\"{args.indexname or args.db[0]}\"")
    log.log(f"prefixlength={args.pl if args.pl else 'automatic'}")
    for i, f in enumerate(args.db):
        log.log(f"inputfile[{i}]={f}")
    st.phase("reading the input sequences")
    if args.mirrored:
        enc = enc.mirror()
    rm = READMODES[args.dir]
    indexname = args.indexname or args.db[0]
    if args.parts > 1 or args.memlimit:
        # memory-bounded code-range parts on the host (int64 positions;
        # ref: -parts / -memlimit, src/match/sfx-partssuf.c:172); streams
        # .suf/.lcp/.llv/.bwt one part at a time for every readmode
        from .index.parts import stream_esa_parts
        n1 = enc.total_length + 1
        if args.memlimit:
            budget = max(1, _parse_memlimit(args.memlimit) // 16)
        else:
            budget = -(-n1 // args.parts)
        if args.tis:
            enc.save(indexname)
        nparts = stream_esa_parts(
            enc, rm, indexname, budget, suf=args.suf, lcp=args.lcp,
            bwt=args.bwt, bck=args.bck, prefixlength=args.pl or None)
        if args.showtime:
            print(f"# parts={nparts} budget={budget}", file=sys.stderr)
        return 0
    esa = build_esa(enc, rm, with_lcp=args.lcp,
                    prefixlength=args.pl or None, with_bck=args.bck,
                    device=args.device,
                    mesh=dist_mesh(args.dist, args.device))
    st.phase("sorting the suffixes")
    if args.tis:
        enc.save(indexname)
    write_esa(esa, indexname, suf=args.suf, lcp=args.lcp, bwt=args.bwt,
              bck=args.bck)
    st.phase("writing the output tables")
    if args.showtime:
        print(f"# indexed {enc.total_length} symbols, "
              f"{enc.num_sequences} sequences", file=sys.stderr)
        st.overall()
    return 0


def _parse_memlimit(s: str) -> int:
    s = s.strip().upper()
    for suf, mult in (("GB", 1 << 30), ("MB", 1 << 20), ("KB", 1 << 10)):
        if s.endswith(suf):
            return int(float(s[:-2]) * mult)
    return int(s)


def cmd_seed_extend(args):
    from .core.encseq import Encseq
    from .device import resolve_device
    from .match.seed_extend import SeedExtendParams, _seq_codes, seed_extend
    _common_refusals(args)
    dev = resolve_device(args.device)   # the -estim/-maxmat host routes too
    aenc = Encseq.load(args.ii)
    benc = Encseq.load(args.qii) if args.qii else None
    p = SeedExtendParams(
        seedlength=args.seedlength or None,
        minidentity=args.minidentity,
        sensitivity=args.extendxdrop or args.extendgreedy or 97,
        userdefinedleastlength=args.l or 0,
        # greedy is the default extension (ref: gt_seed_extend.c:833)
        extension="xdrop" if args.extendxdrop else "greedy",
        maxfreq=args.maxfreq,
        reverse=not args.no_reverse,
        history=args.history,
        logdiagbandwidth=args.diagbandwidth,
        perc_mat_history=args.percmathistory,
        maxalignedlendifference=args.maxalilendiff,
        spacedseedweight=args.spacedseed,
        parts=args.parts,
        pick=tuple(int(x) for x in args.pick.split(","))
        if args.pick else None)
    if args.pick and args.parts <= 1:
        raise SystemExit('option "-pick" requires option "-parts"')
    if args.estim:
        # host code over the host extension route, as in the reference
        from .match.estim import seed_extend_estim
        sys.stdout.write(seed_extend_estim(
            aenc, benc, p, mode=args.estim,
            delta_filter=args.delta_filter,
            bias_parameters=args.bias_parameters,
            aname=args.ii, bname=args.qii or args.ii))
        return 0
    if args.maxmat:
        from .match.seed_extend import maximal_exact_matches
        k = args.seedlength or min(32, args.l or 20)
        sys.stdout.write("".join(
            f"{m.dblen:8d}{m.dbseqnum:10d}{m.dbstart + 1:10d}  "
            f"{m.direction}{m.queryseqnum:10d}{m.querystart + 1:10d}\n"
            for m in maximal_exact_matches(aenc, benc, k, args.l)))
        return 0
    outfmt = args.outfmt or []
    width = 60
    seed_in_algn = "seed_in_algn" in outfmt
    show_alignment = any(o == "alignment" or o.startswith("alignment=")
                         for o in outfmt)
    for o in outfmt:
        if o.startswith("alignment="):
            width = int(o.split("=")[1])
    if show_alignment:
        from .match.seedext_display import format_alignment, seeded_alignment
        pol = p.polishing_info()
        pmh, mad = p.greedy_params()
    col_fmts = []
    for o in outfmt:
        if o == "seed":
            col_fmts += ["seed.len", "seed.s", "seed.q"]
        elif o in ("cigar", "cigarX", "evalue", "bitscore", "s.seqlen",
                   "q.seqlen", "subjectid", "queryid", "seed.len",
                   "seed.s", "seed.q"):
            col_fmts.append(o)
    show_failed = "failed_seed" in outfmt
    ka = None
    if "evalue" in col_fmts or "bitscore" in col_fmts:
        from .match.karlin_altschul import KarlinAltschulStat
        ka = KarlinAltschulStat.new_gapped(aenc.total_length,
                                           aenc.num_sequences)
    if col_fmts:
        from .match.seedext_display import match_extra_columns
    events = [] if show_failed else None
    if args.dist is not None and args.parts > 1:
        # the grid's cells on the lanes of a mesh (N cards, 0 = all),
        # the output in grid-cell order
        from .parallel.dist_seed_grid import distributed_seed_extend
        from .parallel.mesh import make_mesh
        result = distributed_seed_extend(
            aenc, benc, p, events=events,
            devices=make_mesh(args.dist or None, dev))
    else:
        result = seed_extend(aenc, benc, p, events=events, device=dev)
    stream = events if show_failed else [("match", m) for m in result]
    out = []
    for ev in stream:
        if ev[0] == "failed":
            _, k, aseq, apos, d, bseq, bpos = ev
            out.append(f"# failed_seed: {k} {aseq} {apos} {d} {bseq} "
                       f"{bpos}\n")
            continue
        m = ev[1]
        if col_fmts:
            extra = match_extra_columns(m, aenc, benc or aenc, p, col_fmts,
                                        ka)
            parts = m.line().split()
            if "subjectid" in col_fmts:
                parts[1] = extra[col_fmts.index("subjectid")]
            if "queryid" in col_fmts:
                parts[5] = extra[col_fmts.index("queryid")]
            rest = [x for o, x in zip(col_fmts, extra)
                    if o not in ("subjectid", "queryid")]
            out.append(" ".join(parts + rest) + "\n")
        else:
            out.append(m.line() + "\n")
        if show_alignment and m.direction == "F":
            useq = _seq_codes(aenc, m.dbseqnum, False)
            vseq = _seq_codes(benc or aenc, m.queryseqnum, False)
            ops, uo, ul, vo, vl, useedoff = seeded_alignment(
                useq, vseq, m.dbstart, m.dblen, m.querystart, m.querylen,
                m.db_seedpos, m.query_seedpos, m.seedlen, pol, pmh, mad)
            out.append(format_alignment(
                ops, useq[uo:uo + ul], vseq[vo:vo + vl], uo, vo,
                width=width, useedoffset=useedoff, seedlen=m.seedlen,
                seed_in_algn=seed_in_algn))
    sys.stdout.write("".join(out))
    return 0


def cmd_repfind(args):
    from .core.encseq import Encseq
    from .device import resolve_device
    from .index.esa import load_esa
    from .match.repfind import (repfind_palindromic, repfind_reverse,
                                repfind_self, write_match_lines)
    _common_refusals(args)
    dev = resolve_device(args.device)
    enc = Encseq.load(args.ii)
    if args.q:
        # query matching (ref: gt_repfind.c:620 over
        # gt_querysubstringmatchiterator, esa-mmsearch.c): one exact
        # match record per db occurrence of each query position's
        # longest db-matching prefix >= -l
        from .match.querysearch import query_substring_matches
        esa = load_esa(args.ii, encseq=enc)
        q = Encseq.from_files(args.q)
        out = []
        for dbpos, qpos, length in query_substring_matches(esa, q, args.l):
            dbseq = int(enc.seqnum_of_pos(dbpos))
            dbrel = dbpos - int(enc.seq_startpos(dbseq))
            qseq = int(q.seqnum_of_pos(qpos))
            qrel = qpos - int(q.seq_startpos(qseq))
            out.append(f"{length} {dbseq} {dbrel} F {length} {qseq} "
                       f"{qrel}\n")
        sys.stdout.write("".join(out))
        return 0
    if args.extendgreedy is not False or args.extendxdrop is not False:
        from .match.repfind import repfind_extend
        # the port takes greedy's pruning from -percmathistory and
        # -maxalilendiff alone
        _refuse(args, [("-extendgreedy with a sensitivity other than 100",
                        lambda a: a.extendgreedy not in (False, 100))])
        esa = load_esa(args.ii, encseq=enc)
        kind = "greedy" if args.extendgreedy is not False else "xdrop"
        sys.stdout.write("".join(
            m.line() + "\n" for m in repfind_extend(
                enc, args.l, kind, minidentity=args.minidentity,
                maxalignedlendifference=args.maxalilendiff,
                perc_mat_history=args.percmathistory, esa=esa,
                device=dev, sensitivity=args.extendxdrop or 97)))
        return 0
    if args.f or not (args.r or args.p):
        # the native walk fed straight from the index files
        from .match.maxpairs import enumerate_maxpairs_files
        from .match.repfind import _format_rows
        mp = enumerate_maxpairs_files(args.ii, enc, args.l)
        if mp is not None:
            write_match_lines(
                sys.stdout,
                _format_rows(enc, mp.pos1, mp.pos2, mp.length, "F"), "F")
        else:
            esa = load_esa(args.ii, encseq=enc, signed_suftab="i32")
            write_match_lines(sys.stdout,
                              repfind_self(enc, args.l, esa=esa), "F")
    if args.r or args.p:
        esa = load_esa(args.ii, encseq=enc)
    if args.r:
        write_match_lines(sys.stdout, repfind_reverse(
            enc, args.l, esa=esa, device=dev), "R")
    if args.p:
        write_match_lines(sys.stdout, repfind_palindromic(
            enc, args.l, esa=esa, device=dev), "P")
    return 0


def cmd_tallymer(args):
    from .core.encseq import Encseq
    from .device import resolve_device
    from .index.esa import load_esa, read_prj
    from .match import tallymer
    _common_refusals(args)
    resolve_device(args.device)        # host code, as in the reference
    if args.sub == "mkindex":
        mi = None
        try:
            rm = int(read_prj(args.esa).get("readmode", 0))
        except OSError:
            rm = None
        if rm == 0:
            # forward readmode, DNA codes: ESA-free native counting
            # (identical bytes, no .suf/.lcp load)
            enc_t = Encseq.load(args.esa)
            if enc_t.alphabet.num_chars == 4:
                mi = tallymer.mkindex_direct(enc_t, args.mersize,
                                             minocc=args.minocc,
                                             maxocc=args.maxocc)
        if mi is None:
            esa = load_esa(args.esa, need_lcp="small", signed_suftab=False)
            mi = tallymer.mkindex(esa, args.mersize, minocc=args.minocc,
                                  maxocc=args.maxocc)
        if args.indexname:
            mi.save(args.indexname)
        else:
            dist = tallymer.occurrence_distribution(mi)
            for count in sorted(dist):
                print(f"{count} {dist[count]}")
        return 0
    mi = tallymer.MerIndex.load(args.tyr)
    q = Encseq.from_files(args.q)
    res = tallymer.search(mi, q, forward="f" in args.strand,
                          reverse="p" in args.strand)
    show = [f for tok in args.output for f in tok.split(",")]
    if show in (["qseqnum", "qpos", "counts"], ["qpos", "counts"]) \
            and res.counts.size > (1 << 14):
        try:
            fd = sys.stdout.fileno()
        except Exception:
            fd = None
        if fd is not None:
            from .core.native import tyr_write_lines_native
            sys.stdout.flush()
            if tyr_write_lines_native(res.qseqnum, res.qpos, res.counts,
                                      res.strand, f"/dev/fd/{fd}",
                                      show[0] == "qseqnum", True):
                return 0
    sys.stdout.write("".join(
        line + "\n" for line in _tallymer_lines(res, show, mi.mersize)))
    return 0


def _tallymer_lines(res, show, mersize: int) -> list[str]:
    """`tallymer search` output lines: the fields of `show` per hit,
    tab-separated as gt writes them."""
    qs, qp = res.qseqnum.tolist(), res.qpos.tolist()
    ct, st = res.counts.tolist(), res.strand.tolist()
    lines = []
    for i in range(len(ct)):
        fields = []
        for f in show:
            if f == "qseqnum":
                fields.append(str(qs[i]))
            elif f == "qpos":
                fields.append(chr(st[i]) + str(qp[i]))
            elif f == "counts":
                fields.append(str(ct[i]))
            elif f == "sequence":
                fields.append(_code_to_seq(int(res.codes[i]), mersize))
        lines.append("\t".join(fields))
    return lines


def _code_to_seq(code: int, k: int) -> str:
    chars = "acgt"
    return "".join(chars[(code >> (2 * (k - 1 - i))) & 3] for i in range(k))


def _add_tallymer(sub):
    p = sub.add_parser("tallymer", help="k-mer counting and search")
    sp = p.add_subparsers(dest="sub", required=True)
    pm = sp.add_parser("mkindex")
    pm.add_argument("-esa", required=True, help="enhanced suffix array index")
    pm.add_argument("-mersize", type=int, default=20)
    pm.add_argument("-minocc", type=int, default=1)
    pm.add_argument("-maxocc", type=int, default=None)
    pm.add_argument("-indexname", default=None)
    pm.add_argument("--cpu", action="store_true")
    ps = sp.add_parser("search")
    ps.add_argument("-tyr", required=True, help="tallymer index")
    ps.add_argument("-q", nargs="+", required=True, help="query files")
    ps.add_argument("-strand", default="f",
                    help="f=forward p=reverse ('fp' both); gt default f")
    ps.add_argument("-output", nargs="+", default=["qseqnum", "qpos",
                                                   "counts"])
    ps.add_argument("--cpu", action="store_true")
    return pm, ps


def cmd_readjoiner(args):
    from .assembly import readjoiner as rj
    from .device import resolve_device
    dev = resolve_device(args.device)
    if args.sub == "prefilter":
        rs = rj.ReadSet.from_files(
            args.db, maxlow=args.maxlow, lowqual=args.lowqual,
            phredbase=64 if args.phred64 else 33)
        contained = rj.find_contained(rs, device=dev)
        keepmask = ~contained
        posmask = np.repeat(keepmask, rs.lens)
        np.savez(args.readset + ".reads", blob=rs.blob[posmask],
                 lens=rs.lens[keepmask])
        print(f"# {rs.num_reads} reads, {int(contained.sum())} contained, "
              f"{int(keepmask.sum())} kept", file=sys.stderr)
    elif args.sub == "overlap":
        rs = _load_readset(args.readset)
        spms = rj.find_spms(rs, args.l, singlestrand=args.singlestrand)
        if args.spmformat in ("bin32", "bin64"):
            spms.write_bin(args.readset + ".spm",
                           bits=32 if args.spmformat == "bin32" else 64)
        else:
            with open(args.readset + ".spm", "w") as f:
                for line in spms.lines():
                    f.write(line + "\n")
        print(f"# {spms.length.size} SPMs", file=sys.stderr)
    elif args.sub == "cgraph":
        rs = _load_readset(args.readset)
        if os.path.exists(args.readset + ".spm"):
            spms = rj.SpmList.read(args.readset + ".spm")
        else:
            spms = rj.find_spms(rs, args.l)
        cg = rj.ContigsGraph.from_assembly(rs, spms,
                                           min_depth=args.depthcutoff)
        merges = cg.simplify()
        with open(args.readset + ".cgraph.dot", "w") as f:
            f.write(cg.show_dot())
        with open(args.readset + ".paths", "w") as f:
            for line in cg.output_paths():
                f.write(line + "\n")
        print(f"# cgraph: {len(cg.seqs) - len(cg.deleted)} contigs after "
              f"{merges} junction merges", file=sys.stderr)
    elif args.sub == "assembly":
        rs = _load_readset(args.readset)
        if os.path.exists(args.readset + ".spm"):
            spms = rj.SpmList.read(args.readset + ".spm", args.l)
        else:
            spms = rj.find_spms(rs, args.l)
        g = rj.StringGraph.from_spms(rs, spms)
        g.reduce_self()
        g.reduce_transitive()
        contigs = g.spell_contigs(min_depth=args.depthcutoff,
                                  min_length=args.lengthcutoff)
        with open(args.readset + ".contigs.fas", "w") as f:
            for i, (seq, depth, desc) in enumerate(contigs):
                f.write(f">contig_{i} length={len(seq)} depth={depth} "
                        f"{desc}\n{seq}\n")
        print(f"# {len(contigs)} contigs", file=sys.stderr)
    elif args.sub == "spmtest":
        rs = rj.ReadSet.from_files(args.db)
        spms = rj.find_spms(rs, args.l, singlestrand=args.singlestrand)
        for line in spms.lines():
            print(line)
    return 0


def _load_readset(name):
    from .assembly.readjoiner import ReadSet
    d = np.load(name + ".reads.npz")
    if "blob" in d.files:
        return ReadSet(blob=d["blob"], lens=d["lens"])
    return ReadSet([d[k] for k in sorted(d.files,
                                         key=lambda s: int(s[1:]))])


def _add_readjoiner(sub):
    p = sub.add_parser("readjoiner", help="string graph assembler")
    sp = p.add_subparsers(dest="sub", required=True)
    pp_ = sp.add_parser("prefilter")
    pp_.add_argument("-db", nargs="+", required=True)
    pp_.add_argument("-readset", default="reads")
    pp_.add_argument("-maxlow", type=int, default=None,
                     help="max low-quality positions per FASTQ read")
    pp_.add_argument("-lowqual", type=int, default=0,
                     help="phred value considered low")
    pp_.add_argument("-phred64", action="store_true")
    po = sp.add_parser("overlap")
    po.add_argument("-readset", default="reads")
    po.add_argument("-l", type=int, default=45)
    po.add_argument("-singlestrand", action="store_true")
    po.add_argument("-spmformat", default="bin32",
                    choices=["text", "bin32", "bin64"])
    pc = sp.add_parser("cgraph")
    pc.add_argument("-readset", default="reads")
    pc.add_argument("-l", type=int, default=45)
    pc.add_argument("-depthcutoff", type=int, default=1)
    pa = sp.add_parser("assembly")
    pa.add_argument("-readset", default="reads")
    pa.add_argument("-l", type=int, default=45)
    pa.add_argument("-depthcutoff", type=int, default=3)
    pa.add_argument("-lengthcutoff", type=int, default=100)
    ps = sp.add_parser("spmtest")
    ps.add_argument("-db", nargs="+", required=True)
    ps.add_argument("-l", type=int, default=3)
    ps.add_argument("-singlestrand", action="store_true")
    return pp_, po, pc, pa, ps


def cmd_encseq2spm(args):
    """ref: src/tools/gt_encseq2spm.c — suffix-prefix matches of an
    encoded read set (the firstcodes engine as a standalone tool)."""
    from .assembly.readjoiner import ReadSet, find_spms
    from .core.encseq import Encseq
    from .device import resolve_device
    _common_refusals(args)
    resolve_device(args.device)
    enc = Encseq.load(args.ii)
    # the reads are the sequences: the codes without their separators,
    # in one pass (a position lookup per read is quadratic in the reads)
    rs = ReadSet(blob=np.delete(enc.codes, enc.ssp),
                 lens=enc.seq_length(np.arange(enc.num_sequences)))
    spm = find_spms(rs, args.l, singlestrand=args.singlestrand)
    if args.spm == "show":
        for line in spm.lines():
            print(line)
    else:
        print(f"number of suffix-prefix matches: {spm.length.size}")
    return 0


def _add_encseq2spm(sub):
    p = sub.add_parser("encseq2spm", help="compute suffix-prefix matches")
    p.add_argument("-ii", required=True)
    p.add_argument("-l", type=int, required=True, help="minimum SPM length")
    p.add_argument("-spm", default="count", choices=["count", "show"])
    p.add_argument("-singlestrand", action="store_true")
    p.add_argument("--cpu", action="store_true")
    return p


def cmd_genomediff(args):
    from .core.encseq import Encseq
    from .device import resolve_device
    from .match.genomediff import genomediff
    _common_refusals(args)
    dev = resolve_device(args.device)
    genomes = [Encseq.from_files([f]) for f in args.files]
    sums, kr = genomediff(genomes, device=dev)
    names = [os.path.basename(f).split(".")[0] for f in args.files]
    width = max(len(n) for n in names) + 1
    # shulen-sum matrix then Kr matrix (ref: genomediff output,
    # testdata/genomediff/*-kr.out)
    print(len(genomes))
    for i, name in enumerate(names):
        print(f"{name:<{width}}" + " ".join(
            str(int(sums[i, j])) for j in range(len(genomes))) + " ")
    print(len(genomes))
    for i, name in enumerate(names):
        print(f"{name:<{width}}" + " ".join(
            f"{kr[i, j]:.6f}" for j in range(len(genomes))) + " ")
    return 0


def _add_genomediff(sub):
    p = sub.add_parser("genomediff", help="pairwise Kr divergence")
    p.add_argument("files", nargs="+")
    p.add_argument("--cpu", action="store_true")
    return p


def cmd_shulengthdist(args):
    """ref: src/tools/gt_shulen.c — without -q: the pairwise
    sum-of-shulen matrix over the index's units (print format of
    esa-shulen.c:341 shulengthdist_print); with -q: one total of the
    query files against the index (gt_esa2shulengthqueryfiles)."""
    from .core.encseq import Encseq
    from .device import resolve_device
    from .match.genomediff import shulen_sums
    _common_refusals(args)
    dev = resolve_device(args.device)
    enc = Encseq.load(args.ii)
    if args.q:
        from .core.seqio import read_seqfiles
        qs = [enc.alphabet.encode(seq) for seq in read_seqfiles(args.q).seqs]
        sums = shulen_sums([enc.codes] + qs, [0], enc.alphabet, dev)
        print(int(sums[1:, 0].sum()))
        return 0
    # units: one per sequence (the multi-file index maps each input to
    # one unit; our encseq keeps per-sequence units)
    units = [enc.codes[int(enc.seq_startpos(i)):
                       int(enc.seq_endpos(i)) + 1]
             for i in range(enc.num_sequences)]
    n = len(units)
    dist = shulen_sums(units, range(n), enc.alphabet, dev)
    print("# sum of shulen")
    print(n)
    for idx2 in range(n):
        row = "".join(
            (f"{dist[idx1, idx2]}\t" if idx1 != idx2 else "0.000000\t")
            for idx1 in range(n))
        print(f"{idx2}\t{row}")
    return 0


def _add_shulengthdist(sub):
    p = sub.add_parser("shulengthdist",
                       help="pairwise sum of shortest unique substrings")
    p.add_argument("-ii", required=True)
    p.add_argument("-q", nargs="+", default=None)
    p.add_argument("-scan", action="store_true")
    p.add_argument("--cpu", action="store_true")
    return p


def cmd_uniquesub(args):
    from .core.encseq import Encseq
    from .device import resolve_device
    from .index.esa import load_esa
    from .match.querysearch import minimum_unique_substrings
    _common_refusals(args)
    resolve_device(args.device)
    esa = load_esa(args.esa)
    q = Encseq.from_files(args.query)
    out = []
    for qpos, length in minimum_unique_substrings(
            esa, q, args.min, args.max):
        line = f"{qpos} {length}"
        if args.output_sequence:
            line += " " + q.alphabet.decode(q.codes[qpos:qpos + length])
        out.append(line + "\n")
    sys.stdout.write("".join(out))
    return 0


def _add_uniquesub(sub):
    p = sub.add_parser("uniquesub", help="minimum unique substrings")
    p.add_argument("-esa", required=True)
    p.add_argument("-query", nargs="+", required=True)
    p.add_argument("-min", type=int, default=1)
    p.add_argument("-max", type=int, default=None)
    p.add_argument("-output-sequence", dest="output_sequence",
                   action="store_true")
    p.add_argument("--cpu", action="store_true")
    return p


def cmd_matstat(args):
    from .core.encseq import Encseq
    from .device import resolve_device
    from .index.esa import load_esa
    from .match.querysearch import matching_statistics
    _common_refusals(args)
    resolve_device(args.device)
    esa = load_esa(args.esa)
    q = Encseq.from_files(args.query)
    ms = matching_statistics(esa, q)
    sys.stdout.write("".join(f"{qpos} {int(v)}\n"
                             for qpos, v in enumerate(ms.tolist())))
    return 0


def _add_matstat(sub):
    p = sub.add_parser("matstat", help="matching statistics")
    p.add_argument("-esa", required=True)
    p.add_argument("-query", nargs="+", required=True)
    p.add_argument("--cpu", action="store_true")
    return p


# ---------------------------------------------------------------------------
# ltrharvest / tirvish / ltrclustering
# ---------------------------------------------------------------------------

def cmd_ltrharvest(args):
    from .anno.gff3 import gff3_to_string
    from .core.encseq import Encseq
    from .device import resolve_device
    from .ltr.ltrharvest import (LTRHarvestParams, fasta_out_entries,
                                 gff3_nodes, ltrharvest, tabout_lines)
    _common_refusals(args)
    dev = resolve_device(args.device)
    enc = Encseq.load(args.index)
    params = LTRHarvestParams(
        seedlength=args.seed, minlenltr=args.minlenltr,
        maxlenltr=args.maxlenltr, mindistltr=args.mindistltr,
        maxdistltr=args.maxdistltr, similar=args.similar,
        mintsd=args.mintsd, with_tsd=args.mintsd > 0)
    preds = ltrharvest(enc, params, device=dev)
    if args.gff3:
        text = gff3_to_string(gff3_nodes(preds, enc, seqids=args.seqids))
        if isinstance(args.gff3, str):
            with open(args.gff3, "w") as f:
                f.write(text)
        else:
            sys.stdout.write(text)
    if args.tabout != "no" and not args.gff3:
        print("# s(ret) e(ret) l(ret) s(lLTR) e(lLTR) l(lLTR) "
              "s(rLTR) e(rLTR) l(rLTR) sim(LTRs) seq-nr")
        for line in tabout_lines(preds, enc, longoutput=args.longoutput):
            print(line)
    if args.out:
        with open(args.out, "w") as f:
            for line in fasta_out_entries(preds, enc, inner=False):
                f.write(line + "\n")
    if args.outinner:
        with open(args.outinner, "w") as f:
            for line in fasta_out_entries(preds, enc, inner=True):
                f.write(line + "\n")
    return 0


def _add_ltrharvest(sub):
    p = sub.add_parser("ltrharvest", help="LTR retrotransposon prediction")
    p.add_argument("-index", required=True)
    p.add_argument("-seed", type=int, default=30)
    p.add_argument("-minlenltr", type=int, default=100)
    p.add_argument("-maxlenltr", type=int, default=1000)
    p.add_argument("-mindistltr", type=int, default=1000)
    p.add_argument("-maxdistltr", type=int, default=15000)
    p.add_argument("-similar", type=float, default=85.0)
    p.add_argument("-mintsd", type=int, default=4)
    p.add_argument("-gff3", nargs="?", const=True, default=False,
                   help="GFF3 output (optionally to a file)")
    p.add_argument("-out", default=None,
                   help="FASTA of predicted elements")
    p.add_argument("-outinner", default=None,
                   help="FASTA of inner regions between the LTRs")
    p.add_argument("-tabout", default="yes", choices=["yes", "no"])
    p.add_argument("-longoutput", action="store_true")
    p.add_argument("-seqids", action="store_true")
    p.add_argument("--cpu", action="store_true")
    return p


def cmd_tirvish(args):
    """gt tirvish (ref: src/tools/gt_tir.c over
    src/extended/tir_stream.c)."""
    from .anno.gff3 import gff3_to_string
    from .core.encseq import Encseq
    from .device import resolve_device
    from .ltr.tirvish import (TIRvishParams, gff3_nodes,
                              refseq_match_annotate, tirvish)
    from .ops.xdrop import XdropScores
    from .ops.xdrop_batch import check_belowscore
    _common_refusals(args)
    dev = resolve_device(args.device)
    enc = Encseq.load(args.index)
    p = TIRvishParams(
        min_seed_length=args.seed, min_tir_length=args.mintirlen,
        max_tir_length=args.maxtirlen, min_tir_distance=args.mintirdist,
        max_tir_distance=args.maxtirdist, mat=args.mat, mis=args.mis,
        ins=args.ins, dele=getattr(args, "del"),
        xdrop_belowscore=args.xdrop,
        similarity_threshold=args.similar,
        min_tsd_length=args.mintsd, max_tsd_length=args.maxtsd,
        vicinity=args.vic, overlaps=args.overlaps)
    try:
        check_belowscore(p.xdrop_belowscore,
                         XdropScores(p.mat, p.mis, p.ins, p.dele))
    except ValueError as e:
        raise SystemExit(f"genometools_torch: -xdrop: {e}") from None
    nodes = gff3_nodes(tirvish(enc, p, device=dev), enc)
    if args.refseqs:
        refseq_match_annotate(nodes, enc, [args.refseqs],
                              min_ali_len_perc=args.min_ali_len_perc,
                              flcands=args.flcands, source="TIRvish",
                              device=dev)
    sys.stdout.write(gff3_to_string(nodes))
    return 0


def _add_tirvish(sub):
    p = sub.add_parser("tirvish",
                       help="identify Terminal Inverted Repeat (TIR) "
                            "elements")
    p.add_argument("-index", required=True)
    p.add_argument("-seed", type=int, default=20)
    p.add_argument("-mintirlen", type=int, default=100)
    p.add_argument("-maxtirlen", type=int, default=1000)
    p.add_argument("-mintirdist", type=int, default=500)
    p.add_argument("-maxtirdist", type=int, default=10000)
    p.add_argument("-mat", type=int, default=2)
    p.add_argument("-mis", type=int, default=-2)
    p.add_argument("-ins", type=int, default=-3)
    p.add_argument("-del", type=int, default=-3)
    p.add_argument("-xdrop", type=int, default=5)
    p.add_argument("-similar", type=float, default=85.0)
    p.add_argument("-mintsd", type=int, default=2)
    p.add_argument("-maxtsd", type=int, default=11)
    p.add_argument("-vic", type=int, default=60)
    p.add_argument("-overlaps", default="best",
                   choices=["best", "longest", "no", "all"])
    p.add_argument("-refseqs", default=None,
                   help="annotate best reference-sequence matches")
    p.add_argument("-min_ali_len_perc", type=float, default=10.0)
    p.add_argument("-flcands", action="store_true")
    p.add_argument("--cpu", action="store_true")
    return p


def cmd_ltrclustering(args):
    """gt ltrclustering (ref: src/ltr/gt_ltrclustering.c)."""
    from .anno.gff3 import gff3_to_string, parse_gff3
    from .core.encseq import Encseq
    from .device import resolve_device
    from .ltr.ltrclustering import ltrclustering
    _common_refusals(args)
    dev = resolve_device(args.device)
    enc = Encseq.load(args.indexname)
    nodes = []
    for path in args.files:
        with open(path) as f:
            nodes.extend(parse_gff3(f.read()))
    ltrclustering(enc, nodes, args.psmall, args.plarge, device=dev)
    out = gff3_to_string(nodes)
    if args.o:
        with open(args.o, "w") as f:
            f.write(out)
    else:
        sys.stdout.write(out)
    return 0


def _add_ltrclustering(sub):
    p = sub.add_parser("ltrclustering",
                       help="cluster features of LTRs")
    p.add_argument("-psmall", type=int, required=True,
                   help="match must cover this percent of the smaller "
                        "sequence")
    p.add_argument("-plarge", type=int, required=True,
                   help="match must cover this percent of the larger "
                        "sequence")
    p.add_argument("-o", default=None)
    p.add_argument("indexname")
    p.add_argument("files", nargs="+")
    p.add_argument("--cpu", action="store_true")
    return p


# ---------------------------------------------------------------------------
# the packed index: packedindex, mkfmindex, prebwt, tagerator
# ---------------------------------------------------------------------------

def cmd_packedindex(args):
    from .core.encseq import Encseq
    from .device import resolve_device
    from .index.bdx import decode_bwt, write_bdx
    from .index.esa import build_esa
    from .index.fmindex import FMIndex
    _common_refusals(args)
    dev = resolve_device(args.device)
    if args.sub == "mkindex":
        enc = Encseq.from_files(args.db) if args.db else Encseq.load(args.ii)
        esa = build_esa(enc, with_lcp=False, device=dev)
        FMIndex.from_esa(esa).save(args.indexname)
        enc.save(args.indexname)
        if args.bdx:
            # also emit the reference's .bdx block-composition format
            counts = [int((enc.codes == c).sum())
                      for c in range(enc.alphabet.num_chars)]
            write_bdx(args.indexname + ".bdx", esa.bwt().astype(np.int16),
                      counts)
    elif args.sub == "chkintegrity":
        # decode a gt-written .bdx (ref: gt packedindex chkintegrity,
        # src/tools/gt_packedindex_chk_integrity.c) and hold its BWT
        # against the BWT of the index's own encseq, sorted on the card
        enc = Encseq.load(args.ii)
        got = decode_bwt(args.ii + ".bdx")
        esa = build_esa(enc, readmode=args.dir, with_lcp=False, device=dev)
        ours = esa.bwt().astype(np.int16)
        if got.size != ours.size or not (got == ours).all():
            bad = int(np.flatnonzero(got[:ours.size] != ours)[0]) \
                if got.size == ours.size else -1
            print(f"chkintegrity: MISMATCH (first at {bad})",
                  file=sys.stderr)
            return 1
        print(f"# {got.size} symbols verified OK", file=sys.stderr)
    return 0


def _add_packedindex(sub):
    p = sub.add_parser("packedindex", help="BWT-based compressed index")
    sp = p.add_subparsers(dest="sub", required=True)
    pm = sp.add_parser("mkindex")
    pm.add_argument("-db", nargs="*", default=None)
    pm.add_argument("-ii", default=None)
    pm.add_argument("-indexname", required=True)
    pm.add_argument("-bdx", action="store_true",
                    help="also write the reference .bdx format")
    pm.add_argument("--cpu", action="store_true")
    pc = sp.add_parser("chkintegrity",
                       help="verify a reference-format .bdx index")
    pc.add_argument("-ii", required=True)
    pc.add_argument("-dir", type=int, default=0,
                    help="readmode the index was built with (0=fwd)")
    pc.add_argument("--cpu", action="store_true")
    return pm, pc


def cmd_mkfmindex(args):
    """ref: src/tools/gt_mkfmindex.c (the legacy FM-index tool): one FM
    implementation backs both mkfmindex and packedindex."""
    from .core.encseq import Encseq
    from .device import resolve_device
    from .index.fmindex import build_fmindex
    _common_refusals(args)
    dev = resolve_device(args.device)
    enc = Encseq.load(args.ii[0])
    build_fmindex(enc, device=dev).save(args.fmout)
    enc.save(args.fmout)
    return 0


def _add_mkfmindex(sub):
    p = sub.add_parser("mkfmindex", help="construct an FM index")
    p.add_argument("-ii", nargs="+", required=True)
    p.add_argument("-fmout", required=True)
    p.add_argument("-noindexpos", action="store_true")
    p.add_argument("--cpu", action="store_true")
    return p


def cmd_prebwt(args):
    """ref: src/tools/gt_prebwt.c: the BWT prefix-code bucket
    boundaries of a packed index (.pbt). All 4^d codes of a depth go
    through one batched backward search on the device."""
    import json
    from .core.encseq import Encseq
    from .device import resolve_device
    from .index.fmindex import fmindex_from_codes, prebwt_bounds
    _common_refusals(args)
    dev = resolve_device(args.device)
    enc = Encseq.load(args.pck)
    fm = fmindex_from_codes(enc.codes[::-1].copy(), device=dev)
    bounds = prebwt_bounds(fm, args.maxdepth, device=dev)
    with open(args.pck + ".pbt", "w") as f:
        json.dump({"maxdepth": args.maxdepth, "bounds": bounds}, f)
    return 0


def _add_prebwt(sub):
    p = sub.add_parser("prebwt", help="precompute BWT bucket boundaries")
    p.add_argument("-pck", required=True)
    p.add_argument("-maxdepth", type=int, default=4)
    p.add_argument("--cpu", action="store_true")
    return p


def cmd_tagerator(args):
    """Approximate tag mapping (ref: src/tools/gt_tagerator.c +
    src/match/tagerator.c); output columns and headers match the
    reference. Every tag of one strand and one difference count is
    searched at once (``match/querysearch.py::tagerator_batch``): on
    the ESA by narrowing, on the packed index by backward steps on the
    device; the rows and their order are ``tagerator_search``'s and
    ``pck_tagerator_search``'s."""
    from .core.chardef import is_special
    from .core.encseq import Encseq
    from .core.seqio import read_seqfile
    from .device import resolve_device
    _common_refusals(args)
    dev = resolve_device(args.device)
    if args.esa is None and args.pck is None:
        raise SystemExit("one of -esa or -pck is required")
    e = args.e if args.e is not None and args.e >= 0 else 0
    outkeys = args.output or ["tagnum", "tagseq", "dblength",
                              "dbstartpos", "strand"]
    if e == 0:
        print("# computing complete matches without differences "
              "(exact matches)")
    else:
        print(f"# computing complete matches with up to {e} differences")
    if args.esa:
        print(f"# indexname(esa)={args.esa}")
        from .index.esa import load_esa
        from .match.querysearch import esa_tagerator_batch
        enc = Encseq.load(args.esa)
        esa = load_esa(args.esa, encseq=enc)
        search = lambda tags, dist: esa_tagerator_batch(esa, tags, dist)
    else:
        print(f"# indexname(pck)={args.pck}")
        from .index.fmindex import fmindex_from_codes, pck_tagerator_batch
        enc = Encseq.load(args.pck)
        # forward-trie DFS over the packed index = FM over the REVERSED
        # codes (like the reference's `packedindex mkindex -dir rev`)
        fm = fmindex_from_codes(enc.codes[::-1].copy(), device=dev)
        n = enc.total_length
        search = lambda tags, dist: pck_tagerator_batch(fm, tags, dist, n,
                                                        device=dev)
    print(f"# queryfile={args.q}")
    print("# for each match show: " + " ".join(outkeys) + " ")
    comp = enc.alphabet.complement_table()
    tags, bad = [], None
    for tagnum, raw in enumerate(read_seqfile(args.q).seqs):
        codes = enc.alphabet.encode(raw)
        if is_special(codes).any():
            bad = tagnum          # the tags before it are printed first
            break
        tags.append(codes)
    strands = []
    if not args.nod:
        strands.append(("+", tags))
    if not args.nop:
        strands.append(("-", [np.where(is_special(c[::-1]), c[::-1],
                                       comp[c[::-1]]) for c in tags]))
    mind = 0 if args.best else e
    found_rows = {(dist, strand): search(tagcs, dist)
                  for dist in range(mind, e + 1) for strand, tagcs in strands}
    for tagnum, codes in enumerate(tags):
        tagseq = enc.alphabet.decode(codes).lower()
        if "tagnum" in outkeys or "tagseq" in outkeys:
            print(f"#\t{tagnum}\t{tagseq}")
        for dist in range(mind, e + 1):
            found = False
            for strand, _ in strands:
                rows = found_rows[dist, strand][tagnum]
                if args.maxocc:
                    rows = rows[:args.maxocc]
                for pos, dblen, edist in rows:
                    found = True
                    s = int(enc.seqnum_of_pos(pos))
                    rel = pos - int(enc.seq_startpos(s))
                    cols = []
                    if "dblength" in outkeys:
                        cols.append(str(dblen))
                    if "dbstartpos" in outkeys:
                        if "abspos" in outkeys:
                            cols.append(str(pos))
                        else:
                            cols += [str(s), str(rel)]
                    if "dbsequence" in outkeys:
                        cols.append(enc.alphabet.decode(
                            enc.codes[pos:pos + dblen]).lower())
                    if "strand" in outkeys:
                        cols.append(strand)
                    if "edist" in outkeys:
                        cols.append(str(edist))
                    print("\t".join(cols))
            if args.best and found:
                break
    if bad is not None:
        raise SystemExit(f"gt-tpu tagerator: error: wildcard in tag "
                         f"number {bad}")
    return 0


def _add_tagerator(sub):
    p = sub.add_parser("tagerator", help="map short tags approximately")
    p.add_argument("-q", required=True, help="tag file (FASTA)")
    p.add_argument("-e", type=int, default=None, help="max differences")
    p.add_argument("-esa", default=None, help="enhanced suffix array index")
    p.add_argument("-pck", default=None, help="packed index")
    p.add_argument("-nod", action="store_true", help="no direct matches")
    p.add_argument("-nop", action="store_true", help="no palindromic")
    p.add_argument("-best", action="store_true")
    p.add_argument("-maxocc", type=int, default=0)
    p.add_argument("-output", nargs="+", default=None)
    p.add_argument("--cpu", action="store_true")
    return p


# ---------------------------------------------------------------------------
# mergeesa, sain
# ---------------------------------------------------------------------------

def cmd_mergeesa(args):
    """gt dev mergeesa (ref: src/tools/gt_mergeesa.c): merge several
    enhanced suffix arrays into one, sorted on the card."""
    from .core.encseq import Encseq
    from .device import resolve_device
    from .index.esa import merge_esas, write_esa
    _common_refusals(args)
    dev = resolve_device(args.device)
    esa = merge_esas([Encseq.load(ii) for ii in args.ii], with_lcp=True,
                     device=dev)
    esa.encseq.save(args.indexname)
    write_esa(esa, args.indexname, suf=True, lcp=True)
    return 0


def _add_mergeesa(sub):
    p = sub.add_parser("mergeesa", help="merge enhanced suffix arrays")
    p.add_argument("-indexname", required=True)
    p.add_argument("-ii", nargs="+", required=True)
    p.add_argument("--cpu", action="store_true")
    return p


def cmd_sain(args):
    """gt dev sain (ref: src/tools/gt_sain.c, src/match/sfx-sain.c:1577):
    SA-IS linear-time induced-sorting construction on the host, the
    independent second ESA path; -check holds it against build_esa on
    the card."""
    from .core.encseq import Encseq
    from .core.native import sais_native
    from .device import resolve_device
    from .index.esa import build_esa
    _common_refusals(args)
    dev = resolve_device(args.device)
    enc = Encseq.from_files(args.db) if args.db else Encseq.load(args.esa)
    sa = sais_native(enc.suffix_keys())
    if sa is None:
        print("sain: native library unavailable", file=sys.stderr)
        return 1
    if args.check:
        esa = build_esa(enc, with_lcp=False, device=dev)
        if not (sa.astype(np.int64) == esa.suftab.astype(np.int64)).all():
            print("sain: MISMATCH vs doubling engine", file=sys.stderr)
            return 1
        print(f"# sain == doubling engine on {sa.size} suffixes",
              file=sys.stderr)
    if args.suf:
        indexname = args.indexname or (args.db[0] if args.db else args.esa)
        sa.astype(np.uint64).tofile(indexname + ".suf")
    return 0


def _add_sain(sub):
    p = sub.add_parser("sain", help="SA-IS induced-sorting suffix array")
    p.add_argument("-db", nargs="+", default=None)
    p.add_argument("-esa", default=None, help="existing encseq index")
    p.add_argument("-indexname", default=None)
    p.add_argument("-suf", action="store_true", help="write .suf")
    p.add_argument("-check", action="store_true",
                   help="cross-check against the doubling engine")
    p.add_argument("--cpu", action="store_true")
    return p


# ---------------------------------------------------------------------------
# the GFF3 annotation tools (host code: no -device) and ltrdigest
# ---------------------------------------------------------------------------

def cmd_gff3(args):
    from .anno.gff3 import GFF3Writer, parse_gff3
    from .anno.node_stream import add_introns_stream, sort_stream
    nodes = []
    for p in args.files or ["-"]:
        text = sys.stdin.read() if p == "-" else open(p).read()
        nodes.extend(parse_gff3(text, strict=not args.tidy))
    if args.xrfcheck is not None:
        from .anno.xrf import XRFChecker, XRFError, resolve_xrf_path
        try:
            checker = XRFChecker.from_file(
                resolve_xrf_path(args.xrfcheck or None))
            checker.check_nodes(nodes)
        except XRFError as e:
            print(f"gt gff3: error: {e}", file=sys.stderr)
            return 1
    stream = iter(nodes)
    if args.addintrons:
        stream = add_introns_stream(stream)
    if args.sort:
        stream = sort_stream(stream)
    out = GFF3Writer(retainids=args.retainids).render(list(stream))
    sys.stdout.write(out)
    return 0


def _add_gff3(sub):
    p = sub.add_parser("gff3", help="parse, validate and output GFF3")
    p.add_argument("files", nargs="*")
    p.add_argument("-sort", action="store_true")
    p.add_argument("-retainids", action="store_true")
    p.add_argument("-addintrons", action="store_true")
    p.add_argument("-tidy", action="store_true")
    p.add_argument("-xrfcheck", nargs="?", const="", default=None,
                   help="check Dbxref/Ontology_term attributes against "
                        "an XRF abbreviation definition file")
    p.set_defaults(func=cmd_gff3)


def cmd_stat(args):
    from .anno.gff3 import parse_gff3
    from .anno.node_stream import FeatureStats, stat_stream
    from .anno.genome_node import FeatureNode, RegionNode
    stats = FeatureStats()
    n_regions = 0
    for p in args.files:
        nodes = parse_gff3(open(p).read())
        n_regions += sum(isinstance(n, RegionNode) for n in nodes)
        list(stat_stream(nodes, stats))
    print(f"parsed genome node DAGs: "
          f"{stats.counts.get('gene', 0)}")
    print(f"sequence regions: {n_regions}")
    for t in sorted(stats.counts):
        print(f"{t}s: {stats.counts[t]}")
    return 0


def _add_stat(sub):
    p = sub.add_parser("stat", help="show statistics about GFF3 features")
    p.add_argument("files", nargs="+")
    p.set_defaults(func=cmd_stat)


def cmd_convert_anno(args):
    from .anno.gff3 import GFF3Writer, parse_gff3
    from .anno.parsers import gff3_to_gtf, parse_bed, parse_gtf
    text = open(args.file).read() if args.file != "-" else sys.stdin.read()
    if args.tool == "gtf_to_gff3":
        nodes = parse_gtf(text)
        sys.stdout.write(GFF3Writer(retainids=True).render(nodes))
    elif args.tool == "bed_to_gff3":
        nodes = parse_bed(text)
        sys.stdout.write(GFF3Writer(retainids=True).render(nodes))
    elif args.tool == "gff3_to_gtf":
        nodes = parse_gff3(text)
        sys.stdout.write(gff3_to_gtf(nodes))
    return 0


def _add_convert_anno(sub):
    for name in ("gtf_to_gff3", "bed_to_gff3", "gff3_to_gtf"):
        p = sub.add_parser(name, help=f"{name.replace('_', ' ')}")
        p.add_argument("file", nargs="?", default="-")
        p.set_defaults(func=cmd_convert_anno, tool=name)


def cmd_select(args):
    from .anno.genome_node import Range
    from .anno.gff3 import GFF3Writer, parse_gff3
    from .anno.node_stream import select_stream
    nodes = []
    for pth in args.files:
        nodes.extend(parse_gff3(open(pth).read()))
    contain = Range(args.contain[0], args.contain[1]) if args.contain         else None
    out = list(select_stream(
        nodes, seqid=args.seqid, typefilter=args.hastype,
        max_gene_length=args.maxgenelength, contain=contain))
    if args.rule_files:
        from .anno.script_filter import load_filter
        preds = [load_filter(p)[1] for p in args.rule_files]

        def drop(n):
            # only feature nodes are filtered (ref: script_filter.c
            # visits feature nodes; regions/comments pass through)
            if not hasattr(n, "type"):
                return False
            return (any if args.rule_logic == "OR" else all)(
                p(n) for p in preds)

        out = [n for n in out if not drop(n)]
    sys.stdout.write(GFF3Writer().render(out))
    return 0


def _add_select(sub):
    p = sub.add_parser("select", help="filter GFF3 features")
    p.add_argument("files", nargs="+")
    p.add_argument("-seqid", default=None)
    p.add_argument("-hastype", default=None)
    p.add_argument("-maxgenelength", type=int, default=None)
    p.add_argument("-contain", nargs=2, type=int, default=None)
    p.add_argument("-rule_files", nargs="+", default=None,
                   help="Python filter scripts (filter(gn) -> drop)")
    p.add_argument("-rule_logic", default="AND", choices=["AND", "OR"])
    p.set_defaults(func=cmd_select)


def _read_gff3_files(files):
    from .anno.gff3 import parse_gff3
    nodes = []
    for pth in files:
        text = sys.stdin.read() if pth == "-" else open(pth).read()
        if not text.strip():
            raise SystemExit(f"gt chseqids: error: GFF3 file \"{pth}\" "
                             f"is empty")
        nodes.extend(parse_gff3(text))
    return nodes


def cmd_chseqids(args):
    from .anno.gff3 import GFF3Writer
    from .anno.md5translate import parse_lua_mapping
    from .anno.node_stream import chseqids_stream, sort_stream
    try:
        mapping = parse_lua_mapping(args.mapping_file, "chseqids")
    except ValueError as exc:
        print(f"gt chseqids: error: {exc}", file=sys.stderr)
        return 1
    nodes = _read_gff3_files(args.files or ["-"])
    missing = [n.seqid for n in nodes
               if getattr(n, "seqid", None) and n.seqid not in mapping]
    if missing:
        print(f"gt chseqids: error: chseqids[{missing[0]}] is nil "
              f"(defined in \"{args.mapping_file}\")", file=sys.stderr)
        return 1
    out = chseqids_stream(iter(nodes), mapping)
    if args.sort:
        out = sort_stream(out)
    text = GFF3Writer(retainids=True).render(list(out))
    if args.o:
        open(args.o, "w").write(text)
    else:
        sys.stdout.write(text)
    return 0


def cmd_dupfeat(args):
    from .anno.gff3 import GFF3Writer
    from .anno.node_stream import dupfeat_stream
    nodes = _read_gff3_files(args.files or ["-"])
    out = list(dupfeat_stream(iter(nodes), args.dest, args.source))
    sys.stdout.write(GFF3Writer().render(out))
    return 0


def cmd_mergefeat(args):
    from .anno.gff3 import GFF3Writer
    from .anno.node_stream import mergefeat_stream
    nodes = _read_gff3_files(args.files or ["-"])
    out = list(mergefeat_stream(iter(nodes)))
    sys.stdout.write(GFF3Writer().render(out))
    return 0


def cmd_id_to_md5(args):
    from .anno.gff3 import GFF3Writer
    from .anno.md5translate import SeqCollection, id_to_md5_nodes
    seqfiles = (args.seqfiles or []) + ([args.seqfile] if args.seqfile
                                        else [])
    if not seqfiles:
        print("gt id_to_md5: error: option \"-seqfile\" or \"-seqfiles\" "
              "is mandatory", file=sys.stderr)
        return 1
    seqcol = SeqCollection(seqfiles, matchdesc=args.matchdesc)
    nodes = _read_gff3_files(args.files or ["-"])
    try:
        out = list(id_to_md5_nodes(iter(nodes), seqcol,
                                   subtargetids=not args.no_subtargetids))
    except ValueError as exc:
        print(f"gt id_to_md5: error: {exc}", file=sys.stderr)
        return 1
    sys.stdout.write(GFF3Writer(retainids=True).render(out))
    return 0


def cmd_md5_to_id(args):
    from .anno.gff3 import GFF3Writer
    from .anno.md5translate import SeqCollection, md5_to_id_nodes
    seqfiles = (args.seqfiles or []) + ([args.seqfile] if args.seqfile
                                        else [])
    seqcol = SeqCollection(seqfiles, matchdesc=args.matchdesc) \
        if seqfiles else None
    nodes = _read_gff3_files(args.files or ["-"])
    try:
        out = list(md5_to_id_nodes(iter(nodes), seqcol))
    except ValueError as exc:
        print(f"gt md5_to_id: error: {exc}", file=sys.stderr)
        return 1
    sys.stdout.write(GFF3Writer(retainids=True).render(out))
    return 0


def _add_feat_streams(sub):
    p = sub.add_parser("chseqids",
                       help="change sequence ids by a mapping file")
    p.add_argument("mapping_file")
    p.add_argument("files", nargs="*")
    p.add_argument("-sort", action="store_true")
    p.add_argument("-v", action="store_true")
    p.add_argument("-o", default=None)
    p.set_defaults(func=cmd_chseqids)

    p = sub.add_parser("dupfeat",
                       help="duplicate internal feature nodes")
    p.add_argument("files", nargs="*")
    p.add_argument("-dest", required=True)
    p.add_argument("-source", required=True)
    p.set_defaults(func=cmd_dupfeat)

    p = sub.add_parser("mergefeat",
                       help="merge adjacent features of the same type")
    p.add_argument("files", nargs="*")
    p.set_defaults(func=cmd_mergefeat)

    for name, fn in (("id_to_md5", cmd_id_to_md5),
                     ("md5_to_id", cmd_md5_to_id)):
        p = sub.add_parser(
            name, help=f"{name.replace('_', ' ')} seqid translation")
        p.add_argument("files", nargs="*")
        p.add_argument("-seqfile", default=None)
        p.add_argument("-seqfiles", nargs="+", default=None)
        p.add_argument("-matchdesc", action="store_true")
        p.add_argument("-no_subtargetids", action="store_true")
        p.set_defaults(func=fn)


def cmd_scriptfilter(args):
    """ref: src/tools/gt_scriptfilter.c — validate filter scripts and
    show their metadata (output format of
    testdata/script_filter_output.txt)."""
    from .anno.script_filter import load_filter, show_metadata
    for pth in args.files:
        meta, _ = load_filter(pth)
        print(show_metadata(
            meta, scriptname=pth if args.scriptname != "false" else None,
            oneline=args.oneline))
    return 0


def _add_scriptfilter(sub):
    p = sub.add_parser("scriptfilter",
                       help="show metadata of select filter scripts")
    p.add_argument("files", nargs="+")
    p.add_argument("-scriptname", default="true")
    p.add_argument("-oneline", action="store_true")
    p.set_defaults(func=cmd_scriptfilter)


def cmd_seqids(args):
    """gt seqids (ref: src/tools/gt_seqids.c): sorted unique seqids."""
    from .anno.genome_node import FeatureNode, RegionNode
    from .anno.gff3 import parse_gff3
    try:
        text = open(args.file).read() if args.file != "-" \
            else sys.stdin.read()
    except FileNotFoundError as e:
        print(f"gt seqids: error: {e.strerror}: {args.file}",
              file=sys.stderr)
        return 1
    ids = set()
    for n in parse_gff3(text):
        if isinstance(n, (RegionNode, FeatureNode)):
            ids.add(n.seqid)
    for s in sorted(ids):
        print(s)
    return 0


def _add_seqids(sub):
    p = sub.add_parser("seqids", help="print sorted unique seqids of a "
                       "GFF3 file")
    p.add_argument("file", nargs="?", default="-")
    p.set_defaults(func=cmd_seqids)


def cmd_loccheck(args):
    """gt loccheck (ref: src/tools/gt_loccheck.c,
    extended/check_boundaries_visitor.c): warn about child ranges not
    contained in their parents."""
    from .anno.genome_node import FeatureNode
    from .anno.gff3 import parse_gff3
    text = open(args.file).read() if args.file != "-" else sys.stdin.read()
    for top in parse_gff3(text):
        if not isinstance(top, FeatureNode):
            continue
        for parent in top.traverse():
            for child in parent.children:
                if child.range.start < parent.range.start or \
                        child.range.end > parent.range.end:
                    print(f"warning: {child.type} child range "
                          f"{child.range.start}-{child.range.end} "
                          f"(line {getattr(child, 'line_number', 0)}) not "
                          f"contained in {parent.type} parent range "
                          f"{parent.range.start}-{parent.range.end} "
                          f"(line {getattr(parent, 'line_number', 0)})",
                          file=sys.stderr)
    return 0


def _add_loccheck(sub):
    p = sub.add_parser("loccheck", help="check parent-child range "
                       "containment")
    p.add_argument("file", nargs="?", default="-")
    p.set_defaults(func=cmd_loccheck)


def cmd_gff3validator(args):
    """gt gff3validator (ref: src/tools/gt_gff3validator.c)."""
    from .anno.anno_db import TypeChecker
    from .anno.gff3 import GFF3Error, parse_gff3
    text = open(args.file).read() if args.file != "-" else sys.stdin.read()
    try:
        nodes = parse_gff3(text)
    except GFF3Error as e:
        print(f"gt gff3validator: error: {e}", file=sys.stderr)
        return 1
    if args.typecheck:
        import os
        path = args.typecheck
        if not os.path.exists(path):
            for d in os.environ.get("GT_DATA_PATH", "").split(":"):
                cand = os.path.join(d, "obo_files", path + ".obo")
                if d and os.path.exists(cand):
                    path = cand
                    break
        try:
            checker = TypeChecker.from_obo(open(path).read())
        except OSError as e:
            print(f"gt gff3validator: error: cannot open {path}: {e}",
                  file=sys.stderr)
            return 1
        bad = checker.check_nodes(nodes)
        if bad:
            print(f"gt gff3validator: error: type \"{bad[0]}\" is not a "
                  f"valid feature type", file=sys.stderr)
            return 1
    print("input is valid GFF3")
    return 0


def _add_gff3validator(sub):
    p = sub.add_parser("gff3validator", help="validate GFF3 files")
    p.add_argument("file", nargs="?", default="-")
    p.add_argument("-typecheck", default=None)
    p.set_defaults(func=cmd_gff3validator)


def cmd_inlineseq_split(args):
    """gt inlineseq_split (ref: src/tools/gt_inlineseq_split.c): write
    the annotation and the embedded FASTA to separate files."""
    from .anno.genome_node import SequenceNode
    from .anno.gff3 import GFF3Writer, parse_gff3
    try:
        text = open(args.file).read() if args.file != "-" \
            else sys.stdin.read()
    except FileNotFoundError as e:
        print(f"gt inlineseq_split: error: {e}", file=sys.stderr)
        return 1
    nodes = parse_gff3(text)
    seqs = [n for n in nodes if isinstance(n, SequenceNode)]
    rest = [n for n in nodes if not isinstance(n, SequenceNode)]
    try:
        if args.seqfile:
            with open(args.seqfile, "w") as f:
                for s in seqs:
                    f.write(">" + s.description + "\n")
                    for i in range(0, len(s.sequence), 80):
                        f.write(s.sequence[i:i + 80] + "\n")
        out = GFF3Writer().render(rest)
        if args.gff3file:
            with open(args.gff3file, "w") as f:
                f.write(out)
        else:
            sys.stdout.write(out)
    except OSError as e:
        print(f"gt inlineseq_split: error: {e}", file=sys.stderr)
        return 1
    return 0


def _add_inlineseq_split(sub):
    p = sub.add_parser("inlineseq_split", help="split GFF3 with inline "
                       "sequence into annotation + FASTA")
    p.add_argument("file", nargs="?", default="-")
    p.add_argument("-seqfile", default=None)
    p.add_argument("-gff3file", default=None)
    p.set_defaults(func=cmd_inlineseq_split)


def cmd_inlineseq_add(args):
    """gt inlineseq_add (ref: src/tools/gt_inlineseq_add.c): append the
    seqids' sequences as an inline ##FASTA section."""
    from .anno.genome_node import FeatureNode, RegionNode, SequenceNode
    from .anno.gff3 import GFF3Writer, parse_gff3
    text = open(args.file).read() if args.file != "-" else sys.stdin.read()
    nodes = parse_gff3(text)
    mapping = _region_mapping(args)
    seqids = []
    for n in nodes:
        if isinstance(n, (RegionNode, FeatureNode)) and \
                n.seqid not in seqids:
            seqids.append(n.seqid)
    try:
        for sid in seqids:
            idx = mapping._grep_desc(sid)
            nodes.append(SequenceNode(sid, mapping.seqs[idx]))
    except ValueError as e:
        print(f"gt inlineseq_add: error: {e}", file=sys.stderr)
        return 1
    sys.stdout.write(GFF3Writer(fasta_width=10 ** 9).render(nodes))
    return 0


def _add_inlineseq_add(sub):
    p = sub.add_parser("inlineseq_add", help="add inline sequence to "
                       "GFF3 from a sequence file")
    p.add_argument("file", nargs="?", default="-")
    p.add_argument("-seqfile", required=True)
    p.add_argument("-matchdesc", action="store_true")
    p.add_argument("-usedesc", action="store_true")
    p.set_defaults(func=cmd_inlineseq_add)


def cmd_merge(args):
    from .anno.gff3 import GFF3Writer, parse_gff3
    from .anno.node_stream import merge_stream
    streams = [parse_gff3(open(pth).read()) for pth in args.files]
    sys.stdout.write(GFF3Writer().render(list(merge_stream(streams))))
    return 0


def _add_merge(sub):
    p = sub.add_parser("merge", help="merge sorted GFF3 files")
    p.add_argument("files", nargs="+")
    p.set_defaults(func=cmd_merge)


def cmd_uniq(args):
    from .anno.gff3 import GFF3Writer, parse_gff3
    from .anno.node_stream import sort_stream, uniq_stream
    nodes = []
    for pth in args.files:
        nodes.extend(parse_gff3(open(pth).read()))
    out = list(uniq_stream(sort_stream(nodes)))
    sys.stdout.write(GFF3Writer().render(out))
    return 0


def _add_uniq(sub):
    p = sub.add_parser("uniq", help="remove repeated feature trees")
    p.add_argument("files", nargs="+")
    p.set_defaults(func=cmd_uniq)


def cmd_interfeat(args):
    from .anno.gff3 import GFF3Writer, parse_gff3
    from .anno.node_stream import inter_feature_stream
    nodes = []
    for pth in args.files:
        nodes.extend(parse_gff3(open(pth).read()))
    out = list(inter_feature_stream(nodes, args.outside, args.inter))
    sys.stdout.write(GFF3Writer().render(out))
    return 0


def _add_interfeat(sub):
    p = sub.add_parser("interfeat", help="add inter features")
    p.add_argument("files", nargs="+")
    p.add_argument("-outside", default="exon")
    p.add_argument("-inter", default="intron")
    p.set_defaults(func=cmd_interfeat)


def cmd_extractfeat(args):
    from .anno.feature_index import extract_features
    from .anno.gff3 import parse_gff3
    from .core.seqio import read_seqfiles, write_fasta
    nodes = parse_gff3(open(args.gff3).read())
    ss = read_seqfiles(args.seqfile)
    seqs = {d.split()[0]: s.tobytes().decode("latin-1")
            for d, s in zip(ss.descs, ss.seqs)}
    out = extract_features(nodes, seqs, args.type, join=args.join,
                           translate=args.translate)
    write_fasta(sys.stdout, [x.tobytes().decode("latin-1")
                             for x in out.seqs], out.descs)
    return 0


def _add_extractfeat(sub):
    p = sub.add_parser("extractfeat", help="extract feature sequences")
    p.add_argument("gff3")
    p.add_argument("-seqfile", nargs="+", required=True)
    p.add_argument("-type", default="exon")
    p.add_argument("-join", action="store_true")
    p.add_argument("-translate", action="store_true")
    p.set_defaults(func=cmd_extractfeat)


def cmd_mkfeatureindex(args):
    """ref: src/tools/gt_mkfeatureindex.c — persist GFF3 features into
    an SQLite-backed feature index."""
    from .anno.anno_db import AnnoDB
    from .anno.gff3 import parse_gff3
    db = AnnoDB(args.filename)
    for pth in args.input:
        db.add_gff3(parse_gff3(open(pth).read()))
    db.conn.commit()
    return 0


def _add_mkfeatureindex(sub):
    p = sub.add_parser("mkfeatureindex",
                       help="create persistent feature index")
    p.add_argument("-filename", required=True)
    p.add_argument("input", nargs="+")
    p.set_defaults(func=cmd_mkfeatureindex)


def cmd_featureindex(args):
    """ref: src/tools/gt_featureindex.c — query a persistent feature
    index, GFF3 output."""
    from .anno.anno_db import AnnoDB
    from .anno.gff3 import GFF3Writer
    db = AnnoDB(args.filename)
    seqid = args.seqid or (db.seqids()[0] if db.seqids() else None)
    if seqid is None:
        return 0
    if args.range:
        lo, hi = (int(x) for x in args.range)
    else:
        lo, hi = 0, 1 << 60
    feats = db.features_for_range(seqid, lo, hi)
    sys.stdout.write(GFF3Writer(retainids=True).render(list(feats)))
    return 0


def _add_featureindex(sub):
    p = sub.add_parser("featureindex",
                       help="retrieve features from a feature index")
    p.add_argument("-filename", required=True)
    p.add_argument("-seqid", default=None)
    p.add_argument("-range", nargs=2, default=None)
    p.set_defaults(func=cmd_featureindex)


def cmd_ltrdigest(args):
    """gt ltrdigest: PPT/PBS annotation of LTR retrotransposons
    (ref: src/tools/gt_ltrdigest.c); the PBS search runs as one batch
    on -device."""
    from .anno.gff3 import gff3_to_string, parse_gff3
    from .device import resolve_device
    from .ltr.ltrdigest import LTRdigestParams, ltrdigest
    dev = resolve_device(args.device)     # also without -trnas
    text = open(args.file).read() if args.file != "-" else sys.stdin.read()
    try:
        nodes = parse_gff3(text)
        mapping = _region_mapping(args)
        trna_lib = None
        if args.trnas:
            from .core.seqio import read_seqfile
            ss = read_seqfile(args.trnas)
            trna_lib = [(d.split()[0], s.tobytes().decode())
                        for d, s in zip(ss.descs, ss.seqs)]
        params = LTRdigestParams(
            ppt_len=(args.pptlen[0], args.pptlen[1]),
            ubox_len=(args.uboxlen[0], args.uboxlen[1]),
            ppt_radius=args.pptradius,
            max_ubox_dist=args.maxgaplen,
            pbs_alilen=(args.pbsalilen[0], args.pbsalilen[1]),
            pbs_offsetlen=(args.pbsoffset[0], args.pbsoffset[1]),
            pbs_trnaoffsetlen=(args.pbstrnaoffset[0],
                               args.pbstrnaoffset[1]),
            pbs_max_edist=args.pbsmaxedist, pbs_radius=args.pbsradius)
        ltrdigest(nodes, mapping, trna_lib, params, device=dev)
        if args.outfileprefix:
            from .ltr.ltrdigest import ltrdigest_file_out
            ltrdigest_file_out(nodes, mapping, args.outfileprefix,
                               seqnamelen=args.seqnamelen)
    except ValueError as e:
        print(f"gt ltrdigest: error: {e}", file=sys.stderr)
        return 1
    sys.stdout.write(gff3_to_string(nodes, retainids=True))
    return 0


def _add_ltrdigest(sub):
    p = sub.add_parser("ltrdigest",
                       help="annotate PPT/PBS in LTR retrotransposons")
    p.add_argument("file", nargs="?", default="-")
    p.add_argument("-seqfile")
    p.add_argument("-encseq")
    p.add_argument("-matchdesc", action="store_true")
    p.add_argument("-usedesc", action="store_true")
    p.add_argument("-trnas")
    p.add_argument("-pptlen", type=int, nargs=2, default=[8, 30])
    p.add_argument("-uboxlen", type=int, nargs=2, default=[3, 30])
    p.add_argument("-pptradius", type=int, default=30)
    p.add_argument("-maxgaplen", type=int, default=0)
    p.add_argument("-pbsalilen", type=int, nargs=2, default=[11, 30])
    p.add_argument("-pbsoffset", type=int, nargs=2, default=[0, 5])
    p.add_argument("-pbstrnaoffset", type=int, nargs=2, default=[0, 5])
    p.add_argument("-pbsmaxedist", type=int, default=1)
    p.add_argument("-pbsradius", type=int, default=30)
    p.add_argument("-outfileprefix", default=None,
                   help="prefix for tabular + FASTA output files")
    p.add_argument("-seqnamelen", type=int, default=20)
    return p


def _region_mapping(args):
    from .anno.cds import RegionMapping
    if getattr(args, "encseq", None):
        return RegionMapping.from_encseq(args.encseq,
                                         matchdesc=args.matchdesc,
                                         usedesc=args.usedesc)
    return RegionMapping.from_file(args.seqfile, matchdesc=args.matchdesc,
                                   usedesc=args.usedesc)


def cmd_speck(args):
    """ref: src/tools/gt_speck.c — check annotations against a spec
    (Python describe/it rules; see anno/speck.py)."""
    from .anno.gff3 import parse_gff3
    from .anno.speck import run_speck
    nodes = []
    for pth in args.files:
        nodes.extend(parse_gff3(open(pth).read()))
    res = run_speck(args.specfile, nodes)
    print(res.report())
    if res.failures and args.failhard:
        raise SystemExit(1)
    return 0


def _add_speck(sub):
    p = sub.add_parser("speck", help="check annotations against a spec")
    p.add_argument("-specfile", required=True)
    p.add_argument("-failhard", action="store_true")
    p.add_argument("files", nargs="+")
    p.set_defaults(func=cmd_speck)


def cmd_csa(args):
    from .anno.csa import csa
    from .anno.gff3 import GFF3Writer, parse_gff3
    text = open(args.file).read() if args.file != "-" else sys.stdin.read()
    nodes = csa(parse_gff3(text), join_length=args.join_length)
    sys.stdout.write(GFF3Writer().render(nodes))
    return 0


def _add_csa(sub):
    p = sub.add_parser("csa", help="consensus spliced alignments")
    p.add_argument("file", nargs="?", default="-")
    p.add_argument("-join-length", dest="join_length", type=int, default=300)
    p.set_defaults(func=cmd_csa)


def cmd_eval(args):
    """gt eval (ref: src/tools/gt_eval.c)."""
    from .anno.eval import evaluate
    from .anno.gff3 import parse_gff3
    reality = parse_gff3(open(args.reality).read()
                         if args.reality != "-" else sys.stdin.read())
    prediction = parse_gff3(open(args.prediction).read()
                            if args.prediction != "-" else sys.stdin.read())
    try:
        sys.stdout.write(evaluate(
            reality, prediction, nuceval=args.nuc == "yes",
            evalLTR=args.ltr, LTRdelta=args.ltrdelta,
            reality_name=args.reality, prediction_name=args.prediction))
    except ValueError as e:
        print(f"gt eval: error: {e}", file=sys.stderr)
        return 1
    return 0


def _add_eval(sub):
    p = sub.add_parser("eval", help="evaluate gene predictions against "
                       "reference annotation")
    p.add_argument("reality")
    p.add_argument("prediction")
    p.add_argument("-nuc", choices=["yes", "no"], default="yes")
    p.add_argument("-ltr", action="store_true")
    p.add_argument("-ltrdelta", type=int, default=20)
    p.set_defaults(func=cmd_eval)


def cmd_cds(args):
    """gt cds (ref: src/tools/gt_cds.c)."""
    from .anno.cds import RegionMapping, add_cds
    from .anno.gff3 import GFF3Writer, parse_gff3
    text = open(args.file).read() if args.file != "-" else sys.stdin.read()
    try:
        mapping = RegionMapping.from_file(args.seqfile,
                                          matchdesc=args.matchdesc,
                                          usedesc=args.usedesc)
        nodes = add_cds(parse_gff3(text), mapping,
                        minorflen=args.minorflen,
                        start_codon=args.startcodon == "yes",
                        final_stop_codon=args.finalstopcodon == "yes",
                        filename=args.file)
    except ValueError as e:
        print(f"gt cds: error: {e}", file=sys.stderr)
        return 1
    sys.stdout.write(GFF3Writer().render(nodes))
    return 0


def _add_cds(sub):
    p = sub.add_parser("cds", help="add CDS features to exon features")
    p.add_argument("file", nargs="?", default="-")
    p.add_argument("-seqfile", required=True)
    p.add_argument("-matchdesc", action="store_true")
    p.add_argument("-usedesc", action="store_true")
    p.add_argument("-minorflen", type=int, default=64)
    p.add_argument("-startcodon", nargs="?", const="yes",
                   choices=["yes", "no"], default="no")
    p.add_argument("-finalstopcodon", nargs="?", const="yes",
                   choices=["yes", "no"], default="no")
    p.set_defaults(func=cmd_cds)


def cmd_splicesiteinfo(args):
    """gt splicesiteinfo (ref: src/tools/gt_splicesiteinfo.c)."""
    from .anno.gff3 import parse_gff3
    from .anno.splicesite import splice_site_info
    text = open(args.file).read() if args.file != "-" else sys.stdin.read()
    try:
        report = splice_site_info(parse_gff3(text), _region_mapping(args),
                                  addintrons=args.addintrons)
    except ValueError as e:
        print(f"gt splicesiteinfo: error: {e}", file=sys.stderr)
        return 1
    if report is None:
        print("warning: input file(s) contained no intron, use option "
              "-addintrons to add introns automatically", file=sys.stderr)
    else:
        sys.stdout.write(report)
    return 0


def _add_splicesiteinfo(sub):
    p = sub.add_parser("splicesiteinfo",
                       help="show splice site info for introns")
    p.add_argument("file", nargs="?", default="-")
    p.add_argument("-seqfile")
    p.add_argument("-encseq")
    p.add_argument("-matchdesc", action="store_true")
    p.add_argument("-usedesc", action="store_true")
    p.add_argument("-addintrons", action="store_true")
    p.set_defaults(func=cmd_splicesiteinfo)


def cmd_orffinder(args):
    """gt orffinder (ref: src/tools/gt_orffinder.c)."""
    from .anno.gff3 import GFF3Writer, parse_gff3
    from .anno.orffinder import find_orfs
    if args.min < 30:
        print("gt orffinder: error: argument to option \"-min\" must be "
              "an integer >= 30", file=sys.stderr)
        return 1
    if args.min > args.max:
        print("gt orffinder: error: Value for -min must be larger than "
              "-max", file=sys.stderr)
        return 1
    text = open(args.file).read() if args.file != "-" else sys.stdin.read()
    try:
        nodes = find_orfs(parse_gff3(text), _region_mapping(args),
                          types=set(args.types) if args.types else None,
                          min_len=args.min, max_len=args.max,
                          all_orfs=args.allorfs)
    except ValueError as e:
        print(f"gt orffinder: error: {e}", file=sys.stderr)
        return 1
    sys.stdout.write(GFF3Writer().render(nodes))
    return 0


def _add_orffinder(sub):
    p = sub.add_parser("orffinder", help="find ORFs in annotated features")
    p.add_argument("file", nargs="?", default="-")
    p.add_argument("-types", nargs="+", default=None)
    p.add_argument("-allorfs", action="store_true")
    p.add_argument("-min", type=int, default=30)
    p.add_argument("-max", type=int, default=10000)
    p.add_argument("-seqfile")
    p.add_argument("-encseq")
    p.add_argument("-matchdesc", action="store_true")
    p.add_argument("-usedesc", action="store_true")
    p.set_defaults(func=cmd_orffinder)


def cmd_regioncov(args):
    """gt dev regioncov (ref: src/tools/gt_regioncov.c)."""
    from .anno.gff3 import parse_gff3
    from .anno.regioncov import region_coverage
    text = open(args.file).read() if args.file != "-" else sys.stdin.read()
    sys.stdout.write(region_coverage(parse_gff3(text),
                                     args.maxfeaturedist))
    return 0


def _add_regioncov(sub):
    p = sub.add_parser("regioncov", help="show region parts covered by "
                       "features")
    p.add_argument("file", nargs="?", default="-")
    p.add_argument("-maxfeaturedist", type=int, default=0)
    p.set_defaults(func=cmd_regioncov)


def cmd_snpper(args):
    """gt snpper (ref: src/tools/gt_snpper.c)."""
    from .anno.cds import RegionMapping
    from .anno.gff3 import GFF3Writer, parse_gff3
    from .anno.node_stream import sort_stream
    from .anno.snpper import snp_annotator_stream
    from .core.trans_table import TransTable

    try:
        tt = TransTable(args.trans_table)
    except ValueError as e:
        print(f"gt snpper: error: {e}", file=sys.stderr)
        return 1
    gff_nodes = list(sort_stream(parse_gff3(open(args.gff3_file).read())))
    gvf_text = open(args.gvf_file).read() if args.gvf_file != "-" \
        else sys.stdin.read()
    gvf_nodes = list(sort_stream(parse_gff3(gvf_text)))
    try:
        if args.encseq:
            rmap = RegionMapping.from_encseq(args.encseq,
                                             matchdesc=args.matchdesc,
                                             usedesc=args.usedesc)
        elif args.seqfile:
            rmap = RegionMapping.from_file(args.seqfile,
                                           matchdesc=args.matchdesc,
                                           usedesc=args.usedesc)
        else:
            print("gt snpper: error: option \"-seqfile\" or \"-encseq\" "
                  "is mandatory", file=sys.stderr)
            return 1
        out = list(snp_annotator_stream(gvf_nodes, gff_nodes, rmap, tt))
    except ValueError as e:
        print(f"gt snpper: error: {e}", file=sys.stderr)
        return 1
    text = GFF3Writer().render(out)
    if args.o:
        with open(args.o, "w") as fp:
            fp.write(text)
    else:
        sys.stdout.write(text)
    return 0


def _add_snpper(sub):
    p = sub.add_parser(
        "snpper", help="annotate SNPs according to their effect on the "
        "genome as given by a genomic annotation")
    p.add_argument("gff3_file")
    p.add_argument("gvf_file", nargs="?", default="-")
    p.add_argument("-trans_table", type=int, default=1,
                   help="NCBI translation table number")
    p.add_argument("-seqfile", default=None)
    p.add_argument("-encseq", default=None)
    p.add_argument("-matchdesc", action="store_true")
    p.add_argument("-usedesc", action="store_true")
    p.add_argument("-o", default=None)
    p.set_defaults(func=cmd_snpper)


def _add_device(p, func) -> None:
    p.add_argument("-device", default="cuda", choices=["cuda", "cpu"],
                   help="where the device work runs (default cuda; "
                        "never falls back to the CPU)")
    p.set_defaults(func=func)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="genometools_torch",
        description="genometools_tpu tools ported to PyTorch/CUDA")
    sub = parser.add_subparsers(dest="tool", required=True)
    for add, func in ((_add_suffixerator, cmd_suffixerator),
                      (_add_seed_extend, cmd_seed_extend),
                      (_add_repfind, cmd_repfind),
                      (_add_encseq2spm, cmd_encseq2spm),
                      (_add_genomediff, cmd_genomediff),
                      (_add_shulengthdist, cmd_shulengthdist),
                      (_add_uniquesub, cmd_uniquesub),
                      (_add_matstat, cmd_matstat),
                      (_add_ltrharvest, cmd_ltrharvest),
                      (_add_tirvish, cmd_tirvish),
                      (_add_ltrclustering, cmd_ltrclustering),
                      (_add_ltrdigest, cmd_ltrdigest),
                      (_add_mkfmindex, cmd_mkfmindex),
                      (_add_prebwt, cmd_prebwt),
                      (_add_tagerator, cmd_tagerator),
                      (_add_mergeesa, cmd_mergeesa),
                      (_add_sain, cmd_sain)):
        _add_device(add(sub), func)
    for add, func in ((_add_tallymer, cmd_tallymer),
                      (_add_readjoiner, cmd_readjoiner),
                      (_add_packedindex, cmd_packedindex)):
        for p in add(sub):          # each subcommand's parser
            _add_device(p, func)
    # the annotation tools run on the host and take no -device
    for add in (_add_gff3, _add_stat, _add_convert_anno, _add_select,
                _add_feat_streams, _add_scriptfilter, _add_speck, _add_csa,
                _add_eval, _add_cds, _add_splicesiteinfo, _add_orffinder,
                _add_regioncov, _add_seqids, _add_loccheck,
                _add_gff3validator, _add_inlineseq_split,
                _add_inlineseq_add, _add_merge, _add_uniq, _add_interfeat,
                _add_extractfeat, _add_mkfeatureindex, _add_featureindex,
                _add_snpper):
        add(sub)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.func(args)
    except BrokenPipeError:
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return 0
