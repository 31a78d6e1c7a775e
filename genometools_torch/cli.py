"""gt-style command line for the port: ``python -m genometools_torch``.

The flags are copies of the reference's parsers
(``genometools_tpu/cli.py`` ``_add_suffixerator``, ``_add_seed_extend``
and ``_add_repfind``), so the tools accept the same command lines.
``-device {cuda,cpu}`` (default cuda) picks where the device work runs;
asking for cuda without a card fails. Flags the port does not support
yet raise instead of being ignored.
"""

from __future__ import annotations

import argparse
import sys


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
                        "(0 = off; default: all attached devices)")
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
    from .index.esa import build_esa, write_esa
    from .utils.options import Logger, Showtime
    _common_refusals(args)
    _refuse(args, [("-dist", lambda a: a.dist is not None)])
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
                    device=args.device)
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
    _refuse(args, [("-dist", lambda a: a.dist is not None)])
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


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="genometools_torch",
        description="genometools_tpu tools ported to PyTorch/CUDA")
    sub = parser.add_subparsers(dest="tool", required=True)
    _add_suffixerator(sub)
    _add_seed_extend(sub)
    _add_repfind(sub)
    for name, func in (("suffixerator", cmd_suffixerator),
                       ("seed_extend", cmd_seed_extend),
                       ("repfind", cmd_repfind)):
        p = sub.choices[name]
        p.add_argument("-device", default="cuda", choices=["cuda", "cpu"],
                       help="where the device work runs (default cuda; "
                            "never falls back to the CPU)")
        p.set_defaults(func=func)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)
