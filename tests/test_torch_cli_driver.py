"""The port's CLI driver (``genometools_torch.cli.main``) against the
reference's (``genometools_tpu.cli.main``), both run in this process:
the option constraints (exit 2 with the reference's message), the
``$GT_ENV_OPTIONS`` switches, ``-createman``, the script fallback, the
set of commands, and ``graft.entry`` against the root
``__graft_entry__.entry``.

The two programs have different names (``gt-tpu`` and
``genometools_torch``); messages are compared after the name.
"""

import os
import re
import sys
from pathlib import Path

import numpy as np
import pytest

from test_torch_anno import _run

ROOT = Path(__file__).resolve().parents[1]
ATINSERT = ROOT / "tests" / "golden_esa" / "Atinsert.fna" / "idx"

# (tool, argv after the tool) that the reference refuses with exit 2
CONSTRAINED = {
    "suffixerator_parts_memlimit": ["suffixerator", "-db", "x.fa", "-parts",
                                    "2", "-memlimit", "1MB"],
    "seed_extend_greedy_xdrop": ["seed_extend", "-ii", "idx",
                                 "-extendgreedy", "-extendxdrop"],
    "seed_extend_xdrop_history": ["seed_extend", "-ii", "idx",
                                  "-extendxdrop", "-history", "32"],
    "seed_extend_xdrop_maxalilendiff": ["seed_extend", "-ii", "idx",
                                        "-extendxdrop", "-maxalilendiff",
                                        "10"],
    "seed_extend_xdrop_percmathistory": ["seed_extend", "-ii", "idx",
                                         "-extendxdrop", "-percmathistory",
                                         "50"],
    "seed_extend_pick_without_parts": ["seed_extend", "-ii", "idx", "-pick",
                                       "1,2"],
    "repfind_greedy_xdrop": ["repfind", "-l", "14", "-ii", "idx",
                             "-extendgreedy", "-extendxdrop"],
    "repfind_minidentity_alone": ["repfind", "-l", "14", "-ii", "idx",
                                  "-minidentity", "90"],
    "repfind_maxalilendiff_without_greedy": ["repfind", "-l", "14", "-ii",
                                             "idx", "-maxalilendiff", "10"],
    "repfind_percmathistory_with_xdrop": ["repfind", "-l", "14", "-ii",
                                          "idx", "-extendxdrop",
                                          "-percmathistory", "50"],
}


def _after_name(text: str) -> str:
    """The last line of a message with the program's name cut off."""
    last = text.rstrip("\n").splitlines()[-1]
    return re.sub(r"^(gt-tpu|genometools_torch)", "", last)


@pytest.mark.parametrize("case", sorted(CONSTRAINED))
def test_option_constraints_exit_2(case, tmp_path):
    from genometools_tpu.cli import main as ref_main

    from genometools_torch.cli import main
    argv = CONSTRAINED[case]
    ref = _run(ref_main, argv, tmp_path)
    got = _run(main, argv, tmp_path)
    assert ref[0] == got[0] == ("exit", 2)
    assert ref[1] == got[1] == ""
    assert _after_name(got[2]) == _after_name(ref[2])
    assert ": error: option \"-" in got[2]


@pytest.mark.parametrize("parts,pick", [("2", "1,2"), ("3", "2,3")])
def test_pick_with_parts_passes_constraints(parts, pick, tmp_path):
    """-pick with -parts passes the table and runs a cell of the grid."""
    from genometools_tpu.cli import main as ref_main

    from genometools_torch.cli import main
    argv = ["seed_extend", "-ii", str(ATINSERT), "-l", "20", "-parts",
            parts, "-pick", pick]
    ref = _run(ref_main, argv + ["--cpu"], tmp_path)
    got = _run(main, argv + ["-device", "cpu"], tmp_path)
    assert got == ref
    assert got[0] == 0 and got[1]


def test_pick_with_one_part_runs_the_whole_grid(tmp_path):
    """-parts 1 -pick 1,1: the reference's seed_extend refuses it with
    exit 1 after the table has passed it (a check of args.parts <= 1 in
    cmd_seed_extend); the port has no such check and runs its one cell,
    the whole self-comparison."""
    from genometools_tpu.cli import main as ref_main

    from genometools_torch.cli import main
    argv = ["seed_extend", "-ii", str(ATINSERT), "-l", "20", "-parts", "1"]
    ref = _run(ref_main, argv + ["-pick", "1,1", "--cpu"], tmp_path)
    assert ref[0] == ("exit", 'option "-pick" requires option "-parts"')
    whole = _run(ref_main, argv + ["--cpu"], tmp_path)
    got = _run(main, argv + ["-pick", "1,1", "-device", "cpu"], tmp_path)
    assert got == whole
    assert got[0] == 0 and got[1]


def _pop(*names):
    for n in names:
        os.environ.pop(n, None)


def _time_masked(text: str) -> str:
    return re.sub(r"(# TIME .*) \d+\.\d\d$", r"\1 T", text, flags=re.M)


@pytest.mark.parametrize("options", ["-bogus -showtime", "-showtime",
                                     "-bogus"])
def test_env_options_showtime_and_unknown(options, tmp_path):
    from genometools_tpu.cli import main as ref_main

    from genometools_torch.cli import main
    fa = tmp_path / "in.fa"
    fa.write_text(">a\nacgtacgtaacgttgca\n>b\nttgacgatcagt\n")
    out = {}
    for side, fn, extra in (("ref", ref_main, ["--cpu"]),
                            ("port", main, ["-device", "cpu"])):
        _pop("GT_SHOWTIME")
        os.environ["GT_ENV_OPTIONS"] = options
        try:
            out[side] = _run(fn, ["suffixerator", "-db", str(fa),
                                  "-indexname", side, "-suf", "-lcp"] +
                             extra, tmp_path)
        finally:
            _pop("GT_ENV_OPTIONS", "GT_SHOWTIME")
    ref, got = out["ref"], out["port"]
    assert got[:2] == ref[:2] == (0, "")
    assert _time_masked(got[2]) == _time_masked(ref[2])
    err = got[2].splitlines()
    assert ('error parsing $GT_ENV_OPTIONS: unknown option: "-bogus"' in
            err) == ("-bogus" in options)
    ntime = sum(line.startswith("# TIME ") for line in err)
    assert ntime == (3 if "-showtime" in options else 0)
    assert (tmp_path / "port.suf").read_bytes() == \
        (tmp_path / "ref.suf").read_bytes()


@pytest.mark.parametrize("bookkeeping", [None, "on"])
def test_env_options_spacepeak(bookkeeping, tmp_path, monkeypatch):
    import genometools_tpu.utils.spacepeak as rsp
    from genometools_tpu.cli import main as ref_main

    import genometools_torch.utils.spacepeak as tsp
    from genometools_torch.cli import main
    calls = []
    for mod in (rsp, tsp):
        monkeypatch.setattr(mod, "show_at_exit",
                            lambda mod=mod: calls.append(mod.__name__))
    monkeypatch.setenv("GT_ENV_OPTIONS", "-spacepeak")
    if bookkeeping:
        monkeypatch.setenv("GT_MEM_BOOKKEEPING", bookkeeping)
    else:
        monkeypatch.delenv("GT_MEM_BOOKKEEPING", raising=False)
    ref = _run(ref_main, ["linspace_align", "-ss", "acgt", "agt"], tmp_path)
    got = _run(main, ["linspace_align", "-ss", "acgt", "agt"], tmp_path)
    assert got == ref
    assert ref[0] == 0 and "# score" in ref[1]
    assert ("GT_MEM_BOOKKEEPING=on" in got[2]) == (bookkeeping is None)
    assert calls == ["genometools_tpu.utils.spacepeak",
                     "genometools_torch.utils.spacepeak"]


def _manpage_normal(text: str, ref: bool) -> str:
    """A man page with the program's name mapped onto the port's and the
    platform flag (--cpu in the reference, -device in the port) taken
    out."""
    if ref:
        for a, b in (("gt-tpu", "genometools_torch"),
                     ("GT-TPU", "GENOMETOOLS_TORCH"),
                     ("GenomeTools-TPU", "GenomeTools-Torch"),
                     ("genometools_tpu repository",
                      "genometools_torch repository")):
            text = text.replace(a, b)
    lines = text.split("\n")
    lines[1] = "=" * len(lines[0])          # the title's underline
    text = "\n".join(lines)
    text = re.sub(r"\*--cpu\* \['yes\|no'\]::\ncpu \(default: no\)\n\n?",
                  "", text)
    text = re.sub(r"\*-device\* \['\.\.\.'\]::\n[^\n]*\(default: cuda\)"
                  r"\n\n?", "", text)
    text = re.sub(r"DESCRIPTION\n-+\n\n(?=REPORTING)", "", text)
    return text.replace(" [--cpu]", "").replace(" [-device ...]", "")


def test_createman_matches_reference(tmp_path):
    from genometools_tpu.cli import main as ref_main

    from genometools_torch.cli import main
    ref = _run(ref_main, ["-createman", "ref"], tmp_path)
    got = _run(main, ["-createman", "port"], tmp_path)
    assert ref[0] == got[0] == 0
    assert got[2] == ref[2].replace(" ref\n", " port\n")
    want = {p.name.replace("gt-tpu", "genometools_torch"):
            _manpage_normal(p.read_text(), True)
            for p in (tmp_path / "ref").iterdir()}
    have = {p.name: _manpage_normal(p.read_text(), False)
            for p in (tmp_path / "port").iterdir()}
    assert sorted(have) == sorted(want)
    assert len(have) == 112
    differ = sorted(f for f in have if have[f] != want[f])
    # the driver's one-line description, and the port's -dist help,
    # which names the bound on the attached cards
    assert differ == ["genometools_torch.mansrc",
                      "genometools_torch_suffixerator.mansrc"]
    for f, old, new in (
            ("genometools_torch.mansrc",
             "TPU-native sequence indexing and matching toolkit",
             "genometools_tpu tools ported to PyTorch/CUDA"),
            ("genometools_torch_suffixerator.mansrc",
             "default: all attached devices)",
             "default: all attached devices; at most the attached cards, "
             "a power of two)")):
        assert have[f] == want[f].replace(old, new)


SCRIPT = """\
import sys
print("args", arg[1:])
print(gt.translate_dna("atgaaacccggg"))
seqs = gt.region_mapping_new_seqfile(arg[1])
print(sorted(seqs))
sys.stderr.write("done\\n")
"""


@pytest.mark.parametrize("script", ["ok", "raises", "exits", "missing"])
def test_script_fallback(script, tmp_path):
    from genometools_tpu.cli import main as ref_main

    from genometools_torch.cli import main
    fa = tmp_path / "in.fa"
    fa.write_text(">one x\nacgt\n>two\nttga\n")
    path = tmp_path / "s.py"
    path.write_text({"ok": SCRIPT,
                     "raises": SCRIPT + "raise KeyError('k')\n",
                     "exits": SCRIPT + "sys.exit(3)\n",
                     "missing": ""}[script])
    if script == "missing":
        path.unlink()
    argv = [str(path), str(fa), "-x"]
    ref = _run(ref_main, argv, tmp_path)
    got = _run(main, argv, tmp_path)
    assert got[0] == ref[0] == {"ok": 0, "raises": 1, "exits": 3,
                                "missing": 1}[script]
    assert got[1] == ref[1]
    assert _after_name(got[2]) == _after_name(ref[2])
    if script == "ok":
        assert got[1].splitlines()[:2] == [f"args ['{fa}', '-x']", "MKPG"]
    if script == "missing":
        assert "neither tool nor script" in got[2]


def _tools(parser):
    import argparse
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return sub.choices


def test_parser_offers_every_reference_command():
    import argparse

    from genometools_tpu import cli as ref_cli

    from genometools_torch.cli import build_parser
    ref = argparse.ArgumentParser()
    sub = ref.add_subparsers(dest="tool")
    for add in ref_cli._REGISTER:
        add(sub)
    ref_tools, tools = _tools(ref), _tools(build_parser())
    assert sorted(tools) == sorted(ref_tools)
    assert len(tools) == 85
    assert sorted(_tools(tools["dev"])) == sorted(_tools(ref_tools["dev"]))
    assert len(_tools(tools["dev"])) == 8
    # each subcommand of encseq, condenseq, compreads too
    for name in ("encseq", "condenseq", "compreads", "tallymer",
                 "readjoiner", "packedindex"):
        assert sorted(_tools(tools[name])) == \
            sorted(_tools(ref_tools[name])), name


def test_graft_entry_matches_reference():
    import jax

    sys.path.insert(0, str(ROOT))
    import __graft_entry__ as ref_graft

    from genometools_torch import graft
    from genometools_torch.index.suffix import build_suffix_array
    rfn, (rkeys,) = ref_graft.entry()
    fn, (keys,) = graft.entry("cpu")
    assert np.array_equal(keys.numpy(), rkeys)
    sa = fn(keys).numpy()
    assert np.array_equal(sa, np.asarray(jax.jit(rfn)(rkeys)))
    want, _ = build_suffix_array(keys, with_lcp=False, device="cpu")
    assert np.array_equal(sa, want.numpy())
    assert sa.size == 1 << 16
