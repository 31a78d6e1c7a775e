"""The `gt` scripting namespace: the driver's script-mode API.

The port's copy of ``genometools_tpu/gtscript.py`` (JAX-free
host code; the port imports nothing of the reference package).

Capability equivalent of the reference's embedded Lua surface
(ref: src/gtr.c:462-507 script fallback, src/gtlua/gt_lua.c
gt_lua_open_lib and the per-module exports under src/gtlua/).  The
redesign keeps the reference semantics — `genometools_torch <script>
[args...]` runs a user script with a ready-made `gt` namespace and `arg`
vector, and `genometools_torch -i` opens an interactive shell — with
Python as the scripting language (this package is the binding layer, so scripts get
the full framework rather than a wrapped subset; every gtlua export
below names the Lua function it mirrors).
"""

from __future__ import annotations

from types import SimpleNamespace


def _api() -> SimpleNamespace:
    import numpy as np

    from .anno import node_stream as _ns
    from .anno.feature_index import FeatureIndex
    from .anno.genome_node import (CommentNode, FeatureNode, MetaNode,
                                   Range, RegionNode, SequenceNode)
    from .anno.gff3 import gff3_to_string, parse_gff3
    from .core.alphabet import dna_alphabet, protein_alphabet
    from .core.encseq import Encseq
    from .core.trans_table import TransTable

    def gff3_out_stream_new(stream, out=None):
        """gtlua: gt.gff3_out_stream_new — terminal stream writing
        GFF3; returns the rendered text when out is None."""
        import io
        import sys
        buf = out or sys.stdout
        buf.write(gff3_to_string(list(stream)))
        return buf

    def feature_stream_new(in_stream, feature_index):
        """gtlua: gt.feature_stream_new."""
        return _ns.feature_stream(in_stream, feature_index)

    def region_mapping_new_seqfile(path):
        """gtlua: gt.region_mapping_new_seqfile — seqid -> sequence."""
        from .core.seqio import read_seqfiles
        ss = read_seqfiles([path])
        return {d.split()[0]: s for d, s in zip(ss.descs, ss.seqs)}

    ns = SimpleNamespace(
        # --- core (gtcore_lua.c, range_lua.c, alphabet_lua.c) --------
        range=lambda start, end: Range(start, end),
        alphabet_new_dna=dna_alphabet,
        alphabet_new_protein=protein_alphabet,
        translate_dna=lambda seq, scheme=1:
            TransTable(scheme).translate_str(seq),
        # --- encseq (encseq_lua.c) -----------------------------------
        encseq_loader=Encseq.load,
        encseq_from_files=Encseq.from_files,
        encseq_from_string=Encseq.from_string,
        # --- genome nodes (genome_node_lua.c, feature_node_lua.c) ----
        feature_node_new=lambda seqid, type_, start, end, strand=".":
            FeatureNode(seqid, type_, start, end, strand),
        region_node_new=lambda seqid, start, end:
            RegionNode(seqid, start, end),
        comment_node_new=CommentNode,
        meta_node_new=MetaNode,
        sequence_node_new=SequenceNode,
        # --- streams (genome_stream_lua.c + extended streams) --------
        gff3_in_stream_new_sorted=lambda path:
            _ns.sort_stream(_ns.gff3_in_stream(path)),
        gff3_in_stream_new_unsorted=_ns.gff3_in_stream,
        gff3_out_stream_new=gff3_out_stream_new,
        sort_stream_new=_ns.sort_stream,
        merge_stream_new=_ns.merge_stream,
        select_stream_new=_ns.select_stream,
        add_introns_stream_new=_ns.add_introns_stream,
        inter_feature_stream_new=_ns.inter_feature_stream,
        uniq_stream_new=_ns.uniq_stream,
        visitor_stream_new=_ns.visitor_stream,
        buffer_stream_new=_ns.BufferStream,
        array_out_stream_new=_ns.array_out_stream,
        script_wrapper_stream_new=_ns.script_wrapper_stream,
        # --- feature index (feature_index_lua.c, feature_stream_lua.c)
        feature_index_memory_new=FeatureIndex,
        feature_stream_new=feature_stream_new,
        feature_in_stream_new=_ns.feature_in_stream,
        # --- cds/csa streams (cds_stream_lua.c, csa_stream_lua.c) ----
        region_mapping_new_seqfile=region_mapping_new_seqfile,
        # --- io ------------------------------------------------------
        parse_gff3=parse_gff3,
        write_gff3=gff3_to_string,
        np=np,
    )

    def cds_stream_new(stream, region_mapping, source="gt"):
        """gtlua: gt.cds_stream_new (csa/cds via anno.cds)."""
        from .anno.cds import add_cds
        nodes = list(stream)
        add_cds(nodes, region_mapping, source=source)
        return iter(nodes)

    ns.cds_stream_new = cds_stream_new
    return ns


def run_script(path: str, argv: list[str]) -> int:
    """Execute a user script with the `gt` namespace and `arg` vector
    (ref: gtr.c:469 gt_lua_set_arg + luaL_dofile)."""
    import sys
    gt = _api()
    glob = {"__name__": "__main__", "__file__": path, "gt": gt,
            "arg": [path] + list(argv)}
    old_argv = sys.argv
    sys.argv = [path] + list(argv)
    try:
        with open(path) as f:
            code = compile(f.read(), path, "exec")
        exec(code, glob)                     # noqa: S102
        return 0
    except SystemExit as e:
        return int(e.code or 0)
    except Exception as exc:                 # noqa: BLE001
        print(f"genometools_torch: error: could not execute script {path}: "
              f"{type(exc).__name__}: {exc}", file=sys.stderr)
        return 1
    finally:
        sys.argv = old_argv


def interactive() -> int:
    """ref: gtr.c interactive mode (-i): a shell with `gt` loaded."""
    import code
    gt = _api()
    banner = ("genometools_torch interactive shell; the `gt` namespace is loaded "
              "(mirrors the reference's gtlua exports)")
    code.interact(banner=banner, local={"gt": gt})
    return 0
