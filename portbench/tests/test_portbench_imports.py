"""What the benchmark imports: no module of portbench/ imports JAX or
the JAX package (top-level names compared whole: the port's name
begins with the JAX package's), and the plain references import
nothing of the port either."""

import ast
from pathlib import Path

PORTBENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "genometools_tpu"}


def _top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and \
                getattr(node.func, "attr", "") == "import_module" and \
                node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_no_jax_anywhere():
    files = sorted(PORTBENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert not _top_level_imports(f) & FORBIDDEN, f


def test_the_port_is_genometools_torch_not_its_prefix():
    names = set()
    for f in PORTBENCH.rglob("*.py"):
        names |= _top_level_imports(f)
    assert "genometools_torch" in names
    assert "genometools_tpu" not in names


def test_references_import_nothing_of_the_port():
    for f in sorted((PORTBENCH / "reference").rglob("*.py")):
        tops = _top_level_imports(f)
        assert tops <= {"__future__", "math", "numpy", "torch",
                        "itertools"}, (f, tops)
        tree = ast.parse(f.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.level:
                assert node.level == 1, f        # siblings only


def test_forbidden_modules_compares_whole_names():
    from portbench.harness import forbidden_modules
    assert forbidden_modules(["genometools_torch.index", "jaxtyping",
                              "numpy"]) == []
    assert forbidden_modules(["jax.numpy", "genometools_tpu.cli",
                              "flax"]) == ["flax", "genometools_tpu", "jax"]
