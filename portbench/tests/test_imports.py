"""The import check compares top-level module names whole, and the
reference imports nothing of the port or of JAX."""

import ast
import sys
import types

from portbench import spec

REFERENCE_SIDE = ("reference.py", "weights.py", "spec.py", "reckon.py")


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_forbidden_names_are_compared_whole(monkeypatch):
    from portbench import run

    for name in ("repro_torch", "repro_torch.models", "reprox", "jaxtyping",
                 "benchmarks_extra"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.models",
                        types.ModuleType("repro.models"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert run.forbidden_modules() == ["jaxlib", "repro"]


def test_the_reference_side_imports_nothing_of_the_port():
    for name in REFERENCE_SIDE:
        tops = {m.split(".")[0] for m in _imports(spec.ROOT / name)}
        assert tops <= {"__future__", "dataclasses", "importlib", "json",
                        "re", "sys", "pathlib", "math", "numpy", "torch",
                        "portbench"}, (name, tops)
        assert not any(m.startswith("portbench.program")
                       or m.startswith("portbench.run")
                       for m in _imports(spec.ROOT / name))


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in spec.ROOT.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "repro", "benchmarks"}, \
            path
