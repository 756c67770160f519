"""The PyTorch port stands alone: no file under src/repro_torch/, and not
chip_smoke.py, imports jax, jaxlib or anything of the JAX package."""

import ast
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + sorted((ROOT / "examples_torch").glob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: Path) -> list[str]:
    mods = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.append(node.module or "")
    return mods


def test_port_has_files():
    assert len(PORT_FILES) > 10


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_scan_catches_forbidden_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\nfrom repro.core import quant\n"
                 "from repro_torch.core import quant as q2\n")
    mods = [m for m in _imported_modules(f) if m.split(".")[0] in FORBIDDEN]
    assert mods == ["jax.numpy", "repro.core"]


def test_scan_covers_the_roofline_and_the_dry_run():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"src/repro_torch/roofline/flops.py",
            "src/repro_torch/roofline/analysis.py",
            "src/repro_torch/launch/dryrun.py"} <= names


def test_scan_covers_the_examples_and_the_linter():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {f"examples_torch/{n}.py" for n in (
        "quickstart", "serve_dual_precision", "router_failover",
        "slo_trace_sim", "train_tiny")} <= names
    assert "src/repro_torch/analysis/rules.py" in names
