"""The port's repro-lint (`repro_torch.analysis`): golden tests and
parity with the JAX package's linter.

Each rule has a bad/good fixture pair under
``analysis_fixtures_torch/``: the bad file carries ``# expect: NFP00x``
trailing comments (one id per finding, several on a line when a line
has several) on the exact lines the analyzer must flag — rule id AND
line number are asserted — and the good file is the idiomatic rewrite
and must scan clean. On top of the pairs: suppression, the
malformed-directive rule (NFP000), baseline round-trip and staleness,
CLI exit codes, the framework-neutral parts held to `repro.analysis`
(directive grammar, finding keys, the JSON report), and the acceptance
check that the port lints clean modulo the committed baseline.
"""

import collections
import dataclasses
import json
import re
from pathlib import Path

import pytest

from repro.analysis import Finding as JaxFinding
from repro.analysis import report as jax_report
from repro.analysis.astutil import parse_directives as jax_parse_directives
from repro.analysis.cli import run_analysis as jax_run_analysis
from repro_torch.analysis import Finding, run_analysis
from repro_torch.analysis import baseline, report
from repro_torch.analysis.astutil import load_module, parse_directives
from repro_torch.analysis.callgraph import CallGraph
from repro_torch.analysis.cli import _iter_files, main
from repro_torch.analysis.cuda_rules import CapturedControlFlowRule
from repro_torch.analysis.rules import GraphKeyRule, ReplayRule

REPO = Path(__file__).resolve().parents[1]
FIXTURES = Path(__file__).parent / "analysis_fixtures_torch"
JAX_FIXTURES = Path(__file__).parent / "analysis_fixtures"
BASELINE = REPO / "nfp-torch-baseline.json"

BAD = ["nfp001_bad.py", "nfp002_bad.py", "nfp003_bad.py",
       "nfp004_bad.py", "nfp005_bad.py"]
GOOD = ["nfp001_good.py", "nfp002_good.py", "nfp003_good.py",
        "nfp004_good.py", "nfp005_good.py"]


def _findings(path: Path) -> list[Finding]:
    findings, _modules = run_analysis([path], REPO)
    return findings


def _expected(name: str) -> list[tuple[str, int]]:
    """(rule, line) pairs from the fixture's `# expect:` markers."""
    out = []
    for i, line in enumerate((FIXTURES / name).read_text().splitlines(), 1):
        m = re.search(r"# expect: ((?:NFP\d{3}\s*)+)", line)
        if m:
            out += [(r, i) for r in m.group(1).split()]
    assert out, f"{name} declares no expectations"
    return out


# -- golden pairs -------------------------------------------------------------

@pytest.mark.parametrize("name", BAD)
def test_bad_fixture_exact_findings(name):
    got = sorted((f.rule, f.line) for f in _findings(FIXTURES / name)
                 if f.active)
    assert got == sorted(_expected(name))


@pytest.mark.parametrize("name", GOOD)
def test_good_fixture_scans_clean(name):
    assert [f for f in _findings(FIXTURES / name) if f.active] == []


def test_numpy_of_a_tensor_is_not_a_sync():
    """`.numpy()` raises on a CUDA tensor, so NFP001 leaves it alone."""
    src = (FIXTURES / "nfp001_bad.py").read_text().splitlines()
    line = next(i for i, l in enumerate(src, 1) if ".numpy()" in l)
    assert line not in {f.line for f in _findings(FIXTURES / "nfp001_bad.py")}


# -- directives ---------------------------------------------------------------

def test_inline_suppression_keeps_finding_but_not_active():
    fs = _findings(FIXTURES / "nfp001_suppressed.py")
    assert len(fs) == 1
    f = fs[0]
    assert f.rule == "NFP001" and f.suppressed and not f.active
    assert "suppression syntax" in f.suppress_reason


def test_malformed_directives_report_nfp000_as_the_jax_linter_does():
    path = JAX_FIXTURES / "nfp000_malformed.py"
    src = path.read_text().splitlines()
    bad_lines = [i for i, l in enumerate(src, 1) if "# nfp:" in l]
    fs = _findings(path)
    assert sorted((f.rule, f.line) for f in fs) \
        == [("NFP000", i) for i in bad_lines]
    assert all(f.active for f in fs)        # malformed directives FAIL the run
    jax_fs, _ = jax_run_analysis([path], REPO)
    assert sorted((f.rule, f.line) for f in fs) \
        == sorted((f.rule, f.line) for f in jax_fs)


def _directive_lines() -> list[tuple[Path, list[str]]]:
    files = sorted(JAX_FIXTURES.glob("*.py")) \
        + sorted((REPO / "src" / "repro").rglob("*.py"))
    return [(p, p.read_text().splitlines()) for p in files]


def test_directive_grammar_equals_the_jax_linters():
    seen = 0
    for path, lines in _directive_lines():
        if not any("nfp:" in l for l in lines):
            continue
        mine = [dataclasses.asdict(d) for d in parse_directives(lines)]
        theirs = [dataclasses.asdict(d) for d in jax_parse_directives(lines)]
        assert mine == theirs, path
        seen += len(mine)
    assert seen >= 8                        # the fixtures' and the engine's


# -- baseline and report ------------------------------------------------------

def test_baseline_key_is_line_independent_and_the_jax_linters():
    a = Finding("NFP001", "a.py", 10, 0, "msg", "mod.fn")
    b = Finding("NFP001", "a.py", 99, 4, "msg", "mod.fn")
    assert a.key() == b.key()
    c = Finding("NFP002", "a.py", 10, 0, "msg", "mod.fn")
    assert a.key() != c.key()
    for f in (a, b, c):
        j = JaxFinding(f.rule, f.path, f.line, f.col, f.message, f.symbol)
        assert j.key() == f.key()


def test_json_report_has_the_jax_linters_schema():
    rows = [("NFP001", "a.py", 3, 1, "m1", "mod.f", False, "", True),
            ("NFP003", "b.py", 7, 0, "m2", "mod.g", True, "why", False),
            ("NFP000", "a.py", 1, 0, "m3", "<module>", False, "", False)]
    mine = [Finding(*r) for r in rows]
    theirs = [JaxFinding(*r) for r in rows]
    assert report.to_json(mine) == jax_report.to_json(theirs)
    assert report.to_text(mine, verbose=True) \
        == jax_report.to_text(theirs, verbose=True)


def test_baseline_roundtrip_marks_everything(tmp_path):
    bl = tmp_path / "bl.json"
    bad = FIXTURES / "nfp002_bad.py"
    baseline.save(bl, _findings(bad))
    fs = _findings(bad)
    matched, stale = baseline.apply(bl, fs)
    assert matched == len(fs) and stale == 0
    assert all(f.baselined and not f.active for f in fs)


def test_baseline_stale_entries_are_counted(tmp_path):
    bl = tmp_path / "bl.json"
    baseline.save(bl, _findings(FIXTURES / "nfp001_bad.py"))
    fs = _findings(FIXTURES / "nfp002_bad.py")      # none of these match
    matched, stale = baseline.apply(bl, fs)
    assert matched == 0
    assert stale == len(_findings(FIXTURES / "nfp001_bad.py"))
    assert all(f.active for f in fs)


def test_baseline_rewrite_keeps_reasons(tmp_path):
    bl = tmp_path / "bl.json"
    fs = _findings(FIXTURES / "nfp003_bad.py")
    baseline.save(bl, fs)
    data = json.loads(bl.read_text())
    data["findings"][0]["reason"] = "audited"
    bl.write_text(json.dumps(data))
    baseline.save(bl, _findings(FIXTURES / "nfp003_bad.py"))
    entries = json.loads(bl.read_text())["findings"]
    assert [e.get("reason") for e in entries] == ["audited", None]


# -- CLI ----------------------------------------------------------------------

def test_cli_exit_one_with_exactly_the_expected_rows(capsys):
    bad = FIXTURES / "nfp001_bad.py"
    rc = main([str(bad), "--repo-root", str(REPO)])
    assert rc == 1
    out = capsys.readouterr().out
    rows = collections.Counter(
        (m.group(2), int(m.group(1))) for m in
        re.finditer(r"nfp001_bad\.py:(\d+):\d+: (NFP\d{3}) ", out))
    assert rows == collections.Counter(_expected("nfp001_bad.py"))


@pytest.mark.parametrize("name", GOOD)
def test_cli_exit_zero_on_clean_file(name, capsys):
    assert main([str(FIXTURES / name), "--repo-root", str(REPO)]) == 0


def test_cli_json_report(tmp_path, capsys):
    out = tmp_path / "report.json"
    main([str(FIXTURES / "nfp004_bad.py"), "--repo-root", str(REPO),
          "--json", str(out)])
    data = json.loads(out.read_text())
    assert data["summary"]["active_by_rule"] == {"NFP004": 4}
    assert {f["rule"] for f in data["findings"]} == {"NFP004"}
    assert all(f["key"] for f in data["findings"])


def test_cli_update_then_check_with_baseline(tmp_path, capsys):
    bad = str(FIXTURES / "nfp005_bad.py")
    bl = tmp_path / "bl.json"
    assert main([bad, "--repo-root", str(REPO), "--baseline", str(bl),
                 "--update-baseline"]) == 0
    assert main([bad, "--repo-root", str(REPO),
                 "--baseline", str(bl)]) == 0


# -- the port ---------------------------------------------------------------

def _port_graph() -> CallGraph:
    files = _iter_files([REPO / "src" / "repro_torch",
                         REPO / "examples_torch"], REPO)
    return CallGraph([load_module(f, REPO) for f in files])


def test_the_ports_runners_caches_and_captured_bodies():
    g = _port_graph()
    assert set(ReplayRule(g).runners.static) == {
        "repro_torch.serving.graphs.StepGraphs.run",
        "repro_torch.launch.steps.DecodeStep.__call__"}
    caches = GraphKeyRule(g).caches
    entry = "repro_torch.serving.graphs.StepGraphs._entry"
    for m in ("inputs", "upload", "run", "capture"):
        assert caches[f"repro_torch.serving.graphs.StepGraphs.{m}"] \
            == ("key", entry)
    assert caches["repro_torch.launch.steps.DecodeStep._new"][1] \
        == "repro_torch.launch.steps.DecodeStep._new"
    captured = CapturedControlFlowRule(g).captured
    assert {"repro_torch.serving.graphs.StepGraphs._call",
            "repro_torch.launch.steps.DecodeStep._body",
            "repro_torch.models.model.paged_step",
            "repro_torch.kernels.nestedfp16_matmul.nestedfp16_matmul"} \
        <= captured


def test_port_lints_clean_modulo_committed_baseline(tmp_path, capsys):
    report_path = tmp_path / "report.json"
    rc = main(["--repo-root", str(REPO), "--baseline", str(BASELINE),
               "--json", str(report_path)])
    out = capsys.readouterr().out
    assert rc == 0, f"new repro-lint findings:\n{out}"
    assert re.search(r"0 active finding\(s\) \(\d+ suppressed, 1 baselined",
                     out), out
    fs = json.loads(report_path.read_text())["findings"]
    (bl,) = [f for f in fs if f["baselined"]]
    assert (bl["rule"], bl["symbol"]) == \
        ("NFP003", "repro_torch.serving.engine.Engine._run_chunk")
    assert "`take`" in bl["message"]
    assert all(f["suppress_reason"] for f in fs if f["suppressed"])
    entries = json.loads(BASELINE.read_text())["findings"]
    assert all(e.get("reason") for e in entries)
