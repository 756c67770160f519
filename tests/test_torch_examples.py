"""The port's examples (`examples_torch/`) on the CPU: each script's
`main([..., "--device", "cpu"])` passes its own assertions, and what it
prints is held to the JAX package's functions on the same inputs."""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp                                  # noqa: E402

from _torch_parity import one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ("quickstart", "slo_trace_sim", "serve_dual_precision",
            "router_failover", "train_tiny")

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_prints_the_jax_functions_numbers(capsys):
    from repro.core import NestedLinearParams, NestedTensor, nested_linear
    assert _load("quickstart").main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()

    w = jnp.asarray(np.random.RandomState(0).uniform(-1.5, 1.5, (512, 256))
                    .astype(np.float16))
    nt = NestedTensor.from_f16(w)
    assert out[0] == (f"storage: upper {nt.upper.nbytes}B + lower "
                      f"{nt.lower.nbytes}B == f16 {w.nbytes}B  (zero "
                      f"overhead)")
    assert out[1] == "fp16 reconstruction: bit-exact ✓"
    w8, scale = nt.read_fp8()
    err = np.abs(np.asarray(w8, np.float32) * float(scale)
                 - np.asarray(w, np.float32))
    assert out[2] == f"fp8 view: max |err| = {err.max():.4f} (e4m3 grid)"
    x = jnp.asarray(np.random.RandomState(1).randn(4, 512).astype(np.float16))
    params = NestedLinearParams(weight=nt, bias=None)
    y16 = nested_linear(params, x, mode="fp16", out_dtype=jnp.float32)
    y8 = nested_linear(params, x, mode="fp8", out_dtype=jnp.float32)
    cos = float(jnp.sum(y16 * y8)
                / (jnp.linalg.norm(y16) * jnp.linalg.norm(y8)))
    got = float(re.fullmatch(r"fp16 vs fp8 output cosine: (\S+)",
                             out[3]).group(1))
    assert abs(got - round(cos, 5)) <= 1e-5


def test_slo_trace_sim_table_equals_the_jax_simulator(capsys):
    from repro.serving import simulate, trace
    assert _load("slo_trace_sim").main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()

    reqs = trace.azure_like(duration_s=60, mean_rate=5.05, seed=7,
                            prompt_len=256, max_new=512)
    cost = simulate.CostModel(fixed_ms=2.0, weight_read_ms_fp16=16.0,
                              weight_read_ms_fp8=8.0, kv_ms_per_ktoken=0.002,
                              compute_ms_per_token_fp16=0.055,
                              compute_ms_per_token_fp8=0.0275)
    want = [f"trace: {trace.rate_stats(reqs, 60)}",
            f"{'policy':8s} {'p90 TPOT':>9s} {'p90 TTFT':>9s} "
            f"{'SLO-viol s':>10s} {'%fp16':>6s} {'finished':>8s}"]
    for pol in ("fp16", "fp8", "dual"):
        r = simulate.simulate(reqs, cost, policy=pol)
        want.append(f"{pol:8s} {r.p90_tpot_ms:9.1f} {r.p90_ttft_ms:9.1f} "
                    f"{r.slo_violation_s:10.1f} {r.fp16_fraction*100:6.1f} "
                    f"{r.n_finished:8d}")
    assert out == want


@pytest.mark.parametrize("arch,planar,line", [
    ("qwen3-8b", False, r"prefix cache: hit rate \S+, blocks saved [1-9]"),
    ("gemma3-1b", True, r"sliding window: [1-9]\d* local-layer blocks "
                        r"reclaimed")])
def test_serve_dual_precision_passes_its_assertions(arch, planar, line,
                                                    capsys):
    argv = ["--arch", arch, "--device", "cpu"] + (["--kv-planar"] * planar)
    assert _load("serve_dual_precision").main(argv) == 0
    out = capsys.readouterr().out
    assert re.search(line, out), out
    trace = re.search(r"mode trace: ([H8]+)", out).group(1)
    assert "H" in trace and "8" in trace
    assert "finished requests: 15" in out


def test_router_failover_passes_its_assertions(capsys):
    assert _load("router_failover").main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "(8/8 streams, bit-identical); zero lost" in out
    assert "forced modes: {0: 'fp16', 1: 'fp16', 2: 'fp16'}" in out


def test_train_tiny_trains_and_writes_a_checkpoint(tmp_path, monkeypatch):
    from repro_torch.checkpoint import io
    from repro_torch.configs import get_arch
    from repro_torch.models.convert import leaves as leaves_of
    from repro_torch.models import model as M
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    # 6 steps: the launcher exits 0 only when the mean of the first 5
    # losses exceeds that of the last 5, which needs more than 5 steps
    assert _load("train_tiny").main(
        ["--fast", "--steps", "6", "--device", "cpu"]) == 0
    cfg = get_arch("qwen1.5-0.5b").reduced()
    tree, step = io.restore(str(tmp_path / "out" / "tiny_ckpt"),
                            {"params": M.init_params(cfg, device="meta")},
                            device="cpu")
    assert step == 6
    leaves = leaves_of(tree["params"])
    assert leaves and all(t.device.type == "cpu"
                          and bool(torch.isfinite(t).all()) for t in leaves)


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_need_the_card_unless_asked_for_the_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    argv = ["--fast"] if name == "train_tiny" else []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load(name).main(argv)
