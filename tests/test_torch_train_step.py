"""The port's train step and training CLI against the JAX package's:
`launch/steps.py::make_train_step` (TRAIN_RT, microbatched) step by step
against the jitted JAX step on the same weights and batches, the ports of
`test_substrate.py`'s training checks, and `launch/train.py --ckpt` on
the CPU, served by `launch/serve.py --ckpt`."""

import json

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax                                                     # noqa: E402
import jax.numpy as jnp                                        # noqa: E402
import torch                                                   # noqa: E402
from _torch_parity import configs, flatten_serving, one_torch_thread  # noqa: E402,F401

from repro.data.pipeline import DataConfig as JDataConfig      # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM    # noqa: E402
from repro.data.pipeline import microbatch_split as j_split    # noqa: E402
from repro.launch.steps import TRAIN_RT as JTRAIN_RT           # noqa: E402
from repro.launch.steps import make_train_step as j_make_train_step  # noqa: E402
from repro.models.layers import Runtime as JRuntime             # noqa: E402
from repro.models import model as JM                           # noqa: E402
from repro.optim import adamw as JA                            # noqa: E402
from repro_torch.data.pipeline import (DataConfig, SyntheticLM,  # noqa: E402
                                       microbatch_split)
from repro_torch.launch import serve as TSERVE                 # noqa: E402
from repro_torch.launch import train as TTRAIN                 # noqa: E402
from repro_torch.launch.steps import TRAIN_RT, make_train_step  # noqa: E402
from repro_torch.models import model as TM                     # noqa: E402
from repro_torch.models.convert import from_jax_serving        # noqa: E402
from repro_torch.models.layers import Runtime                  # noqa: E402
from repro_torch.optim import adamw as TA                      # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _port_params(jparams, n_layers):
    return from_jax_serving(flatten_serving(jparams), n_layers, device="cpu")


def _five_steps(jrt, trt, check):
    """qwen1.5-0.5b reduced, 2 microbatches of 2 x 64 tokens, 5 steps from
    the same weights through the jitted JAX step (its `TRAIN_RT` set to
    `jrt` for the call) and the port's step (its `TRAIN_RT` set to `trt`);
    check(i, name, got,
    want) for each step's loss, grad_norm and lr. Returns both final
    trees."""
    import repro.launch.steps as jsteps
    import repro_torch.launch.steps as tsteps
    jcfg, tcfg = configs("qwen1.5-0.5b")
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = _port_params(jp, jcfg.n_layers)
    kw = dict(lr=1e-3, total_steps=5, warmup_steps=2)
    jopt_cfg, topt_cfg = JA.AdamWConfig(**kw), TA.AdamWConfig(**kw)
    jopt, topt = JA.init_state(jopt_cfg, jp), TA.init_state(topt_cfg, tp)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsteps, "TRAIN_RT", jrt)
        mp.setattr(tsteps, "TRAIN_RT", trt)
        jstep = jax.jit(j_make_train_step(jcfg, jopt_cfg))
        tstep = make_train_step(tcfg, topt_cfg)
        batches = JSyntheticLM(jcfg, JDataConfig(seq_len=64, global_batch=4)
                               ).batches(5)
        for i, batch in enumerate(batches):
            jp, jopt, jm = jstep(jp, jopt, j_split(
                {k: jnp.asarray(v) for k, v in batch.items()}, 2))
            tp, topt, tm = tstep(tp, topt, microbatch_split(batch, 2))
            for k in ("loss", "grad_norm", "lr"):
                check(i, k, float(tm[k]), float(jm[k]))
            assert int(topt["step"]) == int(jopt["step"]) == i + 1
    return jp, tp


def test_train_step_matches_jax_step_over_five_steps():
    """In f32 activations: every step's loss, grad_norm and lr within
    1e-4 of the JAX step's (relative), and the params after the five
    updates within 1e-4 of the largest weight."""
    def check(i, k, got, want):
        assert abs(got - want) <= 1e-4 * abs(want), (i, k, got, want)
    jp, tp = _five_steps(JRuntime(mode="train", dtype=jnp.float32),
                         Runtime(mode="train", dtype=torch.float32), check)
    want = np.asarray(jp["layers"]["attn"]["wq"]["w"][1])
    got = tp["layers"][1]["attn"]["wq"]["w"].detach().numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_train_step_in_train_rt_tracks_jax_step():
    """In TRAIN_RT (bf16 activations) on both sides: each side rounds
    every activation and every activation gradient to bf16 (2^-8) after
    sums taken in other orders, so per-leaf gradients part by ~1 %
    (relative L2) and the step-0 grad_norm by 1.4e-4. Held: the loss
    within 1e-3 and grad_norm within 1e-2 of the JAX step's every step,
    lr within 1e-6 (the schedule in f32, one ulp apart at most)."""
    lim = {"loss": 1e-3, "grad_norm": 1e-2, "lr": 1e-6}

    def check(i, k, got, want):
        assert abs(got - want) <= lim[k] * abs(want), (i, k, got, want)
    _five_steps(JTRAIN_RT, TRAIN_RT, check)


def test_microbatched_matches_unmicrobatched_grads():
    """Gradients summed over 4 microbatches of one row each, / 4, equal
    the whole batch's (linearity; relative L2 < 1e-4), as
    test_substrate.py holds the JAX package's."""
    _, cfg = configs("qwen1.5-0.5b")
    rt = Runtime(mode="train", dtype=torch.float32)
    params = TM.init_params(cfg, seed=0, device="cpu")
    for p, _ in TA.leaves(params):
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in next(SyntheticLM(
        cfg, DataConfig(seq_len=32, global_batch=4)).batches(1)).items()}

    def grads(b):
        for p, _ in TA.leaves(params):
            p.grad = None
        TM.train_loss(rt, params, cfg, b)[0].backward()
        return [p.grad.double().ravel() for p, _ in TA.leaves(params)]
    full = torch.cat(grads(batch))
    acc = None
    for i in range(4):
        g = grads({k: v[i:i + 1] for k, v in batch.items()})
        acc = [x / 4 for x in g] if acc is None else \
            [a + x / 4 for a, x in zip(acc, g)]
    rel = torch.linalg.norm(full - torch.cat(acc)) / torch.linalg.norm(full)
    assert rel < 1e-4, float(rel)


def test_loss_decreases_tiny_model():
    """30 steps of the train step on qwen1.5-0.5b reduced (8 x 64 tokens
    in 2 microbatches, lr 1e-3): the loss falls by more than 0.2."""
    _, cfg = configs("qwen1.5-0.5b")
    params = TM.init_params(cfg, seed=0, device="cpu")
    opt_cfg = TA.AdamWConfig(lr=1e-3, total_steps=30, warmup_steps=2)
    opt = TA.init_state(opt_cfg, params)
    step = make_train_step(cfg, opt_cfg)
    losses = []
    for batch in SyntheticLM(cfg, DataConfig(seq_len=64, global_batch=8)
                             ).batches(30):
        params, opt, metrics = step(params, opt, microbatch_split(batch, 2))
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.2, losses[::6]


def test_cli_trains_checkpoints_and_serves(tmp_path, capsys):
    """`launch.train --reduced --device cpu --ckpt DIR` exits 0 (the loss
    fell by its rule) and writes {"params", "opt"} at its last step;
    `launch.serve --ckpt DIR --device cpu` serves every request from it."""
    ck = str(tmp_path / "ckpt")
    rc = TTRAIN.main(["--arch", "qwen1.5-0.5b", "--reduced", "--steps", "12",
                      "--batch", "4", "--seq", "32", "--micro", "2",
                      "--device", "cpu", "--ckpt", ck, "--log-every", "4"])
    out = capsys.readouterr().out
    summary = json.loads([ln for ln in out.splitlines()
                          if ln.startswith("{")][-1])
    assert rc == 0 and summary["improvement"] > 0, out
    index = json.loads((tmp_path / "ckpt" / "index.json").read_text())
    assert index["step"] == 12
    assert "['opt']['m']['layers']['attn']['wq']['w']" in index["keys"]
    assert "['opt']['step']" in index["keys"]
    rc = TSERVE.main(["--arch", "qwen1.5-0.5b", "--reduced", "--device",
                      "cpu", "--ckpt", ck, "--requests", "4", "--max-new",
                      "4"])
    served = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rc == 0 and served["finished"] == 4 and served["tokens"] == 16
