"""The port's training loss and its gradients against the JAX package's,
for the attention families of `ASSIGNED` (dense, gemma3's windows, vlm),
reduced, in f32 activations, on the JAX `M.init_params` weights and the
same `SyntheticLM` batch: `train_loss` and its metrics within 1e-5, each
gradient leaf within a relative L2 of 1e-4 (`_torch_parity.
assert_train_pair`). The MoE, ssm, hybrid and encdec families are in
`test_torch_train_families.py`."""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from _torch_parity import (assert_train_pair, one_torch_thread,  # noqa: E402,F401
                           train_pair)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


# 40 tokens: past gemma3-1b reduced's window of 19
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "qwen3-8b",
                                  "deepseek-coder-33b", "gemma3-1b",
                                  "phi-3-vision-4.2b"])
def test_train_loss_and_grads_match_jax(arch):
    assert_train_pair(train_pair(arch, seq=40))


def test_window_changes_the_loss():
    """gemma3-1b's local layers see 19 keys: the same weights without the
    window give another loss, so the windowed comparison above holds the
    window itself."""
    import dataclasses

    import torch
    from repro_torch.models import model as TM
    from repro_torch.models.layers import Runtime
    r = train_pair("gemma3-1b", seq=40)
    rt = Runtime(mode="train", dtype=torch.float32)
    batch = {k: torch.from_numpy(v) for k, v in r["batch"].items()}
    with torch.no_grad():
        free = TM.train_loss(rt, r["tparams"], dataclasses.replace(
            r["tcfg"], sliding_window=None), batch)[0]
    assert abs(float(free) - r["tloss"]) > 1e-4
