"""The port's training loss and gradients against the JAX package's for
the MoE (granite-moe-3b, deepseek-v3 with MLA and its multi-token
prediction head), ssm (mamba2), hybrid (zamba2) and encdec (seamless)
families of `ASSIGNED`, reduced, in f32 activations, as
`test_torch_train_loss.py` holds the attention families. MoE rows are
held under ROADMAP's routing-flip rule: both sides' per-layer router
logits over the batch must choose the same experts at every position
(then loss and gradients are held at the tolerance), or part only at
router near-ties."""

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import torch                                                   # noqa: E402
from _torch_parity import (assert_train_pair, jax_router_logits,  # noqa: E402,F401
                           one_torch_thread, routing_flips, train_pair)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _port_router_logits(r) -> list:
    """The port's per-layer router logits over the batch's inputs,
    from the train phase's aux dicts."""
    from repro_torch.models import model as TM
    from repro_torch.models.layers import Runtime
    rt = Runtime(mode="train", dtype=torch.float32)
    tokens = torch.from_numpy(r["batch"]["tokens"][:, :-1]).long()
    got: list = []
    with torch.no_grad():
        h = TM.embed_tokens(rt, r["tparams"], r["tcfg"], tokens)
        pos = torch.arange(h.shape[1])[None, :]
        TM.run_decoder_stack(rt, r["tparams"]["layers"], r["tcfg"], h,
                             phase="train", positions=pos, aux=got)
    return [a["router_logits"].numpy() for a in got]


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "deepseek-v3-671b"])
def test_moe_train_loss_and_grads_match_jax(arch):
    import jax.numpy as jnp
    from repro.models.layers import Runtime as JRuntime
    r = train_pair(arch, seq=40)
    want = jax_router_logits(JRuntime(mode="train", dtype=jnp.float32),
                             r["jparams"], r["jcfg"],
                             np.asarray(r["batch"]["tokens"][:, :-1]))
    flips = routing_flips(_port_router_logits(r), want,
                          r["jcfg"].moe.top_k)
    assert flips["near_tie"], flips
    if flips["flips"] == 0:
        assert_train_pair(r)
    else:           # a near-tie flip moves the loss: it must stay close
        assert abs(r["tloss"] - r["jloss"]) <= 1e-2 * abs(r["jloss"])


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b",
                                  "seamless-m4t-large-v2"])
def test_train_loss_and_grads_match_jax(arch):
    """40 tokens: two SSD chunks of 32 (the second padded); zamba2's
    shared block after layer 1; seamless's 64 stub frames."""
    assert_train_pair(train_pair(arch, seq=40))


def test_mtp_head_is_in_the_loss():
    """deepseek-v3's loss carries 0.1 of the MTP loss: its head's
    gradients are nonzero and the loss exceeds ce + z-loss + aux."""
    r = train_pair("deepseek-v3-671b", seq=24)
    g = r["tparams"]["mtp"]["proj"]["w"].grad
    assert g is not None and float(g.abs().max()) > 0
    m = r["tmetrics"]
    assert r["tloss"] > m["ce"] + m["moe_lb_loss"] + m["moe_z_loss"]
