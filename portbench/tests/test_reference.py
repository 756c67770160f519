"""The reference against the port's CPU plain path at reduced size,
through the harness's own run (the engine, its chunked prefill and
batched decode; the dense model in both precisions, the MoE in FP8), and
its frozen format arithmetic against the port's."""

import pytest
import torch

from portbench import program, reference as R, spec
from portbench.tests._cells import reduced_cell, run_reduced


def test_frozen_fp8_arithmetic_is_the_ports():
    from repro_torch.core import nestedfp as nf, quant

    g = torch.Generator().manual_seed(0)
    w = (torch.randn(257, 129, generator=g) * 0.3).half()
    w[0, :4] = torch.tensor([1.75, -1.75, 6e-8, 0.0]).half()
    up, _ = nf.encode(w)
    assert torch.equal(R.e4m3_weight(w), nf.fp8_dequant(up))
    x = torch.randn(7, 129, generator=g) * 5
    q, s = quant.quantize_act_per_token(x)
    assert torch.equal(R.act(x, "fp8"), q.float() * s)
    hi, _ = nf.split_bytes(x)
    assert torch.equal(R.kv(x, "fp8"), nf.e5m2_view(hi))
    assert torch.equal(R.kv(x, "fp16"), x.half().float())


@pytest.mark.parametrize("policy,limit", [("fp16", 1e-3), ("fp8", 0.1)])
def test_dense_engine_serves_the_references_tokens(policy, limit):
    cell = reduced_cell("dsc33b.chat.fp16", limit=limit, policy=policy)
    res = run_reduced(cell, 2**31 + 5)
    assert res["readings"]["served_tokens"] >= 100
    assert res["window"]["captured_in_window"] == 0
    assert res["correct"], res["readings"]


def test_moe_engine_serves_the_references_tokens_dropless():
    # the configuration deploys the port's MoE dropless
    # (`moe_capacity_factor` = experts / top_k), as the reference routes
    cfg = spec.read_json("configs", "granite-moe-3b-a800m")
    assert cfg["moe_capacity_factor"] == \
        cfg["num_local_experts"] / cfg["num_experts_per_tok"]
    cell = reduced_cell("dsc33b.chat.fp16", limit=0.05,
                        config="granite-moe-3b-a800m", policy="fp8")
    arch = program.port_config(cell.config)
    m = arch.moe
    assert m.top_k * m.capacity_factor / m.n_experts >= 1
    res = run_reduced(cell, 77)
    assert res["readings"]["served_tokens"] >= 100
    assert res["correct"], res["readings"]
