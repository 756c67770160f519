"""What the benchmark takes from the program under test, `repro_torch`:
its config registry (to hold the port's config to the configuration
file), its nesting of weights (`models/convert.py::to_serving`, K8 on
the card), the paged engine, and its launch counters. Nothing else of
the harness imports the port; the reference imports none of it.
"""

from __future__ import annotations

import dataclasses

import torch

from portbench import weights as W
from portbench.spec import Model


def port_config(cfg: dict):
    """The port's ArchConfig for a configuration file (`arch`, and with
    `"port_variant": "reduced"` its CPU-test variant), deployed as the
    file states where the port's config has the field (`rms_norm_eps`;
    an MoE's `moe_capacity_factor`) and held to every other size the
    file states: a difference raises."""
    from repro_torch.configs import get_arch

    arch = get_arch(cfg["arch"])
    if cfg.get("port_variant") == "reduced":
        arch = arch.reduced()
    arch = dataclasses.replace(arch, norm_eps=float(cfg["rms_norm_eps"]))
    if arch.moe and "moe_capacity_factor" in cfg:
        arch = dataclasses.replace(arch, moe=dataclasses.replace(
            arch.moe, capacity_factor=float(cfg["moe_capacity_factor"])))
    moe = arch.moe
    got = {"num_hidden_layers": arch.n_layers, "hidden_size": arch.d_model,
           "num_attention_heads": arch.n_heads,
           "num_key_value_heads": arch.n_kv_heads,
           "head_dim": arch.resolved_head_dim, "vocab_size": arch.vocab_size,
           "rope_theta": arch.rope_theta,
           "tie_word_embeddings": arch.tie_embeddings,
           "intermediate_size": moe.d_ff_expert if moe else arch.d_ff}
    if moe:
        got.update(num_local_experts=moe.n_experts,
                   num_experts_per_tok=moe.top_k)
        want_pad = cfg.get("assumed", {}).get("experts_padded_to")
        if want_pad != moe.n_experts_padded:
            raise ValueError(f"{cfg['name']}: the port pads experts to "
                             f"{moe.n_experts_padded}, the file says "
                             f"{want_pad}")
    if arch.qk_norm or arch.qkv_bias or arch.sliding_window or arch.mla:
        raise ValueError(f"{cfg['name']}: the port's {cfg['arch']} has a "
                         f"mechanism the benchmark's reference lacks")
    bad = {k: (cfg.get(k), v) for k, v in got.items() if cfg.get(k) != v}
    if bad:
        raise ValueError(f"{cfg['name']}: the port's config differs from "
                         f"the file (file, port): {bad}")
    return arch


def serving_params(m: Model, seed: int, device) -> dict:
    """The benchmark's weights, nested by the port layer by layer: each
    layer is drawn, handed to `to_serving` and its f16 draw dropped."""
    from repro_torch.models.convert import to_serving

    params = to_serving(W.top(m, seed, device))
    params["layers"] = [to_serving(W.layer(m, seed, i, device))
                        for i in range(m.n_layers)]
    return params


def engine(arch, params, cell_engine: dict, policy: str, device):
    """The port's paged engine as the cell deploys it: planar KV, the
    forced policy, the prefix cache on and the host tier off."""
    from repro_torch.serving.engine import Engine

    return Engine(arch, params, forced_mode=policy, kv_planar=True,
                  host_offload=False, prefix_cache=True, device=device,
                  **cell_engine)


def request(rid: str, tokens: list[int], max_new: int):
    from repro_torch.serving.engine import Request

    return Request(rid, tokens, max_new)


def _no_model(rt, params, cfg, tokens, *args, **kwargs):
    return torch.zeros(tokens.shape[0], dtype=torch.int32)


def schedule_engine(arch, cell_engine: dict, policy: str):
    """A CPU engine with the cell's scheduler settings and a model step
    that returns token 0: it walks the same schedule as the card's engine
    (the closed loop's schedule depends on the lengths alone: no stop
    tokens, no shared prefixes), so the step keys it makes are the keys
    the run will reach. Its pool is one layer of one head."""
    tiny = dataclasses.replace(arch, n_layers=1, n_kv_heads=1, n_heads=1,
                               head_dim=8, d_model=8, d_ff=8, moe=None,
                               family="dense")
    eng = engine(tiny, {}, cell_engine, policy, "cpu")
    eng.graphs.step_fn = _no_model
    return eng


def step_keys(eng) -> set:
    return eng.graphs.keys()


def capture(eng, key) -> None:
    eng.graphs.capture(key)


def n_captured(eng) -> int:
    return eng.graphs.n_captured


def pool_bytes(eng) -> int:
    from repro_torch.serving.graphs import pool_bytes as pb

    return pb(eng.graphs._pool)


def launch_counts() -> dict[str, int]:
    from repro_torch.kernels import ops

    return ops.all_launch_counters()


def build_kernels() -> None:
    """Compile (first run in a checkout) or find every kernel of the
    port, in its fixed build directory inside the checkout."""
    from repro_torch.kernels import _build

    _build.build_all()
