"""Reduced cells for the CPU tests: a configuration file's CPU-test
variant (the port's `ArchConfig.reduced()`, 2 layers at d_model 256),
a short chat mix and a small engine, driven through the harness's own
`run_cell` on the CPU. A reduced model's least decode time is
microseconds, far below what its steps take here, so the key plan is
walked at `STEP_FLOOR_S` a step instead."""

from __future__ import annotations

import json
from unittest import mock

import torch

from portbench import run, spec

TRAFFIC = {"kind": "closed_loop",
           "prompt": {"median": 40, "sigma": 0.8, "min": 8, "max": 120},
           "output": {"median": 8, "sigma": 0.8, "min": 4, "max": 32},
           "cycle": 8}
STEP_FLOOR_S = 0.05


def reduced_config(name: str) -> dict:
    from repro_torch.configs import get_arch

    cfg = dict(spec.read_json("configs", name))
    a = get_arch(cfg["arch"]).reduced()
    cfg.update(port_variant="reduced", num_hidden_layers=a.n_layers,
               hidden_size=a.d_model, num_attention_heads=a.n_heads,
               num_key_value_heads=a.n_kv_heads,
               head_dim=a.resolved_head_dim, vocab_size=a.vocab_size,
               intermediate_size=a.moe.d_ff_expert if a.moe else a.d_ff)
    if a.moe:
        cfg.update(num_local_experts=a.moe.n_experts,
                   num_experts_per_tok=a.moe.top_k,
                   assumed={"experts_padded_to": a.moe.n_experts_padded})
    return cfg


def reduced_cell(cell_name: str, limit: float | None = None,
                 config: str | None = None, policy: str | None = None,
                 **check) -> spec.Cell:
    """The cell at reduced size; `config` and `policy` replace the cell's,
    `limit` replaces its limits by one on the widest gap, `check`
    overrides other keys of its check."""
    if limit is not None:
        check["limits"] = {"max_gap": limit}
    body = dict(spec.read_json("cells", cell_name))
    body.update({k: v for k, v in (("config", config), ("policy", policy))
                 if v is not None})
    body.update(clients=8,
                engine={"n_slots": 8, "capacity": 256, "chunk_tokens": 64,
                        "block_size": 16, "n_blocks": 96})
    body["check"] = dict(body["check"], **check)
    return spec.Cell(cell_name, body, reduced_config(body["config"]),
                     dict(TRAFFIC))


def run_reduced(cell: spec.Cell, seed: int, seconds: float = 1.5,
                trace: bool = False, device: str = "cpu",
                floor_s: float = STEP_FLOOR_S, **kw) -> dict:
    torch.set_num_threads(2)
    with open(spec.ROOT.parent / "BENCHMARK.json") as f:
        bench = json.load(f)
    with mock.patch.object(run, "decode_floor_s", lambda m, rows: floor_s):
        return run.run_cell(cell, bench, seed, seconds, trace, device,
                            **kw)
