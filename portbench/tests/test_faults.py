"""The rest of a run, with the timed path broken underneath, comes out
not correct: the harness's look for a card is skipped (`run_cell` on
the CPU), the engine's model step is replaced by a faulty one, and the
cell's own limit judges it. A serving cell can have two of the faults:
a token altered where it is produced, and a step that returns its state
(the KV pool) unchanged; and half of the batch left out (half the decode
rows' keys never attended or written). It has no exchange between
chips (one card)."""

import pytest
import torch

from portbench import spec
from portbench.tests._cells import reduced_cell, run_reduced


def altered(real):
    def step(rt, params, cfg, tokens, *a, **kw):
        return (real(rt, params, cfg, tokens, *a, **kw) + 1) % cfg.vocab_size
    return step


def state_unchanged(real):
    def step(rt, params, cfg, tokens, caches, *a, **kw):
        saved = {k: {n: p.clone() for n, p in v.items()}
                 for k, v in caches.items()}
        ids = real(rt, params, cfg, tokens, caches, *a, **kw)
        for k, v in caches.items():
            for n, p in v.items():
                p.copy_(saved[k][n])
        return ids
    return step


def half_batch(real):
    def step(rt, params, cfg, tokens, *a, **kw):
        if tokens.shape[1] == 1:            # the batched decode
            kv_len = kw["kv_len"].clone()
            kv_len[1::2] = 0
            kw["kv_len"] = kv_len
        return real(rt, params, cfg, tokens, *a, **kw)
    return step


@pytest.mark.parametrize("fault", [altered, state_unchanged, half_batch])
def test_broken_step_is_not_correct(fault, monkeypatch):
    from repro_torch.models import model as M

    name = "dsc33b.chat.fp16"
    limits = spec.read_json("cells", name)["check"]["limits"]
    monkeypatch.setattr(M, "paged_step", fault(M.paged_step))
    with torch.no_grad():
        res = run_reduced(reduced_cell(name, limits=limits), 2024)
    assert not res["correct"], res["readings"]
