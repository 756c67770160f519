"""ROADMAP F-port-7's control, a reading (not a test): the port's plain
path on the CPU against the JAX package's reference on the same 6-layer
gemma3-1b weights at full width, FP8 (and FP16) paged steps, planar KV,
on the schedule of `chip_smoke.py`'s gemma slice: prompts of 600 and 520
tokens in chunks of 256, then 4 decode steps, teacher-forced by the
JAX side's greedy tokens, one block table per window group.

The weights are the port's `init_params(seed=0)` of the 6-layer cut, the
gemma slice's own, without its planted exception tensor: the JAX package
stacks layers, so one exception tensor would keep every layer's `wo` in
f16. Prints the max |logit error| of each step and of the run.

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/_fport7_control.py
"""

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import JARCHS, TARCHS
from repro.models import model as JM
from repro.models.convert import to_serving as j_to_serving
from repro.models.layers import Runtime as JRuntime
from repro_torch.models import model as TM
from repro_torch.models.convert import to_serving
from repro_torch.models.layers import Runtime as TRuntime


def main(modes=("fp8", "fp16"), n_layers=6) -> dict:
    jcfg = dataclasses.replace(JARCHS["gemma3-1b"], n_layers=n_layers)
    tcfg = dataclasses.replace(TARCHS["gemma3-1b"], n_layers=n_layers)
    params = TM.init_params(tcfg, seed=0, device="cpu")
    tsp = to_serving(params)

    def to_jax(t):
        return jnp.asarray(t.numpy())
    jparams = {k: jax.tree_util.tree_map(to_jax, v)
               for k, v in params.items() if k != "layers"}
    jparams["layers"] = jax.tree_util.tree_map(
        lambda *xs: jnp.stack([to_jax(x) for x in xs]), *params["layers"])
    jsp = j_to_serving(jparams)
    del params, jparams

    bs, chunk, n_dec, w = 16, 256, 4, tcfg.sliding_window
    plens = [600, 520]
    mb = -(-(max(plens) + n_dec) // bs)
    gen = torch.Generator().manual_seed(3)
    ids = [torch.arange(1, 1 + 2 * mb, dtype=torch.int32).reshape(2, mb),
           (torch.randperm(2 * mb, generator=gen) + 1).to(torch.int32)
           .reshape(2, mb)]
    prompt = torch.randint(1, tcfg.vocab_size, (2, max(plens)), generator=gen,
                           dtype=torch.int32).numpy()

    def tables_at(qo):
        loc = ids[1].clone()
        for r, q0 in enumerate(qo.tolist()):
            loc[r, :max(0, (q0 - w + 1) // bs)] = 0
        return torch.stack([ids[0], loc]).numpy()

    out = {}
    for mode in modes:
        jrt = JRuntime(mode=mode, backend="ref", dtype=jnp.float32,
                       act_quant="per_token")
        trt = TRuntime(mode=mode, dtype=torch.float32, act_quant="per_token")
        jc = JM.init_paged_cache(jcfg, 1 + 2 * mb, bs, planar=True)
        tc = TM.init_paged_cache(tcfg, 1 + 2 * mb, bs, planar=True,
                                 device="cpu")

        def step(toks, qo, kvl, lp=None):
            nonlocal jc
            tables = tables_at(qo)
            want, jc = JM.paged_step(
                jrt, jsp, jcfg, jnp.asarray(toks), jc, jnp.asarray(tables),
                q_offset=jnp.asarray(qo), kv_len=jnp.asarray(kvl),
                block_size=bs, return_logits=True,
                logit_position=None if lp is None else jnp.asarray(lp))
            got = TM.paged_step(
                trt, tsp, tcfg, torch.from_numpy(toks), tc,
                torch.from_numpy(tables), q_offset=torch.from_numpy(qo),
                kv_len=torch.from_numpy(kvl), block_size=bs,
                return_logits=True,
                logit_position=None if lp is None else torch.from_numpy(lp))
            return np.asarray(want), got.numpy()

        errs, agree = [], 0
        lens = np.zeros(2, np.int32)
        plen = np.asarray(plens, np.int32)
        while (lens < plen).any():
            take = np.minimum(plen - lens, chunk).astype(np.int32)
            toks = np.zeros((2, int(take.max())), np.int32)
            for r in range(2):
                toks[r, :take[r]] = prompt[r, lens[r]:lens[r] + take[r]]
            want, got = step(toks, lens, lens + take,
                             np.maximum(take - 1, 0).astype(np.int32))
            errs.append(float(np.abs(got - want).max()))
            agree += int((got.argmax(-1) == want.argmax(-1)).sum())
            lens = lens + take
        for _ in range(n_dec):
            nxt = want.argmax(-1).astype(np.int32)[:, None]
            want, got = step(nxt, lens, lens + 1)
            errs.append(float(np.abs(got - want).max()))
            agree += int((got.argmax(-1) == want.argmax(-1)).sum())
            lens = lens + 1
        out[mode] = {"max_logit_err": max(errs), "per_step": errs,
                     "greedy_agree": agree, "greedy_total": 2 * len(errs)}
        print(f"{n_layers}-layer gemma3-1b, {mode}, port CPU vs JAX: max "
              f"|logit err| per step {[f'{e:.3e}' for e in errs]}; greedy "
              f"agree {agree}/{2 * len(errs)}", flush=True)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main(n_layers=int(sys.argv[1]) if len(sys.argv) > 1 else 6)
