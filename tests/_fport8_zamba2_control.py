"""ROADMAP F-port-8's control for zamba2-2.7b, a reading (not a test): the
port's plain path on the CPU against the JAX package's reference on the
same weights at full width (n layers, one group: attn_every = n), FP8
and FP16 paged steps on the schedule of `chip_smoke.py`'s zamba2 slice:
slot 0's 48-token prompt in exact chunks of 32 and 16 and slot 1's
20-token prompt, each routed to its state row, then 4 batched decode
steps over both slots, teacher-forced by the JAX side's greedy tokens.

The weights are the port's `init_params(seed=0)` of the cut, without the
slice's planted exception tensor (the JAX package stacks layers, so one
exception would keep every layer's out_proj in f16). Prints the max
|logit error| of each step and of the run.

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/_fport8_zamba2_control.py 6
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
    over = dict(n_layers=n_layers, attn_every=n_layers)
    jcfg = dataclasses.replace(JARCHS["zamba2-2.7b"], **over)
    tcfg = dataclasses.replace(TARCHS["zamba2-2.7b"], **over)
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

    bs = 16
    tables = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    gen = torch.Generator().manual_seed(3)
    prompts = [torch.randint(1, tcfg.vocab_size, (n,), generator=gen,
                             dtype=torch.int32).numpy() for n in (48, 20)]
    out = {}
    for mode in modes:
        jrt = JRuntime(mode=mode, backend="ref", dtype=jnp.float32,
                       act_quant="per_token")
        trt = TRuntime(mode=mode, dtype=torch.float32, act_quant="per_token")
        jc = JM.init_paged_cache(jcfg, 9, bs, n_slots=2)
        tc = TM.init_paged_cache(tcfg, 9, bs, n_slots=2, device="cpu")

        def step(toks, qo, kvl, lp=None, slot=None):
            nonlocal jc
            tab = tables if slot is None else tables[slot:slot + 1]
            qo, kvl = np.asarray(qo, np.int32), np.asarray(kvl, np.int32)
            want, jc = JM.paged_step(
                jrt, jsp, jcfg, jnp.asarray(toks), jc, jnp.asarray(tab),
                q_offset=jnp.asarray(qo), kv_len=jnp.asarray(kvl),
                block_size=bs, return_logits=True,
                logit_position=None if lp is None else jnp.asarray(lp),
                slot=None if slot is None else jnp.int32(slot))
            sl = None if slot is None else torch.tensor([slot])
            got = TM.paged_step(
                trt, tsp, tcfg, torch.from_numpy(np.asarray(toks)), tc,
                torch.from_numpy(tables), q_offset=torch.from_numpy(qo),
                kv_len=torch.from_numpy(kvl), block_size=bs,
                return_logits=True, rows=sl, slot=sl,
                logit_position=None if lp is None
                else torch.tensor(lp))
            return np.asarray(want), got.numpy()

        errs, agree = [], 0
        nxt = []
        for slot, chunks in ((0, (32, 16)), (1, (20,))):
            start = 0
            for take in chunks:
                want, got = step(prompts[slot][None, start:start + take],
                                 [start], [start + take], [take - 1], slot)
                errs.append(float(np.abs(got - want).max()))
                agree += int((got.argmax(-1) == want.argmax(-1)).sum())
                start += take
            nxt.append(int(want.argmax()))
        lens = [48, 20]
        for _ in range(4):
            want, got = step(np.asarray(nxt, np.int32)[:, None], lens,
                             [n + 1 for n in lens])
            errs.append(float(np.abs(got - want).max()))
            agree += int((got.argmax(-1) == want.argmax(-1)).sum())
            nxt = want.argmax(-1).tolist()
            lens = [n + 1 for n in lens]
        n = 3 + 2 * 4
        out[mode] = {"max_logit_err": max(errs), "per_step": errs,
                     "greedy_agree": agree, "greedy_total": n}
        print(f"{n_layers}-layer zamba2-2.7b, {mode}, port CPU vs JAX: max "
              f"|logit err| per step {[f'{e:.3e}' for e in errs]}; greedy "
              f"agree {agree}/{n}", flush=True)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main(n_layers=int(sys.argv[1]) if len(sys.argv) > 1 else 6)
