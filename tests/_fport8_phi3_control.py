"""A control for phi-3-vision's dense-slot FP8 slice, a reading (not a
test): the port's plain path on the CPU against the JAX package's
reference on the same weights at full width (2 layers, 32 heads of 96),
on the schedule of `chip_smoke.py`'s phi3 slice dense run: a prefill of
2 rows of 48 tokens (with the stub frontend's 576 patch embeddings ahead
of them, or the same decoder without them) in f32 activations with the
per-tensor FP8 scale, then 4 decode steps over the planarized caches,
teacher-forced by the JAX side's greedy tokens. Prints the max |logit
error| of each step and of the run.

The weights are the port's `init_params(seed=0)` of the cut, without the
slice's planted exception tensor (the JAX package stacks layers, so one
exception would keep every layer's wo in f16).

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/_fport8_phi3_control.py
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import JARCHS, TARCHS
from repro.models import model as JM
from repro.models.convert import to_serving as j_to_serving
from repro.models.layers import Runtime as JRuntime
from repro_torch.launch import steps as TS
from repro_torch.models import model as TM
from repro_torch.models.convert import to_serving
from repro_torch.models.layers import Runtime as TRuntime

ARCH = "phi-3-vision-4.2b"


def main(modes=("fp8", "fp16"), s=48, cap=56, n_dec=4) -> dict:
    jcfg = dataclasses.replace(JARCHS[ARCH], n_layers=2)
    tcfg = dataclasses.replace(TARCHS[ARCH], n_layers=2)
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
    gen = torch.Generator().manual_seed(5)
    prompt = torch.randint(1, tcfg.vocab_size, (2, s), generator=gen,
                           dtype=torch.int32)
    patches = TS.stub_frontend(tcfg, 2, s, generator=gen,
                               device="cpu")["patch_embeds"]
    out = {}
    text = {"family": "dense", "frontend": "none"}   # the same decoder
    for with_patches in (True, False):
        jc_cfg = jcfg if with_patches else dataclasses.replace(jcfg, **text)
        tc_cfg = tcfg if with_patches else dataclasses.replace(tcfg, **text)
        for mode in modes:
            jrt = JRuntime(mode=mode, backend="ref", dtype=jnp.float32)
            trt = TRuntime(mode=mode, dtype=torch.float32)
            tb = {"tokens": prompt}
            jb = {"tokens": jnp.asarray(prompt.numpy())}
            if with_patches:
                tb["patch_embeds"] = patches
                jb["patch_embeds"] = jnp.asarray(patches.float().numpy())
            n = s + (tcfg.frontend_len if with_patches else 0)
            c = n - s + cap
            want, jc, _ = JM.prefill(jrt, jsp, jc_cfg, jb, capacity=c)
            got, tc, _ = TM.prefill(trt, tsp, tc_cfg, tb, capacity=c)
            errs = [float(np.abs(np.asarray(want) - got.numpy()).max())]
            jc, tc = JM.planarize_cache(jc), TM.planarize_cache(tc)
            for i in range(n_dec):
                nxt = np.asarray(want).argmax(-1).astype(np.int32)[:, None]
                want, jc = JM.decode_step(jrt, jsp, jc_cfg, jnp.asarray(nxt),
                                          jc, n + i)
                got, _ = TM.decode_step(trt, tsp, tc_cfg,
                                        torch.from_numpy(nxt), tc, n + i)
                errs.append(float(np.abs(np.asarray(want) - got.numpy())
                                  .max()))
            key = f"{mode}_{'patches' if with_patches else 'text'}"
            out[key] = {"max_logit_err": max(errs), "per_step": errs}
            print(key, json.dumps(out[key]), flush=True)
    return out


if __name__ == "__main__":
    main()
