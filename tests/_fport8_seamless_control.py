"""A control for seamless-m4t-v2's dense-slot FP8 slice, a reading (not a
test): the port's plain path on the CPU against the JAX package's
reference on the same weights at full width (2 encoder + 2 decoder
layers, 16 heads of 64), on the schedule of `chip_smoke.py`'s seamless
slice: a prefill of 2 rows of 48 tokens over 64 stub frames a row in f32
activations with the per-tensor FP8 scale, then 4 decode steps through
the cross caches, teacher-forced by the JAX side's greedy tokens. Each
mode runs twice: each side with its own encoder ("own"), and the port's
decoder on the JAX encoder's memory ("shared"). Prints the max |logit
error| of each step and of the run, and the memory's max |error|.

The weights are the port's `init_params(seed=0)` of the cut, without the
slice's planted exception tensor (the JAX package stacks layers, so one
exception would keep every layer's wo in f16).

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/_fport8_seamless_control.py
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

ARCH = "seamless-m4t-large-v2"


def _stack(layers):
    return jax.tree_util.tree_map(
        lambda *xs: jnp.stack([jnp.asarray(x.numpy()) for x in xs]), *layers)


def main(modes=("fp8", "fp16"), s=48, cap=56, n_dec=4) -> dict:
    over = dict(n_layers=2, n_enc_layers=2)
    jcfg = dataclasses.replace(JARCHS[ARCH], **over)
    tcfg = dataclasses.replace(TARCHS[ARCH], **over)
    params = TM.init_params(tcfg, seed=0, device="cpu")
    tsp = to_serving(params)
    jparams = {k: jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), v)
               for k, v in params.items()
               if k not in ("layers", "enc_layers")}
    jparams["layers"] = _stack(params["layers"])
    jparams["enc_layers"] = _stack(params["enc_layers"])
    jsp = j_to_serving(jparams)
    del params, jparams
    gen = torch.Generator().manual_seed(5)
    prompt = torch.randint(1, tcfg.vocab_size, (2, s), generator=gen,
                           dtype=torch.int32)
    frames = TS.stub_frontend(tcfg, 2, s, generator=gen,
                              device="cpu")["frames"]
    jb = {"tokens": jnp.asarray(prompt.numpy()),
          "frames": jnp.asarray(frames.float().numpy())}
    out = {}
    for mode in modes:
        jrt = JRuntime(mode=mode, backend="ref", dtype=jnp.float32)
        trt = TRuntime(mode=mode, dtype=torch.float32)
        jm = np.array(JM.encode_memory(jrt, jsp, jcfg, jb["frames"]))
        tm = TM.encode_memory(trt, tsp, tcfg, frames)
        mem_err = float(np.abs(jm - tm.numpy()).max())
        for memory in ("own", "shared"):
            encode = TM.encode_memory
            if memory == "shared":
                TM.encode_memory = lambda *a: torch.from_numpy(jm)
            try:
                want, jc, _ = JM.prefill(jrt, jsp, jcfg, jb, capacity=cap)
                got, tc, _ = TM.prefill(trt, tsp, tcfg, {
                    "tokens": prompt, "frames": frames}, capacity=cap)
            finally:
                TM.encode_memory = encode
            errs = [float(np.abs(np.asarray(want) - got.numpy()).max())]
            jc, tc = JM.planarize_cache(jc), TM.planarize_cache(tc)
            for i in range(n_dec):
                nxt = np.asarray(want).argmax(-1).astype(np.int32)[:, None]
                want, jc = JM.decode_step(jrt, jsp, jcfg, jnp.asarray(nxt),
                                          jc, s + i)
                got, _ = TM.decode_step(trt, tsp, tcfg,
                                        torch.from_numpy(nxt), tc, s + i)
                errs.append(float(np.abs(np.asarray(want) - got.numpy())
                                  .max()))
            key = f"{mode}_{memory}"
            out[key] = {"max_logit_err": max(errs), "per_step": errs,
                        "memory_err": mem_err,
                        "memory_max": float(np.abs(jm).max())}
            print(key, json.dumps(out[key]), flush=True)
    return out


if __name__ == "__main__":
    main()
