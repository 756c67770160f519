"""Shared helpers of the tests that hold the PyTorch port to the JAX package:
the same seeded weights on both sides, carried across as numpy arrays."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.core.linear import NestedLinearParams
from repro.core.nestedfp import NestedTensor
from repro.models import model as JM
from repro.models.convert import to_serving as j_to_serving
from repro.serving.kvcache import BlockManager as JBlockManager
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.models.convert import from_jax_serving


def flatten_serving(tree, path: str = "") -> dict[str, np.ndarray]:
    """JAX serving tree -> {"a/b/c": array} in the layout that
    `repro_torch.models.convert.from_jax_serving` reads (an expert bank,
    a bare NestedTensor at P, as "P/upper", "P/lower" or "P/raw")."""
    out: dict[str, np.ndarray] = {}
    if isinstance(tree, NestedTensor):
        for name in ("upper", "lower", "raw"):
            a = getattr(tree, name)
            if a is not None:
                out[f"{path}/{name}"] = np.asarray(a)
    elif isinstance(tree, NestedLinearParams):
        for name in ("upper", "lower", "raw"):
            a = getattr(tree.weight, name)
            if a is not None:
                out[f"{path}/weight/{name}"] = np.asarray(a)
        if tree.bias is not None:
            out[f"{path}/bias"] = np.asarray(tree.bias)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_serving(v, f"{path}/{k}" if path else k))
    else:
        out[path] = np.asarray(tree)
    return out


def configs(arch: str, **overrides):
    """The same reduced config on both sides (JAX, port)."""
    j = dataclasses.replace(JARCHS[arch].reduced(), **overrides)
    t = dataclasses.replace(TARCHS[arch].reduced(), **overrides)
    return j, t


def serving_pair(jcfg, n_layers: int, plant_exception: bool, seed: int = 0,
                 plant=None):
    """JAX serving params from `M.init_params` + `to_serving`, and the
    port's copy of them. plant_exception sets one element of layer 1's
    `wo` to 2.0 first, so that tensor stays f16 (an exception tensor);
    plant(params), if given, edits the JAX training tree before it is
    nested and returns it."""
    params = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    if plant_exception:
        wo = params["layers"]["attn"]["wo"]["w"]
        params["layers"]["attn"]["wo"]["w"] = wo.at[1, 0, 0].set(2.0)
    if plant is not None:
        params = plant(params)
    sp = j_to_serving(params)
    return sp, from_jax_serving(flatten_serving(sp), n_layers,
                                device="cpu")


@pytest.fixture
def one_torch_thread():
    """Torch on one intra-op thread for a test of many small CPU ops
    (import it, then `pytest.mark.usefixtures("one_torch_thread")`). In a
    run of several workers on one machine, torch's intra-op threads
    contend with the other workers' (a test of 0.5 s alone took 200 s);
    one thread keeps each test's time its own. The count comes back
    after the test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _settled_set_table(orig):
    """JAX's BlockManager edits its host tables while the step it just
    dispatched may still be reading them: under CPU load the JAX engine
    then gives both one-token requests of test_torch_window.py's set the
    token 113, where a dense recompute on either side gives 205 and 495
    with top-2 margins of 0.057 and 0.064 (2 of 18 runs, six processes at
    once; 0 of 18 with this wrapper; ROADMAP F-ref-3). The wrapper lets
    the dispatched work finish before each table edit, so the reference
    runs its steps in the order its engine states."""
    def set_table(self, *args):
        jax.block_until_ready(jax.live_arrays())
        return orig(self, *args)
    return set_table


@pytest.fixture
def settled_jax_tables(monkeypatch):
    """The JAX engine with `_settled_set_table` (F-ref-3) for one test."""
    monkeypatch.setattr(JBlockManager, "_set_table",
                        _settled_set_table(JBlockManager._set_table))


# ---------------------------------------------------------------------------
# routing flips (MoE): a limit of comparison across frameworks and devices
# ---------------------------------------------------------------------------

def topk_sets(logits: np.ndarray, k: int) -> np.ndarray:
    """(..., E) router logits -> (..., k) chosen experts, sorted, with
    ties to the lower index (jax.lax.top_k's order; softmax keeps it)."""
    order = np.argsort(-np.asarray(logits, np.float64), axis=-1,
                       kind="stable")
    return np.sort(order[..., :k], axis=-1)


def routing_flips(got: list, want: list, k: int) -> dict:
    """Per-layer router logits of two runs over the same positions (lists
    of (..., E) arrays, `want` the reference) -> {"agree": (...) bool,
    True where every layer chose the same experts; "flips": positions
    that differ; "max_diff": the largest router-logit difference at
    agreeing positions; "gaps": the reference's gap between its k-th and
    (k+1)-th logit at each flipped position and layer; "near_tie": every
    such gap below 4 * max_diff}."""
    agree = None
    for g, w in zip(got, want):
        same = np.all(topk_sets(g, k) == topk_sets(w, k), axis=-1)
        agree = same if agree is None else agree & same
    diff = max((float(np.abs(np.asarray(g, np.float64)[agree]
                             - np.asarray(w, np.float64)[agree]).max())
                if agree.any() else 0.0) for g, w in zip(got, want))
    gaps = []
    for g, w in zip(got, want):
        w = np.asarray(w, np.float64)
        flipped = ~np.all(topk_sets(g, k) == topk_sets(w, k), axis=-1)
        srt = -np.sort(-w[flipped], axis=-1)
        gaps += list(srt[:, k - 1] - srt[:, k])
    return {"agree": agree, "flips": int((~agree).sum()), "max_diff": diff,
            "gaps": gaps, "near_tie": all(gp < 4 * diff for gp in gaps)}


def jax_router_logits(jrt, jsp, jcfg, tokens) -> list:
    """The JAX model's per-layer router logits (B, S, E) f32 over a
    prompt, layer by layer (the scanned stack exposes none)."""
    import jax.numpy as jnp
    from repro.models import layers as JL
    from repro.models import mla as JMLA
    from repro.models import moe as JMOE
    tokens = jnp.asarray(tokens)
    x = JM.embed_tokens(jrt, jsp, jcfg, tokens)
    pos = jnp.arange(tokens.shape[1])[None, :]
    out = []
    for i in range(jcfg.n_layers):
        p = jax.tree.map(lambda a: a[i], jsp["layers"])
        h = JL.rms_norm(x, p["ln1"], jcfg.norm_eps)
        if jcfg.mla is not None:
            a, _ = JMLA.mla_attention(jrt, p["attn"], jcfg, h,
                                      phase="prefill", positions=pos)
        else:
            a, _ = JL.attention(jrt, p["attn"], jcfg, h, phase="prefill",
                                positions=pos)
        x = x + a
        h = JL.rms_norm(x, p["ln2"], jcfg.norm_eps)
        out.append(np.asarray(JL.apply_linear(jrt, p["moe"]["router"], h),
                              np.float32))
        m, _ = JMOE.moe_block(jrt, p["moe"], jcfg, h)
        x = x + m
    return out


# ---------------------------------------------------------------------------
# greedy streams against the JAX engine's (F-port-1, routing flips)
# ---------------------------------------------------------------------------

STREAM_TOL = {"fp16": 3e-3, "fp8": 0.25}        # ROADMAP (F-port-1)


def assert_streams(pair, reqs, jout, tout, mode):
    """Each port stream equal to the JAX engine's, or parting where the
    reference's top-2 margin after the common prefix is below 2 *
    STREAM_TOL[mode], or, for an MoE stack, at a routing near-tie of that
    prefix (`routing_flips`). pair: (jcfg, tcfg, jsp, tsp); reqs: (rid,
    prompt, max_new); jout / tout: rid -> output tokens."""
    import jax.numpy as jnp
    from repro.models.layers import Runtime as JRuntime
    from repro_torch.models import model as TM
    from repro_torch.models.layers import Runtime as TRuntime
    jcfg, tcfg, jsp, tsp = pair
    prompts = {rid: toks for rid, toks, _ in reqs}
    jrt = JRuntime(mode=mode, backend="ref", dtype=jnp.float32)
    for rid, want in jout.items():
        got = tout[rid]
        if got == want:
            continue
        assert len(got) == len(want), rid
        i = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
        seq = np.asarray([prompts[rid] + want[:i]], np.int32)
        lg = np.asarray(JM.prefill(jrt, jsp, jcfg,
                                   {"tokens": jnp.asarray(seq)})[0])[0]
        top2 = np.sort(lg)[-2:]
        if top2[1] - top2[0] < 2 * STREAM_TOL[mode]:
            continue
        assert tcfg.moe is not None, (rid, i, top2)
        aux = []
        TM.prefill(TRuntime(mode=mode, dtype=torch.float32), tsp, tcfg,
                   {"tokens": torch.from_numpy(seq)}, aux=aux)
        r = routing_flips([a["router_logits"].numpy() for a in aux],
                          jax_router_logits(jrt, jsp, jcfg, seq),
                          tcfg.moe.top_k)
        assert r["flips"] and r["near_tie"], (rid, i, top2, r)


# ---------------------------------------------------------------------------
# training: the same loss and gradients on both sides
# ---------------------------------------------------------------------------

TRAIN_LOSS_RTOL = 1e-5     # train_loss and its metrics, f32 activations
TRAIN_GRAD_RTOL = 1e-4     # each gradient leaf, relative L2


def train_pair(arch: str, seq: int, batch: int = 2, seed: int = 0):
    """JAX `M.train_loss` with its gradients (jitted value_and_grad in f32
    activations) and the port's on a copy of the same weights and the
    same `SyntheticLM` batch: {"jcfg", "tcfg", "batch", "jloss",
    "jmetrics", "jgrads" (flattened by path), "tparams" (leaves with
    .grad), "tloss", "tmetrics"}."""
    import jax.numpy as jnp
    from repro.data.pipeline import DataConfig, SyntheticLM
    from repro.models.layers import Runtime as JRuntime
    from repro_torch.models import model as TM
    from repro_torch.models.layers import Runtime as TRuntime
    from repro_torch.optim.adamw import leaves
    jcfg, tcfg = configs(arch)
    jp = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    b = next(SyntheticLM(jcfg, DataConfig(seq_len=seq, global_batch=batch,
                                          seed=seed)).batches(1))
    jrt = JRuntime(mode="train", dtype=jnp.float32)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, x: JM.train_loss(jrt, p, jcfg, x), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    tp = from_jax_serving(flatten_serving(jp), jcfg.n_layers, device="cpu")
    for t, _ in leaves(tp):
        t.requires_grad_(True)
    tl, tm = TM.train_loss(TRuntime(mode="train", dtype=torch.float32), tp,
                           tcfg, {k: torch.from_numpy(v) for k, v in b.items()})
    tl.backward()
    return {"jcfg": jcfg, "tcfg": tcfg, "batch": b, "jparams": jp,
            "jloss": float(jl), "jmetrics": {k: float(v) for k, v in jm.items()},
            "jgrads": flatten_serving(jg), "tparams": tp,
            "tloss": float(tl.detach()),
            "tmetrics": {k: float(v.detach()) for k, v in tm.items()}}


def flatten_port(tree, get=lambda t: t.detach().float().numpy()
                 ) -> dict[str, np.ndarray]:
    """get(leaf) of every leaf of a port tree, flattened by path as
    `flatten_serving` flattens the JAX tree: a list's (a stack's)
    per-layer values stacked along a new first axis."""
    out: dict[str, list] = {}

    def walk(node, path, stacked):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}" if path else k, stacked)
        elif isinstance(node, list):
            for v in node:
                walk(v, path, True)
        else:
            out.setdefault(path, []).append(get(node))
            if not stacked:
                out[path] = out[path][0]
    walk(tree, "", False)
    return {k: np.stack(v) if isinstance(v, list) else v
            for k, v in out.items()}


def assert_train_pair(r: dict) -> float:
    """The port's loss and metrics within TRAIN_LOSS_RTOL of the JAX
    package's and every gradient leaf within TRAIN_GRAD_RTOL (relative
    L2; a stacked leaf per layer). Returns the worst gradient reading."""
    assert abs(r["tloss"] - r["jloss"]) <= TRAIN_LOSS_RTOL * abs(r["jloss"])
    assert set(r["tmetrics"]) == set(r["jmetrics"])
    for k, want in r["jmetrics"].items():
        got = r["tmetrics"][k]
        assert abs(got - want) <= TRAIN_LOSS_RTOL * max(abs(want), 1.0), \
            (k, got, want)
    got = flatten_port(r["tparams"], lambda t: t.grad.numpy())
    assert set(got) == set(r["jgrads"])
    worst = 0.0
    for path, want in r["jgrads"].items():
        g = np.asarray(got[path], np.float64)
        w = np.asarray(want, np.float64)
        pairs = zip(g, w) if path.split("/")[0] in ("layers", "enc_layers") \
            else [(g, w)]
        for gi, wi in pairs:
            den = np.linalg.norm(wi)
            rel = np.linalg.norm(gi - wi) / den if den else np.linalg.norm(gi)
            assert rel <= TRAIN_GRAD_RTOL, (path, rel)
            worst = max(worst, float(rel))
    return worst
