"""The port's training inputs and optimizer against the JAX package's:
`data/pipeline.py` batches (bitwise), the input shapes of
`launch/steps.py` (`batch_specs`, `param_structs`, `opt_structs`), AdamW
(`optim/adamw.py`) over three steps on the same params, gradients and
state, its weight-decay rule (ROADMAP F-ref-4), and train-state
checkpoints {"params", "opt"} across the two packages, f32 and low_mem
(bf16) moments, bitwise both ways."""

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax                                                     # noqa: E402
import jax.numpy as jnp                                        # noqa: E402
import torch                                                   # noqa: E402
from _torch_parity import (configs, flatten_port, flatten_serving,  # noqa: E402,F401
                           one_torch_thread)

from repro.checkpoint import io as JIO                         # noqa: E402
from repro.configs.base import INPUT_SHAPES as J_SHAPES        # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig      # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM    # noqa: E402
from repro.data.pipeline import microbatch_split as j_split    # noqa: E402
from repro.launch import steps as JS                           # noqa: E402
from repro.models import model as JM                           # noqa: E402
from repro.optim import adamw as JA                            # noqa: E402
from repro_torch.checkpoint import io as TIO                   # noqa: E402
from repro_torch.configs.base import INPUT_SHAPES              # noqa: E402
from repro_torch.data.pipeline import (DataConfig, SyntheticLM,  # noqa: E402
                                       microbatch_split)
from repro_torch.launch import steps as TS                     # noqa: E402
from repro_torch.models import model as TM                     # noqa: E402
from repro_torch.models.convert import (from_jax_opt_state,    # noqa: E402
                                        from_jax_serving)
from repro_torch.optim import adamw as TA                      # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")


# ---------------------------------------------------------------------------
# the data pipeline and the input shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,seed", [("qwen1.5-0.5b", 0), ("qwen1.5-0.5b", 7),
                                       ("phi-3-vision-4.2b", 3),
                                       ("seamless-m4t-large-v2", 1)])
def test_pipeline_batches_are_bitwise_the_jax_pipelines(arch, seed):
    """Three batches of 4 x (48 + 1) tokens, and a vlm's patch_embeds or
    an encdec's frames (64 of them, encdec_enc_len), equal bit for bit;
    microbatch_split shapes them alike."""
    jcfg, tcfg = configs(arch)
    want = list(JSyntheticLM(jcfg, JDataConfig(48, 4, seed=seed)).batches(3))
    got = list(SyntheticLM(tcfg, DataConfig(48, 4, seed=seed)).batches(3))
    for w, g in zip(want, got):
        assert set(w) == set(g)
        for k in w:
            assert w[k].dtype == g[k].dtype and w[k].shape == g[k].shape
            assert w[k].tobytes() == g[k].tobytes(), k
        ws, gs = j_split(w, 2), microbatch_split(g, 2)
        assert {k: v.shape for k, v in ws.items()} == \
            {k: v.shape for k, v in gs.items()}
    if arch.startswith("seamless"):
        assert got[0]["frames"].shape == (4, 64, tcfg.frontend_dim)


def test_input_shapes_are_the_jax_packages():
    assert {k: (v.seq_len, v.global_batch, v.kind)
            for k, v in INPUT_SHAPES.items()} == \
        {k: (v.seq_len, v.global_batch, v.kind) for k, v in J_SHAPES.items()}


@pytest.mark.parametrize("arch", ["llama3.1-8b", "phi-3-vision-4.2b",
                                  "seamless-m4t-large-v2", "mamba2-2.7b"])
def test_batch_specs_match_jax(arch):
    """Every shape kind: the same names, shapes and dtypes, on the meta
    device (train at 16 data shards and at 1)."""
    from repro.configs import ARCHS as JARCHS
    from repro_torch.configs import ARCHS as TARCHS
    for name in INPUT_SHAPES:
        for data in (1, 16):
            want = JS.batch_specs(JARCHS[arch], J_SHAPES[name],
                                  data_size=data)
            got = TS.batch_specs(TARCHS[arch], INPUT_SHAPES[name],
                                 data_size=data)
            assert set(want) == set(got)
            for k, w in want.items():
                assert tuple(got[k].shape) == tuple(w.shape), (name, k)
                assert str(got[k].dtype).split(".")[-1] == str(w.dtype)
                assert got[k].is_meta
            assert TS.micro_layout(INPUT_SHAPES[name], data) == \
                JS.micro_layout(J_SHAPES[name], data)


def _shapes(tree, path="", stacked=0) -> dict:
    """{path: (shape, dtype)} of a port tree, a list's leaves stacked."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{path}/{k}" if path else k, stacked))
        return out
    if isinstance(tree, list):
        return {p: ((len(tree),) + s, d)
                for p, (s, d) in _shapes(tree[0], path).items()}
    return {path: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}


def _jax_shapes(tree) -> dict:
    """{path: (shape, dtype)} of a JAX tree of ShapeDtypeStructs."""
    return {"/".join(str(k.key) for k in path): (tuple(a.shape), str(a.dtype))
            for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "deepseek-v3-671b",
                                  "seamless-m4t-large-v2"])
def test_param_and_opt_structs_match_jax(arch):
    """The training params' and the AdamW state's (f32 and low_mem)
    shapes and dtypes, path by path, as JAX's eval_shape trees, full
    size, nothing allocated."""
    from repro.configs import ARCHS as JARCHS
    from repro_torch.configs import ARCHS as TARCHS
    jcfg, tcfg = JARCHS[arch], TARCHS[arch]
    jspec = JS.param_structs(jcfg, serving=False)
    tspec = TS.param_structs(tcfg, serving=False)
    assert _shapes(tspec) == _jax_shapes(jspec)
    for low in (False, True):
        jo = JS.opt_structs(jcfg, JA.AdamWConfig(low_mem=low), jspec)
        to = TS.opt_structs(tcfg, TA.AdamWConfig(low_mem=low), tspec)
        assert _shapes(to) == _jax_shapes(jo)
    served = TS.param_structs(tcfg, serving=True)
    assert all(t.is_meta for t, _ in TA.leaves(served["embed"]))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _grads(jparams, scale, seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda p: jnp.asarray(
        rng.randn(*p.shape).astype(np.float32) * scale), jparams)


def _port(jtree, n_layers):
    return from_jax_serving(flatten_serving(jtree), n_layers, device="cpu")


def _ulp_bf16(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |x| (8 significant bits)."""
    _, e = np.frexp(np.asarray(x, np.float64))
    return np.ldexp(1.0, e - 8)


@pytest.mark.parametrize("low_mem", [False, True])
def test_apply_updates_matches_jax_over_three_steps(low_mem):
    """qwen1.5-0.5b reduced's JAX params and three steps of seeded
    gradients (clipped in the first step: grad_norm ~ 60 > clip_norm 1;
    not in the last two). Each step starts both sides from the same
    params, gradients and state (the JAX package's, carried across by
    `from_jax_opt_state`): grad_norm within 1e-6, lr within 5e-7
    (`test_schedule_and_clip_factor_match_jax`), the step bitwise; f32
    moments and params within 1e-6 of each leaf's largest value. low_mem:
    the bf16 moments within one bf16 ulp (an f32 value a few bits apart
    may round the other way: 9-18 of 1.4M elements a step), or within
    1e-6 of the leaf's largest moment where b1 m + (1 - b1) g cancels to
    ~1e-7 of it (one element of m at step 3 reads -3.638e-11 against
    -3.593e-11, 2 ulps, with f32 sums rounded in other places), so the params
    that read them within 1e-6 plus lr * 2^-5 (an update's m / sqrt(v)
    is at most ~2 here, and a moment an ulp away moves it by 2^-7 of
    itself)."""
    jcfg, _ = configs("qwen1.5-0.5b")
    n = jcfg.n_layers
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, low_mem=low_mem)
    jcfg_o, tcfg_o = JA.AdamWConfig(**kw), TA.AdamWConfig(**kw)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    js = JA.init_state(jcfg_o, jp)
    upd = jax.jit(lambda p, g, s: JA.apply_updates(jcfg_o, p, g, s))
    for i, scale in enumerate((0.05, 1e-4, 2e-4)):
        tp = _port(jp, n)
        ts = from_jax_opt_state(flatten_serving(js), n, device="cpu")
        assert ts["m"]["embed"]["tok"].dtype == \
            (torch.bfloat16 if low_mem else torch.float32)
        jg = _grads(jp, scale, i)
        jp, js, jm = upd(jp, jg, js)
        tp, ts, tm = TA.apply_updates(tcfg_o, tp, _port(jg, n), ts)
        assert int(ts["step"]) == int(js["step"]) == i + 1
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) \
            <= 1e-6 * float(jm["grad_norm"])
        assert abs(float(tm["lr"]) - float(jm["lr"])) <= 5e-7 * float(jm["lr"])
        want_p = flatten_serving(jp)
        for path, t in flatten_port(tp).items():
            w = want_p[path]
            lim = 1e-6 * np.abs(w).max() + (kw["lr"] * 2**-5 if low_mem
                                              else 0.0)
            assert np.abs(t - w).max() <= lim, path
        want_s = from_jax_opt_state(flatten_serving(js), n, device="cpu")
        for name in ("m", "v"):
            got = flatten_port(ts[name])
            for path, w in flatten_port(want_s[name]).items():
                g = got[path]
                if low_mem:
                    assert np.all(np.abs(g - w) <= np.maximum(np.maximum(
                        _ulp_bf16(g), _ulp_bf16(w)),
                        1e-6 * np.abs(w).max())), (name, path)
                else:
                    assert np.abs(g - w).max() <= 1e-6 * np.abs(w).max(), \
                        (name, path)
    assert float(jm["grad_norm"]) < 1.0


def test_schedule_and_clip_factor_match_jax():
    """The clip factor of the same grad_norm is bitwise JAX's. The
    schedule is within 5e-7 relative at every step 0..12000: XLA's f32
    cos on the CPU is not torch's (one ulp apart at about a third of its
    inputs), and 1 + cos cancels near the end of the decay (measured: at
    most 5 ulps, 3.6e-7)."""
    for kw in ({}, dict(lr=1e-3, warmup_steps=5, total_steps=10)):
        jc, tc = JA.AdamWConfig(**kw), TA.AdamWConfig(**kw)
        steps = np.arange(0, 12000, dtype=np.int32)
        want = np.asarray(jax.jit(jax.vmap(lambda s: JA.schedule(jc, s)))(
            jnp.asarray(steps)))
        got = TA.schedule(tc, torch.from_numpy(steps)).numpy()
        assert np.all(np.abs(got - want) <= 5e-7 * np.abs(want))
    g = np.concatenate([np.float32([0.0, 1e-12, 0.5, 1.0]),
                        np.random.RandomState(0).lognormal(0, 3, 500)
                        .astype(np.float32)])
    want = np.asarray(jax.jit(jax.vmap(lambda x: jnp.minimum(
        1.0, jc.clip_norm / jnp.maximum(x, 1e-9))))(jnp.asarray(g)))
    got = TA.clip_scale(tc, torch.from_numpy(g)).numpy()
    assert want.tobytes() == got.tobytes()


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "zamba2-2.7b",
                                  "seamless-m4t-large-v2", "deepseek-v3-671b"])
def test_weight_decay_decays_the_jax_packages_leaves(arch):
    """F-ref-4: weight_decay 1.0 and zero gradients move exactly the
    leaves the JAX package decays: every leaf of a stacked layer (its norm
    scales, qwen1.5's qkv biases, mamba2's D, A_log and dt_bias included)
    and every matrix; not final_norm, enc_norm or the vectors of the
    unstacked shared_attn and mtp blocks. Each moved leaf is p (1 - lr)."""
    jcfg, _ = configs(arch)
    kw = dict(lr=1e-2, warmup_steps=1, weight_decay=1.0)
    jo, to = JA.AdamWConfig(**kw), TA.AdamWConfig(**kw)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    jp = jax.tree.map(lambda p: p + 0.5, jp)        # no zero leaf
    tp = _port(jp, jcfg.n_layers)
    zeros = jax.tree.map(jnp.zeros_like, jp)
    jnew, _, _ = jax.jit(lambda p, g, s: JA.apply_updates(jo, p, g, s))(
        jp, zeros, JA.init_state(jo, jp))
    tnew, _, _ = TA.apply_updates(to, tp, _port(zeros, jcfg.n_layers),
                                  TA.init_state(to, tp))
    before, want_after = flatten_serving(jp), flatten_serving(jnew)
    got_after = flatten_port(tnew)
    moved_j = {p for p in before if not np.array_equal(before[p],
                                                       want_after[p])}
    moved_t = {p for p in before if not np.array_equal(before[p],
                                                       got_after[p])}
    assert moved_t == moved_j
    assert "final_norm" not in moved_t
    assert any(p.startswith("layers/") and p.endswith(("ln1", "D", "b"))
               for p in moved_t)
    for p in moved_t:
        np.testing.assert_allclose(got_after[p], before[p] * (1 - 1e-2),
                                   rtol=1e-6)


# ---------------------------------------------------------------------------
# train-state checkpoints across the two packages
# ---------------------------------------------------------------------------

def _train_state(low_mem: bool):
    """The JAX train state of qwen1.5-0.5b reduced after one AdamW step
    (moments nonzero) and the port's copy of it."""
    jcfg, tcfg = configs("qwen1.5-0.5b")
    jo = JA.AdamWConfig(low_mem=low_mem, warmup_steps=1)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    jp, js, _ = JA.apply_updates(jo, jp, _grads(jp, 0.01, 0),
                                 JA.init_state(jo, jp))
    tree = {"params": _port(jp, jcfg.n_layers),
            "opt": from_jax_opt_state(flatten_serving(js), jcfg.n_layers,
                                      device="cpu")}
    return jcfg, tcfg, {"params": jp, "opt": js}, tree, \
        TA.AdamWConfig(low_mem=low_mem)


def _bits(a) -> bytes:
    a = np.asarray(a)
    return a.view(np.uint16).tobytes() if a.dtype.itemsize == 2 \
        and a.dtype.kind in "Vf" else a.tobytes()


@pytest.mark.parametrize("low_mem", [False, True])
def test_jax_train_state_restores_into_the_port(tmp_path, low_mem):
    """`repro.checkpoint.io.save` of {"params", "opt"} at step 3 restores
    through the port's io against a meta template, every leaf (bf16
    moments too) bitwise, with the step."""
    jcfg, tcfg, jtree, _, to = _train_state(low_mem)
    JIO.save(str(tmp_path), jtree, step=3)
    meta = TM.init_params(tcfg, device="meta")
    got, step = TIO.restore(str(tmp_path), {
        "params": meta, "opt": TA.init_state(to, meta)}, device="cpu")
    assert step == 3
    want = JIO._flatten(jtree)
    flat = TIO.flatten(got)
    assert set(flat) == set(want)
    for k, w in want.items():
        assert flat[k].shape == w.shape and _bits(flat[k]) == _bits(w), k
    if low_mem:
        assert got["opt"]["m"]["layers"][0]["ln1"].dtype == torch.bfloat16


def test_port_train_state_restores_through_jax(tmp_path):
    """The port's `save` of an f32 train state restores through
    `repro.checkpoint.io.restore` into the JAX template, bitwise."""
    jcfg, _, jtree, tree, _ = _train_state(False)
    TIO.save(str(tmp_path), tree, step=5)
    got, step = JIO.restore(str(tmp_path), jtree)
    assert step == 5
    want = TIO.flatten(tree)
    for k, g in JIO._flatten(got).items():
        assert g.dtype == want[k].dtype and g.tobytes() == want[k].tobytes(), k


def test_port_low_mem_state_is_stored_as_jax_stores_it(tmp_path):
    """A low_mem train state: the port writes every npz member the JAX
    package writes for the same values, byte for byte (bf16 moments as
    "|V2" arrays of their bits, the index alike), so a reader of one
    reads the other. The JAX `restore` cannot cast a "|V2" array to bf16
    (ROADMAP F-ref-5), for its own files and the port's alike; the
    port's restore reads both."""
    jcfg, tcfg, jtree, tree, to = _train_state(True)
    TIO.save(str(tmp_path / "t"), tree, step=1)
    JIO.save(str(tmp_path / "j"), jtree, step=1)
    for who in ("t", "j"):
        with pytest.raises(ValueError):
            JIO.restore(str(tmp_path / who), jtree)
    zt = np.load(tmp_path / "t" / "shard_0.npz")
    zj = np.load(tmp_path / "j" / "shard_0.npz")
    assert sorted(zt.files) == sorted(zj.files)
    for k in zj.files:
        assert zt[k].dtype == zj[k].dtype and zt[k].shape == zj[k].shape
        assert zt[k].tobytes() == zj[k].tobytes(), k
    assert (tmp_path / "t" / "index.json").read_text() == \
        (tmp_path / "j" / "index.json").read_text()
    meta = TM.init_params(tcfg, device="meta")
    got, _ = TIO.restore(str(tmp_path / "j"), {
        "params": meta, "opt": TA.init_state(to, meta)}, device="cpu")
    for k, w in TIO.flatten(tree).items():
        assert TIO.flatten(got)[k].tobytes() == w.tobytes(), k
