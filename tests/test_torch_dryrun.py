"""The port's dry run and roofline (`launch/dryrun.py`, `roofline/`, the
training halves of `launch/mesh.py`, `launch/sharding.py` and
`launch/steps.py`) against the JAX package, on the CPU.

The JAX resolvers get the port's `Layout` (duck-typed: `shape` and
`axis_names`), so no device count is forced and nothing is compiled.
The JAX package stacks layers into a leading (L, ...) dim that the
port's per-layer leaves do not have; the port's spec of a layer leaf
with `stack=L` is the JAX spec of the stacked leaf.

Differences by design, named where the test allows for them:
- the SSD's outer products (`models/mamba2.py`: einsums without a summed
  index, and their transposes) are dot_generals in the JAX jaxpr and
  broadcast multiplies in PyTorch, so the port counts them as
  elementwise work (ROADMAP §3, F-port-11);
- a deepseek-v3 train step runs its MoE layers' shared-expert down
  projection once more a layer and microbatch than the JAX jaxpr (the
  port's checkpointed layer reruns it in backward; ROADMAP §3,
  F-port-12).
"""

import dataclasses
import functools
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.extend import core as jcore  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import ASSIGNED as JASSIGNED  # noqa: E402
from repro.configs import INPUT_SHAPES as JSHAPES  # noqa: E402
from repro.configs.base import InputShape as JShape  # noqa: E402
from repro.launch import sharding as JSH  # noqa: E402
from repro.launch import steps as JST  # noqa: E402
from repro.optim import adamw as JAD  # noqa: E402
from repro.roofline import analysis as JROOF  # noqa: E402
from repro.roofline.flops import _dot_flops, _maybe_sub  # noqa: E402
from repro_torch.configs import ARCHS as TARCHS  # noqa: E402
from repro_torch.configs import ASSIGNED, INPUT_SHAPES  # noqa: E402
from repro_torch.configs.base import InputShape as TShape  # noqa: E402
from repro_torch.launch import dryrun as TDR  # noqa: E402
from repro_torch.launch import mesh as TMESH  # noqa: E402
from repro_torch.launch import sharding as TSH  # noqa: E402
from repro_torch.launch import steps as TST  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.layers import Runtime  # noqa: E402
from repro_torch.optim import adamw as TAD  # noqa: E402
from repro_torch.roofline import analysis as TROOF  # noqa: E402
from repro_torch.roofline import flops as TFLOPS  # noqa: E402
from repro_torch.serving import shard as SHARD  # noqa: E402
from _torch_parity import one_torch_thread  # noqa: E402,F401

LAYOUTS = {"single": TMESH.make_production_mesh(),
           "multi": TMESH.make_production_mesh(multi_pod=True)}
_STACKED = ("layers", "enc_layers")


def _keys(path) -> list:
    return [str(getattr(k, "key", getattr(k, "name", k))) for k in path
            if hasattr(k, "key") or hasattr(k, "name")]


def _pad(p, rank: int) -> tuple:
    return tuple(p) + (None,) * (rank - len(tuple(p)))


def _jax_bytes(tree, rule, cfg, mesh, **kw) -> int:
    """A device's bytes of a JAX ShapeDtypeStruct tree under a resolver."""
    total = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        spec = _pad(rule(path, leaf, cfg, mesh, **kw), len(leaf.shape))
        n = 1
        for d, e in zip(leaf.shape, spec):
            n *= d // TSH._size(mesh, e)
        total += n * leaf.dtype.itemsize
    return total


@functools.lru_cache(maxsize=None)
@functools.lru_cache(maxsize=None)
def _jax_params(arch: str, serving: bool, reduced: bool = False):
    """The JAX package's param structs of an arch, built once (immutable
    ShapeDtypeStruct trees)."""
    cfg = JARCHS[arch].reduced() if reduced else JARCHS[arch]
    return JST.param_structs(cfg, serving=serving)


@functools.lru_cache(maxsize=None)
def _jax_caches(arch: str, shape: TShape, planar: bool):
    return JST.cache_structs(JARCHS[arch], JShape(*dataclasses.astuple(shape)),
                             planar=planar)


@pytest.fixture(scope="module")
def jparams():
    return {a: _jax_params(a, False) for a in ASSIGNED}


def test_assigned_and_shapes_are_the_jax_packages():
    assert set(ASSIGNED) == set(JASSIGNED)
    assert {k: dataclasses.astuple(v) for k, v in INPUT_SHAPES.items()} == {
        k: (v.name, v.seq_len, v.global_batch, v.kind)
        for k, v in JSHAPES.items()}


def test_layouts_read_as_the_jax_meshes():
    single, multi = LAYOUTS["single"], LAYOUTS["multi"]
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.axis_names == ("pod", "data", "model") and multi.size == 512
    assert TMESH.data_axes(multi) == ("pod", "data")
    assert TMESH.data_axis_size(multi) == 32
    dbg = TMESH.make_debug_mesh(1, 1)
    assert dbg.shape == {"data": 1, "model": 1}
    serving = TMESH.Mesh(["cpu"] * 4)
    assert TMESH.data_axes(serving) == () and TMESH.data_axis_size(serving) == 1


@pytest.mark.parametrize("kind", ["single", "multi"])
@pytest.mark.parametrize("arch", ASSIGNED)
def test_spec_tables_match_jax(jparams, arch, kind):
    """param_spec (with the expert-parallel cascade) and opt_state_spec of
    every leaf, batch_spec(micro=) of every input and cache_spec of every
    decode cache plane, at the four input shapes; shape_supported too."""
    jcfg, tcfg, mesh = JARCHS[arch], TARCHS[arch], LAYOUTS[kind]
    for path, leaf in jax.tree_util.tree_flatten_with_path(jparams[arch])[0]:
        keys = _keys(path)
        stacked = any(k in _STACKED for k in keys)
        tpath = tuple(keys)
        if stacked:
            i = next(i for i, k in enumerate(keys) if k in _STACKED)
            tpath = tuple(keys[:i + 1]) + (0,) + tuple(keys[i + 1:])
        shape = leaf.shape[1:] if stacked else leaf.shape
        kw = {"stack": leaf.shape[0]} if stacked else {}
        for jrule, trule in ((JSH.param_spec, TSH.param_spec),
                             (JSH.opt_state_spec, TSH.opt_state_spec)):
            want = _pad(jrule(path, leaf, jcfg, mesh), len(leaf.shape))
            assert trule(tpath, shape, tcfg, mesh, **kw) == want, (keys, trule)
    for name, shape in INPUT_SHAPES.items():
        jshape = JShape(*dataclasses.astuple(shape))
        assert TST.shape_supported(tcfg, shape) \
            == JST.shape_supported(jcfg, jshape)
        jb = JST.batch_specs(jcfg, jshape, data_size=TMESH.data_axis_size(mesh))
        for path, leaf in jax.tree_util.tree_flatten_with_path(jb)[0]:
            micro = shape.kind == "train"
            want = _pad(JSH.batch_spec(path, leaf, jcfg, mesh, micro=micro),
                        len(leaf.shape))
            assert TSH.batch_spec(tuple(_keys(path)), leaf.shape, tcfg, mesh,
                                  micro=micro) == want
        if shape.kind != "decode" or not TST.shape_supported(tcfg, shape)[0]:
            continue
        for planar in (False, True):
            jc = _jax_caches(arch, shape, planar)
            for path, leaf in jax.tree_util.tree_flatten_with_path(jc)[0]:
                want = _pad(JSH.cache_spec(path, leaf, jcfg, mesh),
                            len(leaf.shape))
                assert TSH.cache_spec(tuple(_keys(path)), leaf.shape, tcfg,
                                      mesh) == want, (name, _keys(path))


def test_the_cascade_puts_deepseek_v3s_experts_on_data_and_model():
    cfg = TARCHS["deepseek-v3-671b"]
    e, d, f = cfg.moe.n_experts_padded, cfg.d_model, cfg.moe.d_ff_expert
    path = ("layers", 0, "moe", "w_gate")
    assert TSH.param_spec(path, (e, d, f), cfg, LAYOUTS["single"]) \
        == (("data", "model"), None, None)
    assert TSH.param_spec(path, (e, d, f), cfg, LAYOUTS["multi"]) \
        == (("data", "model"), None, None)
    assert TSH.param_spec(path, (e, d, f), cfg, TMESH.Mesh(["cpu"] * 4)) \
        == ("model", None, None)
    # ZeRO-1 leaves those banks' moments alone, and puts data on L
    assert TSH.opt_state_spec(path, (e, d, f), cfg, LAYOUTS["single"],
                              stack=61)[1] == ("data", "model")
    llama = TARCHS["llama3.1-8b"]
    assert TSH.opt_state_spec(("layers", 0, "attn", "wq", "w"), (4096, 4096),
                              llama, LAYOUTS["single"], stack=32) \
        == ("data", None, "model")


@functools.lru_cache(maxsize=None)
def _jax_param_bytes(arch: str, serving: bool, mesh) -> int:
    return _jax_bytes(_jax_params(arch, serving), JSH.param_spec,
                      JARCHS[arch], mesh)


def _jax_argument_bytes(jcfg, shape: TShape, mesh, kv: str) -> int:
    jshape = JShape(*dataclasses.astuple(shape))
    dsz = TMESH.data_axis_size(mesh)
    if shape.kind == "train":
        params = _jax_params(jcfg.arch_id, False)
        opt = JST.opt_structs(jcfg, JAD.AdamWConfig(
            low_mem=jcfg.arch_id == "deepseek-v3-671b"), params)
        batch = JST.batch_specs(jcfg, jshape, data_size=dsz)
        return (_jax_param_bytes(jcfg.arch_id, False, mesh)
                + _jax_bytes(opt["m"], JSH.opt_state_spec, jcfg, mesh)
                + _jax_bytes(opt["v"], JSH.opt_state_spec, jcfg, mesh)
                + opt["step"].dtype.itemsize
                + _jax_bytes(batch, JSH.batch_spec, jcfg, mesh, micro=True))
    batch = JST.batch_specs(jcfg, jshape, data_size=dsz)
    total = _jax_param_bytes(jcfg.arch_id, True, mesh)
    if shape.kind == "prefill":
        return total + _jax_bytes(batch, JSH.batch_spec, jcfg, mesh)
    caches = _jax_caches(jcfg.arch_id, shape, kv == "planar")
    return (total + _jax_bytes(caches, JSH.cache_spec, jcfg, mesh)
            + _jax_bytes({"tokens": batch["tokens"]}, JSH.batch_spec, jcfg,
                         mesh) + batch["cache_len"].dtype.itemsize)


_param_structs = TST.param_structs


@functools.lru_cache(maxsize=None)
def _port_params(arch: str, serving: bool):
    """The port's meta params of an arch, built once (nothing here runs a
    step on them, so they stay as built)."""
    return _param_structs(TARCHS[arch], serving=serving)


@pytest.mark.parametrize("kind", ["single", "multi"])
@pytest.mark.parametrize("arch", ASSIGNED)
def test_argument_bytes_equal_the_jax_trees(arch, kind, monkeypatch):
    """A device's params, moments, batch and caches, to the byte, against
    a sum over JAX eval_shape trees under the JAX specs, at every shape
    the JAX dry run runs (decode in f16 and planar caches)."""
    monkeypatch.setattr(TST, "param_structs", lambda cfg, *, serving:
                        _port_params(cfg.arch_id, serving))
    mesh = LAYOUTS[kind]
    for shape in INPUT_SHAPES.values():
        if not TST.shape_supported(TARCHS[arch], shape)[0]:
            continue
        for kv in (("f16", "planar") if shape.kind == "decode" else ("f16",)):
            got = TDR.argument_bytes(TARCHS[arch], shape, mesh, kv=kv)
            assert got == _jax_argument_bytes(JARCHS[arch], shape, mesh,
                                              kv), (shape.name, kv)


def test_count_params_model_flops_and_decode_traffic_match_jax(jparams):
    for arch in ASSIGNED:
        jcfg, tcfg = JARCHS[arch], TARCHS[arch]
        frac = None if jcfg.moe is None else (
            (jcfg.moe.top_k + jcfg.moe.n_shared_experts) / jcfg.moe.n_experts)
        want = JROOF.count_params(jparams[arch], active_expert_fraction=frac)
        got = TROOF.count_params(TST.param_structs(tcfg, serving=False),
                                 active_expert_fraction=frac)
        # the sums run over the leaves in another order
        assert got["total"] == want["total"], arch
        assert got["active"] == pytest.approx(want["active"], rel=1e-12)
        for shape in INPUT_SHAPES.values():
            jshape = JShape(*dataclasses.astuple(shape))
            assert TROOF.model_flops(tcfg, shape, want["active"]) \
                == JROOF.model_flops(jcfg, jshape, want["active"])
        shape = INPUT_SHAPES["decode_32k"]
        jshape = JShape(*dataclasses.astuple(shape))
        jp = _jax_params(arch, True)
        tp = TST.param_structs(tcfg, serving=True)
        for planar in (False, True):
            jc = _jax_caches(arch, shape, planar)
            tc = TST.cache_structs(tcfg, shape, planar=planar)
            for mode in ("fp16", "fp8"):
                got = TDR.analytic_traffic(tp, tc, mode, 256)
                for key, want in _jax_traffic(jp, jc, mode, 256).items():
                    assert got[key] == pytest.approx(want, rel=1e-12), key


def _jax_traffic(params, caches, mode: str, n: int) -> dict:
    """The JAX dry run's decode term (`repro/launch/dryrun.py`), on JAX
    trees."""
    w = 0.0
    for _, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        b = float(leaf.size) * leaf.dtype.itemsize
        w += b * (0.5 if leaf.dtype == np.uint8 and mode == "fp8" else 1.0)
    cr = cw = 0.0
    for path, leaf in jax.tree_util.tree_flatten_with_path(caches)[0]:
        keys = "/".join(str(getattr(k, "key", "")) for k in path)
        b = float(leaf.size) * leaf.dtype.itemsize
        if not (mode == "fp8" and "_lo" in keys):
            cr += b
        cw += b / max(leaf.shape[2] if leaf.ndim >= 3 else 1, 1)
    return {"weights_read_gib": w / n / 2**30, "cache_read_gib": cr / n / 2**30,
            "cache_write_gib": cw / n / 2**30,
            "memory_s_analytic": (w + cr + cw) / n / TROOF.HBM_BYTES_S}


# ---------------------------------------------------------------------------
# FLOPs: the port's matrix products against the JAX step's dot_generals
# ---------------------------------------------------------------------------

def _jax_dots(jaxpr, mult: float = 1.0, out=None) -> dict:
    """Dot FLOPs of a jaxpr, scans multiplied: {"products": ...,
    "elementwise_shaped": ...}, the second the dot_generals with no
    contracted dim or no free dim on either side (an outer product and
    the batched inner product that transposes it)."""
    out = {"products": 0.0, "elementwise_shaped": 0.0} if out is None else out
    if isinstance(jaxpr, jcore.ClosedJaxpr):
        jaxpr = jaxpr.jaxpr
    for e in jaxpr.eqns:
        p = e.primitive.name
        if p == "dot_general":
            (lc, rc), (lb, rb) = e.params["dimension_numbers"]
            lhs, rhs = e.invars[0].aval.shape, e.invars[1].aval.shape
            free = (math.prod(d for i, d in enumerate(lhs)
                              if i not in lc and i not in lb),
                    math.prod(d for i, d in enumerate(rhs)
                              if i not in rc and i not in rb))
            key = "products" if lc and free != (1, 1) \
                else "elementwise_shaped"
            out[key] += _dot_flops(e) * mult
        elif p == "scan":
            _jax_dots(e.params["jaxpr"], mult * e.params["length"], out)
        elif p == "while":
            _jax_dots(e.params["body_jaxpr"], mult, out)
        else:
            for sub in _maybe_sub(e.params):
                _jax_dots(sub, mult, out)
    return out


# one arch a family; prefill lengths fill the JAX attention's 1024-key
# blocks (phi-3-vision's 16 reduced patches come first)
FAMILIES = {"dense": "qwen1.5-0.5b", "moe": "deepseek-v3-671b",
            "ssm": "mamba2-2.7b", "hybrid": "zamba2-2.7b",
            "vlm": "phi-3-vision-4.2b", "encdec": "seamless-m4t-large-v2"}


def _step_pair(arch: str, kind: str):
    """(JAX dots, the port's FlopCounter) of one reduced step."""
    jcfg, tcfg = JARCHS[arch].reduced(), TARCHS[arch].reduced()
    seq = 64 if kind != "prefill" else 1024 - (
        tcfg.frontend_len if tcfg.frontend == "vision" else 0)
    rows = 2 if kind == "decode" else 1
    js, ts = JShape("t", seq, rows, kind), TShape("t", seq, rows, kind)
    if kind == "train":
        jo, to = JAD.AdamWConfig(), TAD.AdamWConfig()
        jp = _jax_params(arch, False, reduced=True)
        jj = jax.make_jaxpr(JST.make_train_step(jcfg, jo))(
            jp, JST.opt_structs(jcfg, jo, jp),
            JST.batch_specs(jcfg, js, data_size=1))
        tp = TST.param_structs(tcfg, serving=False)
        got = TFLOPS.count(TST.make_train_step(tcfg, to), tp,
                           TST.opt_structs(tcfg, to, tp),
                           TST.batch_specs(tcfg, ts, data_size=1))
    elif kind == "prefill":
        jj = jax.make_jaxpr(JST.make_prefill_step(jcfg, "fp8", capacity=seq))(
            _jax_params(arch, True, reduced=True), JST.batch_specs(jcfg, js))
        got = TFLOPS.count(TST.make_prefill_step(tcfg, "fp8", capacity=seq),
                           TST.param_structs(tcfg, serving=True),
                           TST.batch_specs(tcfg, ts))
    else:
        jb, tb = JST.batch_specs(jcfg, js), TST.batch_specs(tcfg, ts)
        jj = jax.make_jaxpr(JST.make_decode_step(jcfg, "fp16"))(
            _jax_params(arch, True, reduced=True),
            JST.cache_structs(jcfg, js, planar=True), jb["tokens"],
            jb["cache_len"])
        got = TFLOPS.count(TST.make_decode_step(tcfg, "fp16"),
                           TST.param_structs(tcfg, serving=True),
                           TST.cache_structs(tcfg, ts, planar=True),
                           tb["tokens"], tb["cache_len"])
    return _jax_dots(jj), got, tcfg


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_dot_flops_match_the_jax_jaxpr(family, kind):
    want, got, cfg = _step_pair(FAMILIES[family], kind)
    extra = 0
    if family == "moe" and kind == "train":
        # F-port-12: the shared expert's down projection, once more a
        # MoE layer and microbatch (one microbatch of 64 tokens)
        f_sh = cfg.moe.d_ff_expert * cfg.moe.n_shared_experts
        extra = cfg.n_layers * (2 * 64 * f_sh * cfg.d_model)
    assert got.dots - extra == pytest.approx(want["products"], rel=1e-9)
    # F-port-11: only the SSD has elementwise-shaped dot_generals
    assert (want["elementwise_shaped"] > 0) == (family in ("ssm", "hybrid"))
    if kind != "train":
        assert got.kernel_calls, "no kernel wrapper was charged"
        assert got.dot_by_class["f16"] > 0 or got.dot_by_class["e4m3"] > 0


def test_kernels_are_charged_once_in_their_class():
    """A meta FP8 prefill charges K7 as e4m3 work and K6 as f16 work, and
    nothing of the plain versions (whose GEMMs sum in f64)."""
    cfg = TARCHS["qwen1.5-0.5b"].reduced()
    got = TFLOPS.count(TST.make_prefill_step(cfg, "fp8", capacity=32),
                       TST.param_structs(cfg, serving=True),
                       TST.batch_specs(cfg, TShape("t", 32, 2, "prefill")))
    assert got.kernel_calls["matmul_nested_fp8_fused_quant"] == 7 * cfg.n_layers
    assert got.kernel_calls["flash_prefill_attention"] == cfg.n_layers
    d, ff, hd = cfg.d_model, cfg.d_ff, cfg.resolved_head_dim
    per_layer = 2 * 64 * (d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
                          + cfg.n_heads * hd * d + 3 * d * ff)
    assert got.dot_by_class["e4m3"] == cfg.n_layers * per_layer
    assert got.dot_by_class["f16"] == cfg.n_layers * 4 * 2 * 32 * 32 \
        * cfg.n_heads * hd


def test_meta_outputs_are_the_plain_versions(one_torch_thread):
    """On meta tensors each kernel wrapper returns, without running its
    plain version, what the plain version returns on the CPU: the same
    shapes and dtypes; under a count the call is one launch of its
    kernel."""
    from repro_torch.core import nestedfp as nf
    from repro_torch.kernels import ops
    g = torch.Generator().manual_seed(0)
    x = torch.randn((3, 5, 64), generator=g)
    w = (torch.randn((64, 48), generator=g) * 0.1).half()
    up, lo = nf.encode(w)
    xq, sc = ops.quantize_act_per_token(x)
    b, h, hkv, d, cap = 2, 4, 2, 64, 32
    q = torch.randn((b, h, d), generator=g)
    kv = torch.randn((b, cap, hkv, d), generator=g).half()
    hi, lo_ = nf.split_bytes(kv)
    planes = {"k_hi": hi, "k_lo": lo_, "v_hi": hi, "v_lo": lo_}
    lens = torch.tensor([5, 32], dtype=torch.int32)
    pool = {k: v.reshape(b * 2, cap // 2, hkv, d) for k, v in planes.items()}
    tables = torch.arange(b * 2, dtype=torch.int32).reshape(b, 2)
    qs = torch.randn((b, 16, h, d), generator=g).bfloat16()
    ks = torch.randn((b, 16, hkv, d), generator=g).bfloat16()
    calls = [(ops.matmul_nested_f16, (x.half(), up, lo), {}),
             (ops.quantize_act_per_token, (x,), {}),
             (ops.act_row_absmax, (x,), {}),
             (ops.quantize_act_scaled, (x, sc), {}),
             (ops.matmul_nested_fp8, (xq, up, sc), {}),
             (ops.matmul_f16, (x.half(), w), {}),
             (ops.matmul_nested_fp8_fused_quant, (x, up, x.abs().max()), {}),
             (ops.encode, (w,), {}),
             (ops.planar_decode_attention, (q, planes, lens),
              {"fp8": True, "window": None}),
             (ops.paged_decode_attention, (q, pool, tables, lens),
              {"fp8": False, "window": 7}),
             (ops.flash_prefill_attention, (qs, ks, ks), {})]

    def on_meta(a):
        if isinstance(a, dict):
            return {k: v.to("meta") for k, v in a.items()}
        return a.to("meta") if isinstance(a, torch.Tensor) else a

    def sig(out):
        outs = out if isinstance(out, tuple) else (out,)
        return [(tuple(o.shape), o.dtype) for o in outs]
    for fn, args, kw in calls:
        want = sig(fn(*args, **kw))
        meta = list(map(on_meta, args))
        assert sig(fn(*meta, **kw)) == want, fn.__name__
        got = TFLOPS.count(functools.partial(fn, **kw), *meta)
        assert got.kernel_calls == {fn.__name__: 1}, fn.__name__
        assert sig(got.result) == want, fn.__name__
    assert set(f.__name__ for f, _, _ in calls) >= {
        "matmul_nested_f16", "matmul_nested_fp8", "matmul_f16",
        "planar_decode_attention", "paged_decode_attention",
        "flash_prefill_attention", "matmul_nested_fp8_fused_quant"}


# ---------------------------------------------------------------------------
# collectives: the reckoning against what a mesh's forward sends
# ---------------------------------------------------------------------------

class CountingMesh(TMESH.Mesh):
    """A serving mesh that records the result bytes of each collective."""

    def __init__(self, devices):
        super().__init__(devices)
        self.sent = {}

    def _add(self, op, nbytes):
        self.sent[op] = self.sent.get(op, 0) + nbytes

    def all_reduce(self, parts, op="sum"):
        self._add("all-reduce", parts[0].numel() * parts[0].element_size())
        return super().all_reduce(parts, op)

    def all_gather(self, parts, dim=-1):
        out = super().all_gather(parts, dim)
        self._add("all-gather", out[0].numel() * out[0].element_size())
        return out


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "granite-moe-3b-a800m"])
def test_model_axis_collectives_equal_a_counting_mesh(arch, m, one_torch_thread):
    """One paged decode step of 3 rows on m CPU shards, FP16 and FP8 (per
    token, the engine's runtime): the bytes `Mesh.all_reduce` /
    `all_gather` carry equal `collective_bytes`' model-axis reckoning."""
    cfg = TARCHS[arch].reduced()
    sp = TM.init_serving_params(cfg, seed=0, device="cpu")
    bs, rows = 16, 3
    q_off = torch.tensor([5, 17, 40])
    tables = torch.arange(1, 1 + rows * 4, dtype=torch.int32).reshape(rows, 4)
    for mode in ("fp16", "fp8"):
        mesh = CountingMesh(["cpu"] * m)
        shards = SHARD.shard_serving_params(sp, cfg, mesh)
        caches = TM.init_paged_cache(cfg, 1 + rows * 4, bs, mesh=mesh)
        rt = Runtime(mode=mode, dtype=torch.float32, act_quant="per_token")
        SHARD.sharded_paged_step(
            mesh, rt, shards, cfg, torch.ones((rows, 1), dtype=torch.int32),
            caches, tables, q_offset=q_off, kv_len=q_off + 1, block_size=bs)
        # the engine's forward: per-token scales, the sharded argmax (no
        # gathered logits), f32 activations
        want = TROOF._Tally()
        TROOF._model_axis(cfg, m, want, kind="decode", rows=rows, seq=1,
                          act_bytes=4, mode=mode, act_quant="per_token",
                          gather_logits=False)
        by_type = {}
        for (op, _), b in want.bytes.items():
            by_type[op] = by_type.get(op, 0) + b
        assert mesh.sent == by_type, mode
        assert mesh.sent


def _row_split_bytes(cfg, mesh, rows, seq, enc_len, prefix):
    """All-reduce bytes of one FP16 forward, reckoned apart from
    `_model_axis`: every linear weight of the training-form tree whose
    spec splits its contraction dim, applied once over its tokens (a
    vlm's patches too; an encoder layer's and a cross-attention's k / v
    over the memory), plus a vocab-split embedding's rows."""
    total = 0
    for path, leaf, _ in TSH.tree_leaves(TST.param_structs(cfg,
                                                             serving=False)):
        if path[-1] != "w" or path[0] not in _STACKED:
            continue
        spec = TSH.param_spec(path, tuple(leaf.shape), cfg, mesh)
        if spec[0] != "model":
            continue
        over_memory = path[0] == "enc_layers" or (
            "cross" in path and path[-2] in ("wk", "wv"))
        tok = enc_len if over_memory else seq + prefix
        total += 4 * rows * tok * leaf.shape[1]
    if TSH.param_spec(("embed", "tok"), (cfg.vocab_size, cfg.d_model), cfg,
                      mesh)[0] == "model":
        total += 2 * rows * seq * cfg.d_model
    return total


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "llama3.1-8b",
                                  "phi-3-vision-4.2b"])
def test_forward_all_reduces_are_the_row_split_weights(arch):
    """A prefill's model-axis all-reduces equal those of every row-split
    weight application, the encdec's encoder stack and cross-attention
    and the vlm's patch tokens included; a train step's are 3 x n_micro x its forward's (every layer
    checkpointed: forward, recompute, backward)."""
    cfg = TARCHS[arch]
    mesh = TMESH.make_debug_mesh(1, 8)
    rows, seq = 2, 256
    enc_len = TM.encdec_enc_len(seq) if cfg.family == "encdec" else 0
    prefix = cfg.frontend_len if cfg.frontend == "vision" else 0
    pre = TROOF.collective_bytes(cfg, mesh, kind="prefill",
                                 tokens=rows * seq, rows=rows)
    want = _row_split_bytes(cfg, mesh, rows, seq, enc_len, prefix)
    assert want and pre["bytes_by_type_and_axes"]["all-reduce@model"] == want
    train = TROOF.collective_bytes(cfg, mesh, kind="train",
                                   tokens=rows * seq, rows=rows, n_micro=4)
    assert train["bytes_by_type_and_axes"]["all-reduce@model"] == 12 * want


def test_data_axes_collectives_of_a_train_step():
    """Gradients all-reduced once a microbatch and the params all-gathered
    once a step over the data axes, at their share of the device."""
    cfg = TARCHS["llama3.1-8b"]
    mesh = LAYOUTS["single"]
    got = TROOF.collective_bytes(cfg, mesh, kind="train", tokens=4096,
                                 rows=1, n_micro=16, grad_bytes=1000.0,
                                 param_bytes=1000.0)
    by = got["bytes_by_type_and_axes"]
    assert by["all-reduce@data"] == 16 * 1000.0
    assert by["all-gather@data"] == 1000.0
    assert got["seconds"] > 0 and TROOF.link_bytes_s(mesh, ("model",)) \
        == TROOF.NETWORK_BYTES_S
    assert TROOF.link_bytes_s(TMESH.make_debug_mesh(1, 8), ("model",)) \
        == TROOF.NVLINK_BYTES_S


def test_roofline_terms_hold_each_class_to_its_peak():
    t = TROOF.roofline_terms({"f16": 989.4e12, "f32": 66.9e12, "e4m3": 0,
                              "other": 0}, 3.35e12, 0.5, fp8=True)
    assert t["compute_s"] == pytest.approx(2.0)
    assert t["memory_s"] == pytest.approx(1.0)
    assert t["dominant"] == "compute_s" and t["bound_step_s"] == t["compute_s"]
    assert t["compute_fp8_adj_s"] == t["compute_s"]
    from repro_torch.serving import simulate
    assert simulate.H100_HBM_BYTES_S == TROOF.HBM_BYTES_S
    assert simulate.H100_FP16_FLOPS == TROOF.PEAK_FLOPS["f16"]


def test_run_one_writes_the_jax_records_keys(tmp_path, one_torch_thread):
    """One full-size cell (qwen1.5-0.5b decode_32k on the 256-device
    layout): the JAX record's keys, and long_500k skipped with the JAX
    reason."""
    rec = TDR.run_one("qwen1.5-0.5b", "decode_32k", "single", "fp16")
    assert rec["status"] == "ok"
    # the keys `repro/launch/dryrun.py::run_one` writes
    assert set(rec) >= {"arch", "shape", "mesh", "mode", "kv", "lower_s",
                        "compile_s", "memory", "cost", "collectives",
                        "analytic_traffic", "roofline", "params", "status"}
    assert set(rec["memory"]) >= {"argument_gib", "output_gib", "temp_gib",
                                  "alias_gib", "peak_gib"}
    assert set(rec["cost"]) >= {"flops_per_device",
                                "flops_per_device_xla_loops_once",
                                "flops_global_jaxpr", "bytes_per_device",
                                "scan_lengths", "bytes_per_device_est"}
    assert set(rec["collectives"]) >= {"bytes_by_type", "counts_by_type",
                                       "bytes_once_total", "n_unattributed",
                                       "weighted_wire_bytes"}
    assert set(rec["analytic_traffic"]) >= {
        "weights_read_gib", "cache_read_gib", "cache_write_gib",
        "memory_s_analytic"}
    assert set(rec["roofline"]) >= {"compute_s", "memory_s", "collective_s",
                                    "dominant", "bound_step_s",
                                    "useful_ratio", "model_flops_total"}
    assert set(rec["params"]) == {"total", "active"}
    assert rec["cost"]["flops_per_device"] * 256 \
        == rec["cost"]["flops_global_jaxpr"] > 0
    assert rec["roofline"]["dominant"] == "memory_s"
    json.dumps(rec)
    skip = TDR.run_one("qwen1.5-0.5b", "long_500k", "single", "fp16")
    jskip = JST.shape_supported(JARCHS["qwen1.5-0.5b"],
                                JShape("long_500k", 524288, 1, "decode"))
    assert skip["status"] == "skipped" and skip["reason"] == jskip[1]
    # the JAX dry run's file names (`repro/launch/dryrun.py::_combo_path`)
    assert TDR._combo_path("o", "a", "s", "single", "fp8", "planar") \
        == "o/a__s__single__fp8__planar.json"
    assert TDR._combo_path("o", "a", "s", "multi", "fp16") \
        == "o/a__s__multi__fp16.json"
