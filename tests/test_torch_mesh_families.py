"""Tensor-parallel paged serving of the moe (with MLA), ssm and hybrid
families on the port: `Engine(mesh=...)` over shards that share the CPU
(`make_serving_mesh(m, devices=["cpu"] * m)`), held to the JAX package's
single-device engine (greedy outputs on the same weights, under the
routing-flip rule for MoE: `_torch_parity.assert_streams`) and to the
port's unsharded engine (the same outputs, and `stats` equal). The JAX
package's own acceptance is its mesh equal to its single device
(tests/test_mesh_serving.py).

- granite-moe-3b reduced (4 experts padded to 6): expert-parallel on 2
  and 3 shards, per-expert tensor parallel on 4;
- deepseek-v3 reduced (MLA, 4 experts and a shared one): expert-parallel
  on 2 and 4, MLA head-parallel;
- mamba2-2.7b and zamba2-2.7b reduced (16 SSM heads; zamba2 at 4 layers,
  two shared-attention applications): 2 and 4 shards, head-sharded
  state (mamba2 also on 3, where nothing divides and every shard runs
  the block whole), exact-length chunks, a slot reused after a retire.

Then the pieces: `serving_layout` for the four families at 2, 3 and 4
shards, the sharded gated norm, the expert-parallel block bitwise the
unsharded one, MLA's gathered q latent, and the router over replica
meshes of a recurrent family. encdec, the one family a mesh refuses, is
in tests/test_torch_mesh.py."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from _torch_parity import (assert_streams, configs,  # noqa: E402,F401
                           one_torch_thread, serving_pair,
                           settled_jax_tables)
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro_torch.configs import ARCHS as TARCHS  # noqa: E402
from repro_torch.core import nestedfp as nf  # noqa: E402
from repro_torch.launch import sharding as SH  # noqa: E402
from repro_torch.launch.mesh import (make_replica_meshes,  # noqa: E402
                                     make_serving_mesh)
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import mamba2 as TM2  # noqa: E402
from repro_torch.models import mla as TMLA  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models.convert import wrap_nested_linears  # noqa: E402
from repro_torch.models.layers import Runtime as TRuntime  # noqa: E402
from repro_torch.serving import router as trouter  # noqa: E402
from repro_torch.serving import shard as SHARD  # noqa: E402
from repro_torch.serving.engine import Engine as TEngine  # noqa: E402
from repro_torch.serving.engine import Request as TRequest  # noqa: E402
from test_torch_ssm import plant_out_proj  # noqa: E402

# settled_jax_tables: the JAX engine under CPU load (ROADMAP §3 F-ref-3)
pytestmark = pytest.mark.usefixtures("one_torch_thread", "settled_jax_tables")

GRANITE, DS3 = "granite-moe-3b-a800m", "deepseek-v3-671b"
MAMBA2, ZAMBA2 = "mamba2-2.7b", "zamba2-2.7b"
# the shards each family is served on, and its engine's settings: the
# attention families with a shared prefix (COW forks on every shard's
# pool), the recurrent ones with a chunk budget that cuts prompts into
# exact-length chunks and fewer slots than requests (a retired slot is
# reused)
SHARDS = {GRANITE: (2, 3, 4), DS3: (2, 4), MAMBA2: (2, 3, 4), ZAMBA2: (2, 4)}
ENGINE = {GRANITE: dict(n_slots=4, capacity=64, kv_planar=True),
          DS3: dict(n_slots=4, capacity=64, kv_planar=True),
          MAMBA2: dict(n_slots=2, capacity=64, chunk_tokens=16),
          ZAMBA2: dict(n_slots=2, capacity=64, chunk_tokens=16)}

_PAIRS: dict = {}
_RUNS: dict = {}


def cpu_mesh(m: int):
    return make_serving_mesh(m, devices=["cpu"] * m)


def family_pair(arch: str):
    """(jcfg, tcfg, JAX serving params, the port's copy), made once:
    layer 1's wo an exception tensor (moe), every out_proj one (ssm,
    hybrid); zamba2 at 4 layers, two shared-attention applications."""
    if arch not in _PAIRS:
        if arch in (MAMBA2, ZAMBA2):
            jcfg, tcfg = configs(arch, **({"n_layers": 4} if arch == ZAMBA2
                                          else {}))
            sp = serving_pair(jcfg, tcfg.n_layers, False,
                              plant=plant_out_proj)
        else:
            jcfg, tcfg = configs(arch)
            sp = serving_pair(jcfg, tcfg.n_layers, plant_exception=True)
        _PAIRS[arch] = (jcfg, tcfg) + sp
    return _PAIRS[arch]


def _requests(arch: str):
    rng = np.random.default_rng(5)
    vocab = family_pair(arch)[1].vocab_size
    if arch in (MAMBA2, ZAMBA2):      # lengths 9, 17, 30 over a budget of 16
        return [(f"r{i}", [int(t) for t in rng.integers(1, vocab, n)], 5)
                for i, n in enumerate((17, 9, 30))]
    sysp = [int(t) for t in rng.integers(1, vocab, 16)]
    return [(f"r{i}", sysp + [int(t) for t in rng.integers(1, vocab, n)], 5)
            for i, n in enumerate((7, 13, 4))]


def _serve(eng, make, arch: str) -> dict:
    """The requests through `eng`: the first alone, then the rest, so an
    attention family's later prompts hit the first one's cached prefix."""
    reqs = _requests(arch)
    for wave in (reqs[:1], reqs[1:]):
        for rid, toks, n in wave:
            eng.submit(make(rid, list(toks), n))
        eng.run()
    return {r.request_id: r.output for r in eng.finished}


def _jax(arch: str, mode: str) -> dict:
    key = ("jax", arch, mode)
    if key not in _RUNS:
        jcfg, _, jsp, _ = family_pair(arch)
        _RUNS[key] = _serve(JEngine(jcfg, jsp, forced_mode=mode,
                                    **ENGINE[arch]), JRequest, arch)
    return _RUNS[key]


def _port(arch: str, mode: str, m: int | None):
    """The port's engine, unsharded (m None) or on m CPU shards: (outputs,
    engine)."""
    key = ("port", arch, mode, m)
    if key not in _RUNS:
        _, tcfg, _, tsp = family_pair(arch)
        eng = TEngine(tcfg, tsp, device="cpu", forced_mode=mode,
                      mesh=None if m is None else cpu_mesh(m),
                      **ENGINE[arch])
        _RUNS[key] = (_serve(eng, TRequest, arch), eng)
    return _RUNS[key]


CASES = [(a, m) for a, ms in SHARDS.items() for m in ms]


@pytest.mark.parametrize("mode", ["fp16", "fp8"])
@pytest.mark.parametrize("arch,m", CASES)
def test_mesh_matches_jax_and_unsharded(arch, m, mode):
    ref, eref = _port(arch, mode, None)
    got, egot = _port(arch, mode, m)
    # a mesh sums its row-parallel partials (and mamba2's norm) in shard
    # order: FP16 streams are the unsharded ones; an FP8 stream may part
    # where e4m3 re-rounding turns that into a near-tie (zamba2 on 4
    # shards, FP8: at a reference margin of 0.053)
    if mode == "fp16":
        assert got == ref
    assert_streams(family_pair(arch), _requests(arch), ref, got, mode)
    assert egot.stats == eref.stats, (eref.stats, egot.stats)
    assert egot.graphs.keys() == eref.graphs.keys()
    assert egot.prefix_cache_stats() == eref.prefix_cache_stats()
    assert_streams(family_pair(arch), _requests(arch), _jax(arch, mode),
                   got, mode)
    if arch in (MAMBA2, ZAMBA2):
        # exact-length chunks of a 16-token budget (17 = 16 + 1, then 9
        # and 30 sharing it: 9 + 7, 16, 7), and a slot reused after r0
        # retired
        assert {length for _, length in egot.graphs.keys("chunk")} \
            == {1, 7, 9, 16}
        assert egot.stats["chunks"] == 6
    else:
        assert egot.prefix_cache_stats()["hit_rate"] > 0


def test_recurrent_state_is_cut_by_heads():
    """mamba2's state planes on 4 shards: each shard its 4 of 16 heads and
    their conv_x channels, conv_bc whole; zeroing a slot zeroes it on
    every shard."""
    _, tcfg, _, tsp = family_pair(MAMBA2)
    eng = TEngine(tcfg, tsp, n_slots=2, capacity=64, device="cpu",
                  mesh=cpu_mesh(4))
    w, n, hd = tcfg.ssm.conv_width, tcfg.ssm.d_state, tcfg.ssm.head_dim
    gn = 2 * tcfg.ssm.n_groups * n
    for c in eng.caches:
        assert {k: tuple(p.shape) for k, p in c["ssm"].items()} == {
            "ssm": (tcfg.n_layers, 2, 4, hd, n),
            "conv_x": (tcfg.n_layers, 2, w - 1, 4 * hd),
            "conv_bc": (tcfg.n_layers, 2, w - 1, gn)}
        for p in c["ssm"].values():
            p.fill_(1)
    eng._zero_slot(1)
    for c in eng.caches:
        for p in c["ssm"].values():
            assert not p[:, 1].any() and p[:, 0].all()


# ---------------------------------------------------------------------------
# the layout, and the pieces each family's mesh adds
# ---------------------------------------------------------------------------

LAYOUTS = {  # (q, kv, wo, mlp, pool, q_a, experts, shared, ssm, ssm_heads)
    (GRANITE, 2): ("col", "col", "row", None, True, None, "ep", None, None,
                   0),
    (GRANITE, 3): ("whole", "whole", "whole", None, False, None, "ep", None,
                   None, 0),
    (GRANITE, 4): ("col", "col", "row", None, True, None, "tp", None, None,
                   0),
    (DS3, 2): ("col", "col", "row", None, False, "col", "ep", "col", None,
               0),
    (DS3, 4): ("col", "col", "row", None, False, "col", "ep", "col", None,
               0),
    (MAMBA2, 2): ("whole", "whole", "whole", None, False, None, None, None,
                  "col", 8),
    (MAMBA2, 3): ("whole", "whole", "whole", None, False, None, None, None,
                  "whole", 16),
    (MAMBA2, 4): ("whole", "whole", "whole", None, False, None, None, None,
                  "col", 4),
    (ZAMBA2, 2): ("col", "col", "row", "col", True, None, None, None, "col",
                  8),
    (ZAMBA2, 3): ("whole", "whole", "whole", "whole", False, None, None,
                  None, "whole", 16),
    (ZAMBA2, 4): ("col", "col", "row", "col", True, None, None, None, "col",
                  4),
}


@pytest.mark.parametrize("arch,m", sorted(LAYOUTS))
def test_serving_layout_of_every_family(arch, m):
    cfg = TARCHS[arch].reduced()
    lay = SH.serving_layout(cfg, cpu_mesh(m))
    assert (lay.q, lay.kv, lay.wo, lay.mlp, lay.pool, lay.q_a, lay.experts,
            lay.shared, lay.ssm, lay.ssm_heads) == LAYOUTS[arch, m]
    if cfg.ssm is not None:         # one B/C group: every head reads it
        assert lay.ssm_groups == ((0,) * lay.ssm_heads,) * m


def test_ssm_groups_follow_the_heads():
    """n_groups 4 over 16 heads: on 2 shards two whole groups each, on 8
    shards half a group each; 2 groups on 3 shards of 12 heads straddle
    (shard 1's heads 4-7 read groups 0 and 1)."""
    base = TARCHS[MAMBA2].reduced()
    cfg = dataclasses.replace(base, ssm=dataclasses.replace(base.ssm,
                                                            n_groups=4))
    assert SH.serving_layout(cfg, cpu_mesh(2)).ssm_groups == (
        (0,) * 4 + (1,) * 4, (2,) * 4 + (3,) * 4)
    assert SH.serving_layout(cfg, cpu_mesh(8)).ssm_groups == tuple(
        (s // 2,) * 2 for s in range(8))
    cfg = dataclasses.replace(
        base, d_model=192, ssm=dataclasses.replace(base.ssm, n_groups=2))
    lay = SH.serving_layout(cfg, cpu_mesh(3))
    assert lay.ssm == "col" and lay.ssm_groups[1] == (0, 0, 1, 1)


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_ssm_block_on_a_mesh_with_grouped_bc(groups):
    """A Mamba2 block with n_groups B/C groups, on 2 and 4 shards, against
    the unsharded block: the output and every shard's slice of the new
    state (a prompt chunk, then a one-token step)."""
    base = TARCHS[MAMBA2].reduced()
    cfg = dataclasses.replace(base, ssm=dataclasses.replace(
        base.ssm, n_groups=groups))
    gen = torch.Generator().manual_seed(3)
    p = wrap_nested_linears(TM2.init_mamba2(gen, cfg, nf.NestedTensor.from_f16))
    rt = TRuntime()
    x = torch.randn((2, 5, cfg.d_model), generator=gen)
    x1 = torch.randn((2, 1, cfg.d_model), generator=gen)
    kv = torch.tensor([5, 5])
    y, st = TM2.mamba2_block(rt, p, cfg, x, phase="paged",
                             cache=_zero_state(cfg, 1), kv_len=kv)
    y1, st1 = TM2.mamba2_block(rt, p, cfg, x1, phase="paged", cache=st,
                               kv_len=kv + 1)
    for m in (2, 4):
        mesh = cpu_mesh(m)
        lay = SH.serving_layout(cfg, mesh)
        ps = SHARD.shard_subtree(p, ("layers", 0, "mamba"), cfg, mesh)
        caches = [_zero_state(cfg, m) for _ in range(m)]
        got, news = TM2.mamba2_block_mesh(rt, mesh, lay, ps, cfg, [x] * m,
                                          phase="paged", caches=caches,
                                          kv_len=[kv] * m)
        got1, news1 = TM2.mamba2_block_mesh(rt, mesh, lay, ps, cfg,
                                            [x1] * m, phase="paged",
                                            caches=news, kv_len=[kv + 1] * m)
        for a, want in ((got, y), (got1, y1)):
            # the SSD's einsums over fewer heads, the norm and the
            # row-parallel out_proj sum in other orders (~1e-8), and
            # out_proj's input is re-rounded to f16, which can move an
            # element by one f16 ulp (F-port-1's FP16 limit)
            assert all(torch.allclose(g, want, rtol=0, atol=3e-3)
                       for g in a)
        hs = lay.ssm_heads
        for s, new in enumerate(news1):
            assert torch.allclose(new["ssm"], st1["ssm"][:, s * hs:(s + 1) * hs],
                                  rtol=1e-5, atol=1e-6)
            w = hs * cfg.ssm.head_dim
            assert torch.equal(new["conv_x"], st1["conv_x"][..., s * w:(s + 1) * w])
            assert torch.equal(new["conv_bc"], st1["conv_bc"])


def _zero_state(cfg, m: int) -> dict:
    d_inner, n_heads, conv_ch = TM2.ssm_dims(cfg)
    s = cfg.ssm
    gn = conv_ch - d_inner
    return {"conv_x": torch.zeros((2, s.conv_width - 1, d_inner // m),
                                  dtype=torch.float16),
            "conv_bc": torch.zeros((2, s.conv_width - 1, gn),
                                   dtype=torch.float16),
            "ssm": torch.zeros((2, n_heads // m, s.head_dim, s.d_state))}


@pytest.mark.parametrize("m", [2, 4])
def test_sharded_norm_is_the_whole_row_norm(m):
    """mamba2's gated RMSNorm from column slices (f32 sums of squares
    summed in shard order) against `layers.rms_norm` of the whole row,
    in f32 and bf16, with a zero row and a row of one large value."""
    mesh = cpu_mesh(m)
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((3, 5, 512), generator=gen)
    x[0, 0] = 0.0
    x[1, 2, -1] = 300.0
    scale = torch.randn((512,), generator=gen) * 0.1
    c = 512 // m
    for dt, tol in ((torch.float32, 1e-6), (torch.bfloat16, 1e-2)):
        xd = x.to(dt)
        want = TL.rms_norm(xd, scale, 1e-5)
        got = TM2.rms_norm_mesh(
            mesh, [xd[..., s * c:(s + 1) * c] for s in range(m)],
            [scale[s * c:(s + 1) * c] for s in range(m)], 1e-5)
        assert all(g.dtype == dt for g in got)
        torch.testing.assert_close(torch.cat(got, dim=-1).float(),
                                   want.float(), rtol=tol, atol=tol)


def _moe_params(arch: str):
    _, tcfg, _, tsp = family_pair(arch)
    return tcfg, tsp["layers"][0]["moe"]


@pytest.mark.parametrize("mode", ["fp16", "fp8"])
@pytest.mark.parametrize("arch,m,kind", [(GRANITE, 2, "ep"), (GRANITE, 3, "ep"),
                                         (GRANITE, 4, "tp"), (DS3, 2, "ep"),
                                         (DS3, 4, "ep")])
def test_moe_block_on_a_mesh(arch, m, kind, mode):
    """The MoE block on a mesh against the unsharded `moe_block` on the
    same nested weights: expert-parallel bitwise on the CPU (the experts'
    outputs gathered, the combine the unsharded one), per-expert tensor
    parallel to f32 rounding (its F partials summed in shard order)."""
    cfg, p = _moe_params(arch)
    mesh = cpu_mesh(m)
    lay = SH.serving_layout(cfg, mesh)
    assert lay.experts == kind
    ps = SHARD.shard_subtree(p, ("layers", 0, "moe"), cfg, mesh)
    rt = TRuntime(mode=mode, act_quant="per_token")
    x = torch.randn((3, 7, cfg.d_model),
                    generator=torch.Generator().manual_seed(6))
    want = TMOE.moe_block(rt, p, cfg, x)
    got = TMOE.moe_block_mesh(rt, mesh, lay, ps, cfg, [x] * m)
    for g in got:
        if kind == "ep" and not cfg.moe.n_shared_experts:
            assert torch.equal(g, want)
        else:
            torch.testing.assert_close(g, want, rtol=1e-5, atol=1e-5)
    if kind == "ep":
        # the routed part alone (no shared expert) is bitwise
        q = {k: v for k, v in p.items() if k != "shared"}
        qs = [{k: v for k, v in s_.items() if k != "shared"} for s_ in ps]
        bare = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_shared_experts=0))
        assert all(torch.equal(g, TMOE.moe_block(rt, q, bare, x))
                   for g in TMOE.moe_block_mesh(rt, mesh, lay, qs, bare,
                                                [x] * m))


@pytest.mark.parametrize("m", [2, 4])
def test_mla_gathered_q_latent(m):
    """MLA's q on a mesh: wq_a's column slices gathered in shard order
    give the whole latent, then each shard's wq_b heads; the shards' heads
    put together are the unsharded `_project_q`'s, bitwise on the CPU."""
    _, tcfg, _, tsp = family_pair(DS3)
    p = tsp["layers"][0]["attn"]
    mesh = cpu_mesh(m)
    lay = SH.serving_layout(tcfg, mesh)
    assert lay.q_a == "col"
    ps = SHARD.shard_subtree(p, ("layers", 0, "attn"), tcfg, mesh)
    x = torch.randn((2, 5, tcfg.d_model),
                    generator=torch.Generator().manual_seed(8))
    pos = torch.arange(5)[None].expand(2, 5)
    for mode in ("fp16", "fp8"):
        rt = TRuntime(mode=mode, act_quant="per_token")
        want = TMLA._project_q(rt, p, tcfg, x, pos)
        lat = mesh.all_gather([TL.apply_linear(rt, q["wq_a"], x)
                               for q in ps], dim=-1)
        assert torch.equal(lat[0], TL.apply_linear(rt, p["wq_a"], x))
        parts = [TMLA._project_q(rt, q, tcfg, x, pos, latent=la)
                 for q, la in zip(ps, lat)]
        for j in range(2):
            assert torch.equal(torch.cat([q[j] for q in parts], dim=2),
                               want[j])


def test_router_over_recurrent_replica_meshes():
    """`Router.build(meshes=)` with zamba2 (state, exact-length chunks,
    the shared attention's pools): two replicas of 2 shards each, every
    request served, none lost, each output the unsharded engine's."""
    _, tcfg, _, tsp = family_pair(ZAMBA2)
    meshes = make_replica_meshes(2, 2, devices=["cpu"] * 4)
    kw = dict(ENGINE[ZAMBA2], forced_mode="fp16", device="cpu")
    r = trouter.Router.build(tcfg, tsp, 2, meshes=meshes, engine_kwargs=kw)
    assert [rep.engine.mesh for rep in r.replicas] == meshes
    reqs = _requests(ZAMBA2)
    for rid, toks, n in reqs:
        r.submit(TRequest(rid, list(toks), n))
    r.run()
    st = r.stats()
    assert len(r.finished) == len(reqs) and st["lost"] == 0
    want = _port(ZAMBA2, "fp16", None)[0]
    assert {q.request_id: q.output for q in r.finished} == want
