"""The fleet layer of the PyTorch port against the JAX package's: the
router (`serving/router.py`), fault plans and their injector
(`serving/faults.py`), `DegradePolicy`, traces (`serving/trace.py`) and the
SLO simulator (`serving/simulate.py`), case for case with
tests/test_router.py; and the engine hooks the router drives
(`Engine.fault_hook`, `inject_stall_ms`, `last_mode`, `drain_requests`).

* One stub engine, built on either package's `Request` and
  `RestorePolicy`, runs both routers through the same schedules: equal
  `stats()`, finished order, outputs and replica states after every step.
* Real engines (qwen1.5-0.5b reduced, forced FP16): a kill mid-generation,
  a step raise, a corrupted host entry, a drain failure rebuilt from the
  factory and a seeded chaos plan give the JAX router's tokens and
  counters, tokens equal to the port's own run without faults, and
  `lost == 0`.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from _torch_parity import (configs, one_torch_thread,  # noqa: E402,F401
                           serving_pair, settled_jax_tables)
from repro.core import policy as jpolicy  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving import faults as jfaults  # noqa: E402
from repro.serving import router as jrouter  # noqa: E402
from repro.serving import simulate as jsim  # noqa: E402
from repro.serving import trace as jtrace  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402
from repro_torch.launch.mesh import make_replica_meshes  # noqa: E402
from repro_torch.models.convert import leaves  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.serving import faults as tfaults  # noqa: E402
from repro_torch.serving import router as trouter  # noqa: E402
from repro_torch.serving import simulate as tsim  # noqa: E402
from repro_torch.serving import trace as ttrace  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _side(policy, engine, faults, router):
    return types.SimpleNamespace(
        Request=engine.Request, RestorePolicy=policy.RestorePolicy,
        DegradePolicy=policy.DegradePolicy,
        Router=router.Router, VirtualClock=router.VirtualClock,
        StepCostModel=router.StepCostModel, FaultPlan=faults.FaultPlan,
        FaultEvent=faults.FaultEvent, FaultInjector=faults.FaultInjector,
        InjectedFault=faults.InjectedFault)


SIDES = {"jax": _side(jpolicy, jengine, jfaults, jrouter),
         "torch": _side(tpolicy, tengine, tfaults, trouter)}


# ---------------------------------------------------------------------------
# stub engine: the surface the router drives, on either package's types
# ---------------------------------------------------------------------------

def _stubs(ns):
    """(StubEngine, BrokenDrainEngine) over `ns`'s RestorePolicy: one
    emitted token an active request a step, no KV; the broken one's
    drain raises too (the registry-recovery and rebuild path)."""

    class StubEngine:
        def __init__(self):
            self.queue = []
            self.active = {}
            self.prefilling = []
            self.finished = []
            self.stats = {"decode_tokens": 0, "chunk_tokens": 0}
            self.forced_mode = "fp16"
            self.restore_policy = ns.RestorePolicy()
            self.fault_hook = None
            self.last_mode = "fp16"
            self.last_stall_ms = 0.0
            self.inject_stall_ms = 0.0
            self.blocks = None           # no KV tier: failover recomputes

        def submit(self, req):
            if not req.tokens:
                raise ValueError("empty prompt")
            self.queue.append(req)

        def step(self):
            if self.fault_hook is not None:
                self.fault_hook(self)    # containment point, like Engine
            while self.queue:
                r = self.queue.pop(0)
                self.active[r.request_id] = r
            for r in list(self.active.values()):
                r.output.append(len(r.output))
                self.stats["decode_tokens"] += 1
                if len(r.output) >= r.max_new:
                    del self.active[r.request_id]
                    self.finished.append(r)
            self.last_mode = self.forced_mode or "fp16"
            self.last_stall_ms, self.inject_stall_ms = \
                self.inject_stall_ms, 0.0

        def drain_requests(self):
            out = list(self.active.values()) + self.queue
            self.active.clear()
            self.queue.clear()
            return out

    class BrokenDrainEngine(StubEngine):
        def drain_requests(self):
            raise RuntimeError("engine state is toast")

    return StubEngine, BrokenDrainEngine


def _obs(r) -> dict:
    """Everything a router shows: stats, finished order and outputs, shed
    and orphaned requests, each replica's health bookkeeping and its
    engine's precision and restore grant."""
    return {"stats": r.stats(),
            "finished": [(q.request_id, tuple(q.output)) for q in r.finished],
            "shed": [q.request_id for q in r.shed_requests],
            "orphans": [q.request_id for q in r._orphans],
            "replicas": [(rep.state, rep.errors, rep.clean, rep.usable,
                          rep.fin_cursor, rep.fp8_dwell,
                          getattr(rep.engine, "forced_mode", None),
                          vars(rep.engine.restore_policy)
                          if hasattr(rep.engine, "restore_policy") else None)
                         for rep in r.replicas]}


def _steps(r, n) -> list[dict]:
    out = []
    for _ in range(n):
        r.step()
        out.append(_obs(r))
    return out


def _req(ns, rid, toks, max_new=4):
    return ns.Request(str(rid), list(toks), max_new)


# Each schedule mirrors a case of tests/test_router.py, runs on one side's
# types and returns what it observed; its asserts are the reference test's.

def s_raise_degrades_then_kill(ns):
    Stub, _ = _stubs(ns)
    plan = ns.FaultPlan([ns.FaultEvent(0, 0, "raise"),
                         ns.FaultEvent(1, 0, "raise")])
    r = ns.Router([Stub()], plan=plan, dead_after_errors=2)
    r.submit(_req(ns, "a", [1, 2, 3]))
    trail = _steps(r, 2)
    assert trail[0]["replicas"][0][0] == "degraded"
    st = r.stats()
    assert r.replicas[0].state == "dead"
    assert st["step_errors"] == 2 and st["lost"] == 0 and st["in_flight"] == 1
    return trail


def s_success_resets_error_count(ns):
    Stub, _ = _stubs(ns)
    plan = ns.FaultPlan([ns.FaultEvent(0, 0, "raise"),
                         ns.FaultEvent(2, 0, "raise")])
    r = ns.Router([Stub()], plan=plan, dead_after_errors=2, heal_steps=50)
    r.submit(_req(ns, "a", [1, 2, 3], max_new=16))
    trail = _steps(r, 4)
    assert r.replicas[0].state == "degraded"
    assert r.stats()["step_errors"] == 2
    return trail


def s_degraded_heals(ns):
    Stub, _ = _stubs(ns)
    r = ns.Router([Stub()], plan=ns.FaultPlan([ns.FaultEvent(0, 0, "raise")]),
                  heal_steps=3)
    r.submit(_req(ns, "a", [1, 2, 3], max_new=12))
    trail = _steps(r, 4)
    assert trail[0]["replicas"][0][0] == "degraded"
    assert r.replicas[0].state == "healthy"
    return trail


def s_kill_revive_recovering(ns):
    Stub, _ = _stubs(ns)
    plan = ns.FaultPlan([ns.FaultEvent(1, 0, "kill"),
                         ns.FaultEvent(3, 0, "revive")])
    r = ns.Router([Stub()], plan=plan, recover_probe_steps=2)
    r.submit(_req(ns, "a", [1, 2, 3], max_new=8))
    trail = _steps(r, 16)
    assert trail[1]["replicas"][0][0] == "dead"
    assert trail[3]["replicas"][0][0] == "recovering"
    st = r.stats()
    assert r.replicas[0].state == "healthy"
    assert st["completed"] == 1 and st["lost"] == 0
    assert st["kills"] == 1 and st["revives"] == 1
    out = r.finished[0].output
    assert out == list(range(len(out)))      # replayed, no gap, no repeat
    return trail


def s_drain_failure_rebuilds(ns):
    Stub, Broken = _stubs(ns)
    eng = Broken()
    r = ns.Router([eng], factories=[Stub],
                  plan=ns.FaultPlan([ns.FaultEvent(0, 0, "raise")]))
    r.submit(_req(ns, "a", [1, 2, 3]))
    trail = _steps(r, 1)
    assert r.replicas[0].engine is not eng and r.stats()["rebuilds"] == 1
    r.run()
    assert r.stats()["completed"] == 1 and r.stats()["lost"] == 0
    return trail + [_obs(r)]


def s_drain_failure_without_factory(ns):
    _, Broken = _stubs(ns)
    r = ns.Router([Broken()], plan=ns.FaultPlan([
        ns.FaultEvent(0, 0, "raise"), ns.FaultEvent(2, 0, "revive")]))
    r.submit(_req(ns, "a", [1, 2, 3]))
    trail = _steps(r, 4)
    rep = r.replicas[0]
    assert rep.state == "dead" and not rep.usable    # revive refused
    assert r.stats()["lost"] == 0
    return trail


def s_same_prefix_same_replica(ns):
    Stub, _ = _stubs(ns)
    r = ns.Router([Stub() for _ in range(4)])
    toks = list(range(40))
    picks = [r._place(toks).rid for _ in range(5)]
    assert len(set(picks)) == 1
    return picks


def s_rendezvous_rehomes_dead_keys(ns):
    Stub, _ = _stubs(ns)
    r = ns.Router([Stub() for _ in range(4)])
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 1000, size=24).tolist() for _ in range(40)]
    before = [r._place(p).rid for p in prompts]
    dead = before[0]
    survivors = [rep for rep in r.replicas if rep.rid != dead]
    after = [r._place(p, among=survivors).rid for p in prompts]
    moved = sum(a != b for a, b in zip(after, before))
    assert moved == before.count(dead)   # only the dead replica's keys move
    return before, after, [r._affinity_key(p) for p in prompts]


def s_least_loaded_override(ns):
    Stub, _ = _stubs(ns)
    r = ns.Router([Stub(), Stub()], balance_slack_tokens=10)
    toks = list(range(32))
    primary = r._place(toks)
    heavy = _req(ns, "h", [9] * 8, max_new=100)
    r._live[primary.rid][heavy.request_id] = heavy
    assert r._place(toks).rid != primary.rid
    return primary.rid, r._place(toks).rid


def s_no_serving_replicas_raises(ns):
    Stub, _ = _stubs(ns)
    r = ns.Router([Stub()], plan=ns.FaultPlan([ns.FaultEvent(0, 0, "kill")]))
    r.step()
    with pytest.raises(RuntimeError, match="no serving replicas"):
        r.submit(_req(ns, "a", [1]))
    return _obs(r)


def s_kill_pins_fp8_and_tightens_restores(ns):
    Stub, _ = _stubs(ns)
    pol = ns.DegradePolicy(force_fp8=True, restore_scale=0.5,
                           hysteresis_steps=2)
    plan = ns.FaultPlan([ns.FaultEvent(1, 0, "kill"),
                         ns.FaultEvent(4, 0, "revive")])
    r = ns.Router([Stub(), Stub()], policy=pol, plan=plan)
    base = r.replicas[1].engine.restore_policy
    for i in range(2):
        r.submit(_req(ns, f"a{i}", [7, i], max_new=30))
    trail = _steps(r, 2)
    surv = r.replicas[1].engine
    assert surv.forced_mode == "fp8"
    assert surv.restore_policy.max_restore_bytes_per_step \
        == max(1, base.max_restore_bytes_per_step // 2)
    assert r.stats()["degrade_active"] and r.stats()["fp8_dwell"][1] > 0
    trail += _steps(r, 2)
    assert surv.forced_mode == "fp8"         # still dwelling
    trail += _steps(r, 2)
    assert surv.forced_mode == "fp16"        # re-probed after the dwell
    assert surv.restore_policy is base
    assert not r.stats()["degrade_active"]
    return trail + [pol.history]


def s_shed_beyond_budget(ns):
    Stub, _ = _stubs(ns)
    pol = ns.DegradePolicy(shed_budget_tokens=20, hysteresis_steps=2)
    r = ns.Router([Stub(), Stub()], policy=pol,
                  plan=ns.FaultPlan([ns.FaultEvent(0, 0, "kill")]))
    assert r.submit(_req(ns, "pre", [1, 2], max_new=10))
    r.step()
    assert r.submit(_req(ns, "big", [3, 4], max_new=30)) is False
    st = r.stats()
    assert st["shed"] == 1 and st["lost"] == 0
    assert sum(st["shed_by_replica"].values()) == 1
    mid = _obs(r)
    r.run()
    st = r.stats()
    assert st["submitted"] == st["completed"] + st["shed"]
    return mid, _obs(r)


def s_failover_bypasses_shed(ns):
    Stub, _ = _stubs(ns)
    pol = ns.DegradePolicy(shed_budget_tokens=1, hysteresis_steps=2)
    r = ns.Router([Stub(), Stub()], policy=pol,
                  plan=ns.FaultPlan([ns.FaultEvent(1, 0, "kill")]))
    for i in range(4):
        r.submit(_req(ns, f"a{i}", [5, i], max_new=8))
    r.run()
    st = r.stats()
    assert st["completed"] == 4 and st["shed"] == 0 and st["lost"] == 0
    return _obs(r)


def s_policy_dwell(ns):
    pol = ns.DegradePolicy(hysteresis_steps=3)
    assert not pol.decide(2, 2).active
    assert pol.decide(1, 2).active
    out = [pol.decide(2, 2).active for _ in range(4)]
    assert out == [True, True, False, False]
    rng = np.random.RandomState(4)
    pol = ns.DegradePolicy(force_fp8=False, shed_budget_tokens=64,
                           restore_scale=0.25, hysteresis_steps=2)
    seq = [dataclasses.asdict(pol.decide(int(live), 3))
           for live in rng.randint(1, 4, size=40)]
    return seq, pol.history, pol.degraded_step_fraction()


def s_clock_trajectory(ns):
    Stub, _ = _stubs(ns)
    vc = ns.VirtualClock()
    r = ns.Router([Stub(), Stub()], clock=vc, cost_model=ns.StepCostModel())
    for i in range(3):
        r.submit(_req(ns, f"a{i}", [1, i], max_new=6))
    r.run()
    return vc.now, _obs(r)


def s_stall_advances_clock(ns):
    Stub, _ = _stubs(ns)
    base = ns.VirtualClock()
    rb = ns.Router([Stub()], clock=base, cost_model=ns.StepCostModel())
    rb.submit(_req(ns, "a", [1, 2], max_new=4))
    rb.run()
    stalled = ns.VirtualClock()
    rs = ns.Router([Stub()], clock=stalled, cost_model=ns.StepCostModel(),
                   plan=ns.FaultPlan([ns.FaultEvent(0, 0, "stall", 40.0)]))
    rs.submit(_req(ns, "a", [1, 2], max_new=4))
    rs.run()
    assert stalled.now == pytest.approx(base.now + 0.040)
    assert rs.stats()["stall_ms"] == 40.0
    return base.now, stalled.now, _obs(rs)


def s_injector_fires_once(ns):
    Stub, _ = _stubs(ns)
    inj = ns.FaultInjector(ns.FaultPlan([ns.FaultEvent(0, 0, "stall", 25.0)]))
    eng = Stub()
    hook = inj.hook(0)
    inj.arm(0)
    hook(eng)
    hook(eng)                            # already consumed
    assert eng.inject_stall_ms == 25.0 and len(inj.fired) == 1
    inj = ns.FaultInjector(ns.FaultPlan([ns.FaultEvent(0, 1, "raise")]))
    inj.arm(0)
    with pytest.raises(ns.InjectedFault):
        inj.hook(1)(Stub())
    return [dataclasses.astuple(e) for e in inj.fired]


def _chaos(seed):
    def schedule(ns):
        """A seeded plan of every kind over three replicas with degradation
        and shedding, a virtual clock and arrivals spread over steps."""
        Stub, _ = _stubs(ns)
        plan = ns.FaultPlan.seeded(seed, replicas=3, steps=60, p_raise=.06,
                                   p_stall=.1, p_corrupt=.05, p_kill=.04,
                                   revive_after=6)
        vc = ns.VirtualClock()
        r = ns.Router([Stub() for _ in range(3)], plan=plan, clock=vc,
                      cost_model=ns.StepCostModel(), factories=[Stub] * 3,
                      policy=ns.DegradePolicy(shed_budget_tokens=60,
                                              hysteresis_steps=3),
                      balance_slack_tokens=24)
        rng = np.random.RandomState(seed)
        trail, kept = [], []
        for s in range(40):
            for i in range(rng.randint(0, 3)):
                toks = rng.randint(1, 50, size=rng.randint(1, 20)).tolist()
                mx = int(rng.randint(1, 12))
                # raises can take the whole fleet down: no admission then
                if any(rep.serving for rep in r.replicas):
                    kept.append(r.submit(_req(ns, f"s{s}.{i}", toks, mx)))
            r.step()
            trail.append(_obs(r))
        r.run(allow_partial=True)
        assert r.stats()["lost"] == 0
        return trail, kept, _obs(r), vc.now
    return schedule


SCHEDULES = {f.__name__[2:]: f for f in (
    s_raise_degrades_then_kill, s_success_resets_error_count,
    s_degraded_heals, s_kill_revive_recovering, s_drain_failure_rebuilds,
    s_drain_failure_without_factory, s_same_prefix_same_replica,
    s_rendezvous_rehomes_dead_keys, s_least_loaded_override,
    s_no_serving_replicas_raises, s_kill_pins_fp8_and_tightens_restores,
    s_shed_beyond_budget, s_failover_bypasses_shed, s_policy_dwell,
    s_clock_trajectory, s_stall_advances_clock, s_injector_fires_once)}
SCHEDULES.update({f"chaos_{s}": _chaos(s) for s in (0, 1, 2, 3)})


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_stub_router_parity(name):
    """The port's router, policy and injector see what the JAX package's
    see, step for step, on the same schedule."""
    got = {side: SCHEDULES[name](ns) for side, ns in SIDES.items()}
    assert got["torch"] == got["jax"]


@pytest.mark.parametrize("seed", [0, 3, 7, 11])
def test_seeded_plans_equal_the_reference(seed):
    kw = dict(replicas=3, steps=50, p_raise=.1, p_stall=.1, p_corrupt=.1,
              p_kill=.05)
    tp = tfaults.FaultPlan.seeded(seed, **kw)
    assert tp.to_dict() == jfaults.FaultPlan.seeded(seed, **kw).to_dict()
    assert tfaults.FaultPlan.from_dict(tp.to_dict()).events == tp.events
    assert tp.events != tfaults.FaultPlan.seeded(seed + 1, **kw).events
    with pytest.raises(ValueError, match="unknown fault kind"):
        tfaults.FaultEvent(0, 0, "meteor")


def test_fp8_steps_cost_less():
    m = trouter.StepCostModel()
    assert m.step_ms("fp8", 10) < m.step_ms("fp16", 10)
    assert m.step_ms("fp16", 0, 10) < m.step_ms("fp16", 10, 0)
    assert dataclasses.asdict(m) == dataclasses.asdict(jrouter.StepCostModel())


# ---------------------------------------------------------------------------
# traces and the simulator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(), dict(duration_s=20.5, mean_rate=9.0, seed=3),
    dict(duration_s=45.0, seed=5, prompt_len=64, max_new=32,
         spike_factor=5.0, spike_prob=0.2)])
def test_traces_equal_the_reference(kw):
    t = ttrace.azure_like(**kw)
    j = jtrace.azure_like(**kw)
    assert [dataclasses.astuple(r) for r in t] \
        == [dataclasses.astuple(r) for r in j]
    d = kw.get("duration_s", 60.0)
    assert ttrace.rate_stats(t, d) == jtrace.rate_stats(j, d)
    s_kw = dict(seed=kw.get("seed", 0), prompt_len=kw.get("prompt_len", 256))
    assert [dataclasses.astuple(r) for r in ttrace.steady(d, 4.0, **s_kw)] \
        == [dataclasses.astuple(r) for r in jtrace.steady(d, 4.0, **s_kw)]


def test_empty_trace_rate_stats():
    s = ttrace.rate_stats([], duration_s=10.0)
    assert s == jtrace.rate_stats([], duration_s=10.0) == {
        "mean_rate": 0.0, "max_rate": 0.0, "min_rate": 0.0,
        "burstiness": 0.0}


@pytest.mark.parametrize("policy", ["fp16", "fp8", "dual"])
def test_simulate_rows_equal_the_reference(policy):
    """The same trace through both simulators with the same explicit cost
    model (the reference's own rates, passed in) and SLO."""
    reqs = jtrace.azure_like(duration_s=30.0, mean_rate=6.0, seed=2,
                             prompt_len=128, max_new=64)
    treqs = [ttrace.TraceRequest(*dataclasses.astuple(r)) for r in reqs]
    rates = dict(hbm_bw=819e9, peak_flops=197e12, kv_bytes_per_token=131072)
    jc = jsim.CostModel.from_model(8e9, **rates)
    tc = tsim.CostModel.from_model(8e9, **rates)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    for slo in (None, dict(tpot_ms=25.0, hysteresis_steps=3)):
        jr = jsim.simulate(reqs, jc, policy=policy, max_batch=16,
                           slo=jpolicy.SLOConfig(**slo) if slo else None)
        tr = tsim.simulate(treqs, tc, policy=policy, max_batch=16,
                           slo=tpolicy.SLOConfig(**slo) if slo else None)
        assert tr.row() == jr.row()
        assert tr.n_finished == len(reqs)


def test_cost_model_defaults_are_the_h100s():
    """`from_model`'s defaults are one H100 SXM5 80GB's data-sheet rates."""
    got = tsim.CostModel.from_model(8e9)
    assert got == tsim.CostModel.from_model(8e9, hbm_bw=3.35e12,
                                            peak_flops=989.4e12)
    assert got.weight_read_ms_fp16 == pytest.approx(8e9 * 2 / 3.35e12 * 1e3)
    assert dataclasses.asdict(tsim.CostModel()) \
        == dataclasses.asdict(jsim.CostModel())


# ---------------------------------------------------------------------------
# real engines: failover, corruption and rebuild against the JAX router
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def qwen():
    jcfg, tcfg = configs("qwen1.5-0.5b")
    jsp, tsp = serving_pair(jcfg, tcfg.n_layers, plant_exception=False)
    return jcfg, tcfg, jsp, tsp


ENGINE_KW = dict(n_slots=4, capacity=128, forced_mode="fp16", block_size=16,
                 n_blocks=24, chunk_tokens=64, debug_invariants=True)


def _mk(pair, side, **kw):
    jcfg, tcfg, jsp, tsp = pair
    kw = dict(ENGINE_KW, **kw)
    if side == "jax":
        return jengine.Engine(jcfg, jsp, **kw)
    return tengine.Engine(tcfg, tsp, device="cpu", **kw)


def _shared_burst(ns, vocab, n=5, max_new=16, sys_len=32, seed=3):
    rng = np.random.default_rng(seed)
    sysp = rng.integers(1, vocab, size=sys_len).tolist()
    return [ns.Request(f"r{i}", sysp + np.random.default_rng(11 * i + 1)
                       .integers(1, vocab, size=6).tolist(), max_new)
            for i in range(n)]


def _serve(router, reqs):
    for q in reqs:
        router.submit(q)
    router.run()
    return {q.request_id: tuple(q.output) for q in router.finished}


def _fleet(pair, side, n, plan, broken=(), **router_kw):
    """n replicas with factories; replicas in `broken` fail their drain
    (an engine inconsistent beyond its containment point)."""
    ns = SIDES[side]

    def factory():
        return _mk(pair, side)
    engines = [factory() for _ in range(n)]
    for i in broken:
        def fail():
            raise RuntimeError("engine state is toast")
        engines[i].drain_requests = fail
    return ns.Router(engines, plan=plan, factories=[factory] * n,
                     **router_kw)


@pytest.fixture(scope="module")
def port_baselines(qwen):
    """The port's fleet without faults, per (replicas, burst size,
    max_new), served once."""
    memo = {}

    def get(n_rep, n, max_new):
        key = (n_rep, n, max_new)
        if key not in memo:
            r = _fleet(qwen, "torch", n_rep, None, affinity_blocks=1,
                       balance_slack_tokens=60)
            memo[key] = _serve(r, _shared_burst(
                SIDES["torch"], qwen[1].vocab_size, n, max_new))
        return memo[key]
    return get


FAILOVER_CASES = {
    # case: (replicas, burst size, max_new, events, drain-broken replicas)
    "kill": (2, 5, 16, [(4, 0, "kill")], ()),
    "raise": (2, 4, 10, [(3, 1, "raise")], ()),
    "rebuild": (2, 4, 10, [(3, 1, "raise")], (1,)),
}


@pytest.mark.usefixtures("settled_jax_tables")
@pytest.mark.parametrize("case", sorted(FAILOVER_CASES))
def test_failover_matches_the_reference(qwen, port_baselines, case):
    n_rep, n, max_new, events, broken = FAILOVER_CASES[case]
    got = {}
    for side, ns in SIDES.items():
        plan = ns.FaultPlan([ns.FaultEvent(*e) for e in events])
        r = _fleet(qwen, side, n_rep, plan, broken, affinity_blocks=1,
                   balance_slack_tokens=60)
        out = _serve(r, _shared_burst(ns, qwen[1].vocab_size, n, max_new))
        got[side] = (out, r.stats(), [q.request_id for q in r.finished])
    (tout, tst, torder), (jout, jst, jorder) = got["torch"], got["jax"]
    assert tst == jst and torder == jorder
    assert tout == jout == port_baselines(n_rep, n, max_new)
    assert tst["lost"] == 0 and tst["failover_requests"] > 0
    if case == "kill":
        assert tst["kills"] == 1 and tst["replicas"][0] == "dead"
        assert tst["failover_restored_tokens"] > 0
        assert tst["failover_recomputed_tokens"] > 0
    else:
        assert tst["step_errors"] == 1
        assert tst["rebuilds"] == (case == "rebuild")


def _corrupt_phases(pair, side, corrupt):
    """tests/test_router.py's scarce pool: a second burst evicts the first
    burst's prefix blocks into the host tier, and a third burst sharing
    that prefix restores them through the corrupted entry."""
    ns = SIDES[side]
    vocab = pair[1].vocab_size
    eng = _mk(pair, side, n_slots=2, n_blocks=8)
    r1 = ns.Router([eng], affinity_blocks=1)
    _serve(r1, _shared_burst(ns, vocab, n=2, max_new=6))
    other = np.random.default_rng(99).integers(1, vocab, size=100).tolist()
    _serve(r1, [ns.Request("evict", other, 6)])
    assert len(eng.blocks.host.entries) > 0
    plan = ns.FaultPlan([ns.FaultEvent(0, 0, "corrupt")]) if corrupt else None
    r2 = ns.Router([eng], plan=plan, affinity_blocks=1)
    r2.replicas[0].fin_cursor = len(eng.finished)
    burst = [ns.Request(f"again{i}", q.tokens, 6) for i, q in
             enumerate(_shared_burst(ns, vocab, n=2, max_new=6))]
    return _serve(r2, burst), r2.stats()


@pytest.mark.usefixtures("settled_jax_tables")
def test_corrupt_host_entry_matches_the_reference(qwen):
    ref, ref_st = _corrupt_phases(qwen, "torch", corrupt=False)
    hit, hit_st = _corrupt_phases(qwen, "torch", corrupt=True)
    jhit, jhit_st = _corrupt_phases(qwen, "jax", corrupt=True)
    assert ref_st["corrupt_detected"] == 0
    assert hit_st["corrupt_detected"] > 0       # caught, then recomputed
    assert hit_st["lost"] == 0
    assert hit == ref == jhit
    assert hit_st == jhit_st


@pytest.mark.usefixtures("settled_jax_tables")
def test_seeded_chaos_over_three_replicas(qwen, port_baselines):
    """Every fault kind from a seeded plan over three replicas with scarce
    pools (prefix blocks spill, so corrupt events find host entries):
    nothing is lost, and tokens and counters equal the JAX router's and
    the port's run without faults."""
    got = {}
    for side, ns in SIDES.items():
        plan = ns.FaultPlan.seeded(5, replicas=3, steps=40, p_raise=.05,
                                   p_stall=.1, p_corrupt=.15, p_kill=.04,
                                   revive_after=5)
        r = _fleet(qwen, side, 3, plan, affinity_blocks=1,
                   balance_slack_tokens=60,
                   clock=ns.VirtualClock(), cost_model=ns.StepCostModel())
        out = _serve(r, _shared_burst(ns, qwen[1].vocab_size, 6, 12))
        got[side] = (out, r.stats(), r.clock.now,
                     [dataclasses.astuple(e) for e in r.injector.fired])
    assert got["torch"] == got["jax"]
    out, st, _, fired = got["torch"]
    assert st["lost"] == 0 and st["completed"] == 6
    assert {e[2] for e in fired} >= {"stall", "corrupt"}
    assert st["kills"] + st["step_errors"] > 0
    assert out == port_baselines(3, 6, 12)


# ---------------------------------------------------------------------------
# the engine's hooks
# ---------------------------------------------------------------------------

def _drained_clean(eng, drained):
    bm = eng.blocks
    bm.check_invariants()
    assert not eng._captures, "a spill capture is still pending"
    assert bm.host is None or not bm.host._pins, dict(bm.host._pins)
    assert not bm._lo_pending and not bm.restore_jobs
    assert all(s is None for s in bm.seqs) and not eng.lens.any()
    assert not (eng.queue or eng.active or eng.prefilling)
    for q in drained:
        assert tengine._PENDING not in q.output
        assert len(q.token_times) == len(q.modes) == len(q.output)


def _bursts(vocab, tag, sysp, n=2, max_new=8):
    return [tengine.Request(f"{tag}{i}", sysp + np.random.default_rng(
        7 * i + len(tag)).integers(1, vocab, size=8).tolist(), max_new)
        for i in range(n)]


def _serve_engine(eng, reqs):
    for q in reqs:
        eng.submit(q)
    eng.run(max_iters=2000)
    return {q.request_id: tuple(q.output) for q in reqs}


def _tier_phases(pair, fail=None):
    """A planar FP8 engine with a scarce pool spills a prefix and then
    restores it in a third burst, one block a step (lo planes pending).
    `fail` makes one step of that burst fail: "hook" at the top of a step
    while restores are queued, "prefill" inside the prefill launch with a
    spill capture enqueued, "decode" inside the decode launch with a first
    token still `_PENDING`. The engine is then drained, checked clean, and
    the drained requests finish on it in FP16."""
    vocab = pair[1].vocab_size
    rng = np.random.default_rng(0)
    s1, s2 = (rng.integers(1, vocab, size=96).tolist() for _ in range(2))
    eng = _mk(pair, "torch", n_slots=2, n_blocks=11, kv_planar=True,
              forced_mode="fp8",
              restore_policy=tpolicy.RestorePolicy(
                  max_restore_bytes_per_step=1))
    out = _serve_engine(eng, _bursts(vocab, "a", s1))
    out.update(_serve_engine(eng, _bursts(vocab, "b", s2)))
    third = _bursts(vocab, "c", s1)
    for q in third:
        eng.submit(q)
    if fail is not None:
        bm, run = eng.blocks, eng.graphs.run

        def hook(e):
            if fail == "hook" and bm.restore_jobs and bm._lo_pending:
                raise tfaults.InjectedFault("hook")

        def failing(key):
            pending = any(tengine._PENDING in q.output for q in third)
            if bm._lo_pending and key[0] == fail and (
                    eng._captures if fail == "prefill" else pending):
                raise RuntimeError("launch failed")
            return run(key)
        eng.fault_hook, eng.graphs.run = hook, failing
        with pytest.raises(RuntimeError, match="hook|launch failed"):
            for _ in range(200):
                eng.step()
        eng.fault_hook = None
        del eng.graphs.run
        drained = eng.drain_requests()
        assert [q.request_id for q in drained] \
            == [q.request_id for q in third]
        _drained_clean(eng, drained)
        for q in drained:
            eng.submit(q)
    eng.forced_mode = "fp16"             # lo planes would land now
    eng.run(max_iters=2000)
    out.update({q.request_id: tuple(q.output) for q in third})
    return out


@pytest.fixture(scope="module")
def tier_control(qwen):
    return _tier_phases(qwen)


@pytest.mark.parametrize("fail", ["hook", "prefill", "decode"])
def test_drain_settles_what_rows_leave(qwen, tier_control, fail):
    """Whatever a failed step leaves (queued restores, lo-pending blocks
    and their pinned host entries, an unsettled spill capture, a
    `_PENDING` first token), the drain settles it: the block manager's
    invariants hold, no capture is pending, no host entry is pinned, no
    output holds a placeholder; and the drained requests finish on the
    same engine with the tokens of an engine that never failed."""
    assert _tier_phases(qwen, fail) == tier_control


def test_hook_raise_leaves_the_engine_drainable(qwen):
    """A raise at the hook comes before anything mutates: the iteration,
    tables, lengths and outputs are as the last step left them; drained
    and resubmitted, the requests finish with the tokens of a run without
    the raise."""
    vocab = qwen[1].vocab_size
    sysp = np.random.default_rng(1).integers(1, vocab, size=40).tolist()

    raised = []

    def run(fail_at):
        eng = _mk(qwen, "torch")
        reqs = _bursts(vocab, "h", sysp, n=3, max_new=10)

        def hook(e):
            if e.iteration == fail_at:
                raise tfaults.InjectedFault("boom")
        eng.fault_hook = hook
        for q in reqs:
            eng.submit(q)
        while eng.queue or eng.active or eng.prefilling:
            before = (eng.iteration, eng.blocks._tables.copy(),
                      eng.lens.copy(), [list(q.output) for q in reqs])
            try:
                eng.step()
            except tfaults.InjectedFault:
                raised.append(eng.iteration)
                after = (eng.iteration, eng.blocks._tables,
                         eng.lens, [list(q.output) for q in reqs])
                assert after[0] == before[0] and after[3] == before[3]
                assert (after[1] == before[1]).all()
                assert (after[2] == before[2]).all()
                drained = eng.drain_requests()
                _drained_clean(eng, drained)
                eng.fault_hook = None
                for q in drained:
                    eng.submit(q)
        return {q.request_id: tuple(q.output) for q in reqs}

    assert run(fail_at=4) == run(fail_at=-1)
    assert raised == [4]


def test_stall_folds_into_the_step_time(qwen):
    ticks = iter(range(10_000))
    eng = _mk(qwen, "torch", clock=lambda: next(ticks) * 0.004)
    inj = tfaults.FaultInjector(tfaults.FaultPlan(
        [tfaults.FaultEvent(1, 0, "stall", 50.0)]))
    eng.fault_hook = inj.hook(0)
    assert eng.last_mode is None
    eng.submit(tengine.Request("s", list(range(1, 20)), 4))
    stalls, steps = [], []
    for s in range(3):
        inj.arm(s)
        t0 = next(ticks)
        eng.step()
        stalls.append(eng.last_stall_ms)
        steps.append(eng._last_step_ms - (next(ticks) - t0) * 4.0)
        assert eng.last_mode == "fp16"
    assert stalls == [0.0, 50.0, 0.0] and eng.inject_stall_ms == 0.0
    # the stall rides on the measured step; the other steps read the clock
    assert steps[1] - steps[0] == pytest.approx(50.0)


@pytest.mark.parametrize("loaded", [False, True])
def test_corrupt_flips_a_port_entry_in_place(qwen, tmp_path, loaded):
    """The injector's byte flip lands in the port's host entries as they
    are (spilled entries own their bytes; loaded ones are `np.load`
    copies), and the entry's checksum catches it."""
    vocab = qwen[1].vocab_size
    rng = np.random.default_rng(2)
    s1, s2 = (rng.integers(1, vocab, size=96).tolist() for _ in range(2))
    eng = _mk(qwen, "torch", n_slots=2, n_blocks=11,
              persist_dir=str(tmp_path))
    _serve_engine(eng, _bursts(vocab, "a", s1))
    _serve_engine(eng, _bursts(vocab, "b", s2))
    if loaded:
        eng.save_prefix_store()
        eng = _mk(qwen, "torch", n_slots=2, n_blocks=11,
                  persist_dir=str(tmp_path))
    host = eng.blocks.host
    assert len(host.entries) > 0
    assert all(a.flags.writeable for p in host.entries.values()
               for a in p.values())
    before = {k: {n: a.copy() for n, a in p.items()}
              for k, p in host.entries.items()}
    inj = tfaults.FaultInjector(tfaults.FaultPlan(
        [tfaults.FaultEvent(0, 0, "corrupt")], seed=4))
    inj.arm(0)
    ids = {k: {n: id(a) for n, a in p.items()} for k, p in host.entries.items()}
    inj.hook(0)(eng)
    flipped = [(k, n) for k, p in host.entries.items() for n, a in p.items()
               if a.tobytes() != before[k][n].tobytes()]
    assert len(flipped) == 1
    (key, name), = flipped
    assert id(host.entries[key][name]) == ids[key][name]   # in place
    diff = host.entries[key][name].view(np.uint8) \
        ^ before[key][name].view(np.uint8)
    assert np.count_nonzero(diff) == 1 and diff.max() == 0xFF
    assert not host.verify(key)
    assert all(host.verify(k) for k in host.entries if k != key)


def test_meshes_are_still_refused(qwen):
    """Serving meshes are ported: objects that are not a
    `launch.mesh.Mesh` are refused with a TypeError, by the engine and by
    `Router.build(meshes=)`, and replica meshes are served. The fault hook
    is kept as given."""
    jcfg, tcfg, jsp, tsp = qwen
    kw = dict(device="cpu", n_slots=2, capacity=64)
    with pytest.raises(TypeError, match="Mesh"):
        trouter.Router.build(tcfg, tsp, 2, meshes=[object(), object()],
                             engine_kwargs=kw)
    with pytest.raises(TypeError, match="Mesh"):
        tengine.Engine(tcfg, tsp, n_slots=2, capacity=64, device="cpu",
                       mesh=object())
    meshes = make_replica_meshes(2, 2, devices=["cpu"] * 4)
    r = trouter.Router.build(tcfg, tsp, 2, meshes=meshes,
                             engine_kwargs=dict(kw, forced_mode="fp16"))
    out = _serve(r, _shared_burst(SIDES["torch"], tcfg.vocab_size, n=2,
                                  max_new=3))
    assert len(out) == 2 and r.stats()["lost"] == 0
    assert [rep.engine.mesh for rep in r.replicas] == meshes
    hook = tfaults.FaultInjector(tfaults.FaultPlan()).hook(0)
    eng = tengine.Engine(tcfg, tsp, n_slots=2, capacity=64, device="cpu",
                         fault_hook=hook)
    assert eng.fault_hook is hook


@pytest.mark.usefixtures("settled_jax_tables")
def test_router_build_shares_the_weights(qwen):
    """Replicas built from one serving tree hold one copy of the weights
    (each its own pool); the build serves a burst with the JAX build's
    tokens."""
    jcfg, tcfg, jsp, tsp = qwen
    kw = dict(n_slots=2, capacity=64, forced_mode="fp16", block_size=16,
              n_blocks=11, chunk_tokens=32)
    r = trouter.Router.build(tcfg, tsp, 2,
                             engine_kwargs=dict(kw, device="cpu"))
    assert all(rep.factory is not None for rep in r.replicas)
    a, b = (rep.engine for rep in r.replicas)
    wa = [t.data_ptr() for t in leaves(a.params)]
    assert wa and wa == [t.data_ptr() for t in leaves(b.params)] \
        == [t.data_ptr() for t in leaves(tsp)]
    assert a.caches["attn"]["k"].data_ptr() \
        != b.caches["attn"]["k"].data_ptr()
    out = _serve(r, _shared_burst(SIDES["torch"], tcfg.vocab_size, 2, 4))
    jr = jrouter.Router.build(jcfg, jsp, 2, engine_kwargs=kw)
    assert out == _serve(jr, _shared_burst(SIDES["jax"], jcfg.vocab_size,
                                           2, 4))
    assert r.stats() == jr.stats() and r.stats()["lost"] == 0

