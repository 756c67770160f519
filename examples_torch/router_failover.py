"""Fault-tolerant multi-replica serving demo on the PyTorch port: a
shared-prefix burst through a 3-replica `Router` while a seeded
`FaultPlan` kills one replica mid-generation and revives it later.

What to watch for in the output:

* the kill drains the dead replica's in-flight requests and replays
  them on the survivors — partly from the survivors' own warm prefix
  KV (restored tokens), partly recomputed — and the final outputs equal
  a no-fault run: bitwise on the CPU (greedy generation is
  batch-invariant and replay re-establishes prompt + already-emitted
  tokens). On the card a replayed prefill sums in another order than
  the decode steps it replaces, so a stream may part from the no-fault
  one, and only where the no-fault stream's top-2 logit margin there
  is below MARGIN_RULE (the rule chip_smoke.py holds the same router
  to); each parting is printed with its margin;
* the `DegradePolicy` pins survivors to FP8 while the fleet runs
  short-handed (same nested weight buffers, per-iteration switch, so
  the capacity response is free) and re-probes FP16 only after a
  hysteresis dwell once the replica returns — FP8 rounding changes
  tokens, so the equality run keeps `force_fp8=False` and the
  degradation run demonstrates the mode response instead;
* `Router.stats()["lost"]` stays 0: every submitted request is
  exactly-once completed, shed, or in flight.

Run: PYTHONPATH=src python examples_torch/router_failover.py \\
         [--replicas 3] [--device cpu]
"""
import argparse
import sys

import numpy as np
import torch

from repro_torch.configs import ARCHS
from repro_torch.core.policy import DegradePolicy
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import model as M
from repro_torch.models.convert import to_serving
from repro_torch.models.layers import Runtime
from repro_torch.serving.engine import Request
from repro_torch.serving.faults import FaultEvent, FaultPlan
from repro_torch.serving.router import Router, StepCostModel, VirtualClock

ENGINE_KWARGS = dict(n_slots=4, capacity=128, forced_mode="fp16",
                     block_size=16, n_blocks=24, chunk_tokens=64)
MARGIN_RULE = 1e-3


def burst(system_prompt, n=8, max_new=12):
    return [Request(f"r{i}", system_prompt + list(
        np.random.RandomState(13 * i + 1).randint(1, 500, 8)), max_new)
        for i in range(n)]


def top2_margin(cfg, sparams, seq, device) -> float:
    """The top-2 logit margin after `seq`, from one FP16 `paged_step`
    over the whole sequence in a pool of its own. A reference recompute:
    the kernel launch counters are left as they were."""
    before = ops.all_launch_counters()
    bs = ENGINE_KWARGS["block_size"]
    nb = -(-len(seq) // bs)
    caches = M.init_paged_cache(cfg, nb + 1, bs, device=device, n_slots=1)
    tables = torch.arange(1, nb + 1, dtype=torch.int32, device=device)[None]
    n = torch.tensor([len(seq)], dtype=torch.int32, device=device)
    rt = Runtime(mode="fp16", dtype=torch.float32, act_quant="per_token")
    logits = M.paged_step(
        rt, sparams, cfg, torch.tensor([seq], dtype=torch.int32,
                                       device=device),
        caches, tables, q_offset=torch.zeros(1, dtype=torch.int32,
                                             device=device),
        kv_len=n, block_size=bs, logit_position=n - 1, return_logits=True)
    top2 = logits[0].topk(2).values
    after = ops.all_launch_counters()
    ops.add_launches({k: before[k] - after[k] for k in after})
    return float(top2[0] - top2[1])


def hold_to_reference(cfg, sparams, prompts, ref, out, device) -> list:
    """Equal streams, or (on the card) streams that part only at a token
    where the reference's top-2 margin is below MARGIN_RULE. Returns the
    partings."""
    if device.type == "cpu":
        assert out == ref, "failover continuation diverged from no-fault run"
        return []
    partings = []
    for rid, want in sorted(ref.items()):
        got = out[rid]
        j = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b),
                 None)
        if j is None:
            assert len(got) == len(want), f"{rid}: lengths differ"
            continue
        m = top2_margin(cfg, sparams, list(prompts[rid]) + list(want[:j]),
                        device)
        print(f"  {rid} parts from the no-fault run at token {j} "
              f"(no-fault {want[j]}, got {got[j]}), no-fault top-2 margin "
              f"{m:.3e}")
        assert m < MARGIN_RULE, \
            f"{rid} parts at token {j} with a top-2 margin of {m:.3e}"
        partings.append({"request": rid, "position": j, "margin": m})
    return partings


def report(st):
    print(f"  completed {st['completed']}/{st['submitted']} in "
          f"{st['steps']} steps, lost={st['lost']}, shed={st['shed']}")
    print(f"  replicas: {st['replicas']}")
    print(f"  failover: {st['failover_requests']} requests re-homed, "
          f"{st['failover_restored_tokens']} tokens restored from warm "
          f"KV, {st['failover_recomputed_tokens']} recomputed")


def run(cfg, sparams, *, replicas: int = 3, kill_step: int = 5,
        device) -> dict:
    """The demo's three router runs (no faults; kill + revive in FP16;
    the same under FP8 degradation) with the JAX example's assertions.
    Returns the FP16 fault run's partings from the no-fault run and the
    two fault runs' stats."""
    rng = np.random.RandomState(0)
    system_prompt = list(rng.randint(1, 500, 32))
    prompts = {r.request_id: r.tokens for r in burst(system_prompt)}

    def serve(plan, force_fp8):
        vc = VirtualClock()
        router = Router.build(
            cfg, sparams, replicas,
            engine_kwargs=dict(ENGINE_KWARGS, clock=vc, device=device),
            plan=plan, clock=vc, cost_model=StepCostModel(),
            policy=DegradePolicy(force_fp8=force_fp8,
                                 shed_budget_tokens=2048, restore_scale=0.5,
                                 hysteresis_steps=6),
            affinity_blocks=1, balance_slack_tokens=64)
        for req in burst(system_prompt):
            router.submit(req)
        router.run()
        return ({r.request_id: tuple(r.output) for r in router.finished},
                router.stats(), router)

    plan = FaultPlan([FaultEvent(kill_step, 0, "kill"),
                      FaultEvent(kill_step + 8, 0, "revive")])

    print(f"model: {cfg.arch_id}, replicas: {replicas}")
    print("— no-fault reference run —")
    ref, ref_st, _ = serve(plan=None, force_fp8=False)
    print(f"  completed {ref_st['completed']}/{ref_st['submitted']} in "
          f"{ref_st['steps']} steps")

    print(f"— chaos run (fp16 failover): kill replica 0 @ step "
          f"{kill_step}, revive @ step {kill_step + 8} —")
    out, st, _ = serve(plan, force_fp8=False)
    report(st)
    assert st["lost"] == 0, "a request was lost"
    assert st["kills"] == 1 and st["failover_requests"] > 0
    partings = hold_to_reference(cfg, sparams, prompts, ref, out, device)
    print(f"  outputs equal to the no-fault run "
          f"({len(ref) - len(partings)}/{len(ref)} streams"
          + (f"; {len(partings)} part at a near-tie)" if partings
             else ", bit-identical)") + "; zero lost")

    print("— chaos run (FP8 degradation): same plan, force_fp8=True —")
    out8, st8, router = serve(plan, force_fp8=True)
    report(st8)
    print(f"  degrade: {st8['degrade_fp8_steps']} survivor-steps pinned "
          f"FP8, per-replica dwell {st8['fp8_dwell']}")
    assert st8["lost"] == 0 and st8["degrade_fp8_steps"] > 0
    # idle the fleet past the hysteresis dwell: FP16 is re-probed only
    # after the revived replica has proven itself for a full dwell
    for _ in range(12):
        router.step()
    modes = {r.rid: r.engine.forced_mode for r in router.replicas}
    print(f"  after revive + hysteresis dwell, forced modes: {modes}")
    assert all(m == "fp16" for m in modes.values()), modes
    print("fleet degraded to FP8 under the kill, re-probed FP16 after "
          "recovery; zero lost in every run")
    return {"partings": partings, "fault": st, "degrade": st8}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=sorted(ARCHS))
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--kill-step", type=int, default=5,
                    help="router step at which replica 0 is killed")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card, the default) or 'cpu'")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = ARCHS[args.arch].reduced()
    sparams = to_serving(M.init_params(cfg, seed=0, device=device))
    run(cfg, sparams, replicas=args.replicas, kill_step=args.kill_step,
        device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
