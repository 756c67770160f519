"""Reproduce paper Fig. 1b: p90 TPOT + SLO-violation seconds for
FP16-only, FP8-only, and NestedFP dual-precision serving on a bursty
Azure-like trace, with the PyTorch port's trace and simulator.

The cost model's numbers are the JAX package's example's modelled
assumptions (Llama-3.1-8B-ish on one H100-class budget), not
measurements taken on the card: calibrating them against the port's
measured steps waits for the port's benchmark. The simulation runs on
the host; nothing is launched on the device.

Run: PYTHONPATH=src python examples_torch/slo_trace_sim.py [--device cpu]
"""
import argparse
import sys

from repro_torch.device import resolve_device
from repro_torch.serving import simulate, trace

# Llama-3.1-8B-ish: 8B params, H100 bw/compute budget scaled to the
# cost model (the JAX example's numbers)
COST = simulate.CostModel(fixed_ms=2.0, weight_read_ms_fp16=16.0,
                          weight_read_ms_fp8=8.0, kv_ms_per_ktoken=0.002,
                          compute_ms_per_token_fp16=0.055,
                          compute_ms_per_token_fp8=0.0275)


def run(cost: simulate.CostModel = COST) -> list[str]:
    """Print the trace's rate stats and the three policies' table;
    returns the table's lines."""
    reqs = trace.azure_like(duration_s=60, mean_rate=5.05, seed=7,
                            prompt_len=256, max_new=512)
    print("trace:", trace.rate_stats(reqs, 60))
    head = (f"{'policy':8s} {'p90 TPOT':>9s} {'p90 TTFT':>9s} "
            f"{'SLO-viol s':>10s} {'%fp16':>6s} {'finished':>8s}")
    print(head)
    lines = [head]
    for pol in ("fp16", "fp8", "dual"):
        r = simulate.simulate(reqs, cost, policy=pol)
        line = (f"{pol:8s} {r.p90_tpot_ms:9.1f} {r.p90_ttft_ms:9.1f} "
                f"{r.slo_violation_s:10.1f} {r.fp16_fraction*100:6.1f} "
                f"{r.n_finished:8d}")
        print(line)
        lines.append(line)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'; the simulation "
                         "itself runs on the host either way")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
