"""End-to-end training driver on the PyTorch port: train a dense model
(qwen1.5-0.5b at 12 layers, d_model 768: 203.4M params with its
151936-token vocab) for a few hundred steps on the synthetic pipeline,
as the JAX package's example does, and checkpoint it to out/tiny_ckpt (under
the working directory) in the checkpoint format both packages read.
The --fast checkpoint serves with `python -m repro_torch.launch.serve
--arch qwen1.5-0.5b --reduced --ckpt out/tiny_ckpt`.

Run: PYTHONPATH=src python examples_torch/train_tiny.py
Smaller: PYTHONPATH=src python examples_torch/train_tiny.py --fast
On the CPU: add --device cpu.
"""
import argparse
import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parent.parent / "src"


def command(fast: bool, steps: int, device: str) -> list[str]:
    """The `repro_torch.launch.train` command line of the JAX example's
    arguments, plus the device."""
    if fast:
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
               "qwen1.5-0.5b", "--reduced", "--steps", str(steps or 60),
               "--batch", "8", "--seq", "128", "--ckpt", "out/tiny_ckpt"]
    else:
        # the JAX example's config: qwen1.5-0.5b at 12 layers / d_model 768
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
               "qwen1.5-0.5b", "--layers", "12", "--scale", "0.75",
               "--steps", str(steps or 300), "--batch", "16", "--seq",
               "256", "--micro", "2", "--ckpt", "out/tiny_ckpt"]
    return cmd + ["--device", device]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true", help="tiny 2-layer variant")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card, the default) or 'cpu'")
    args = ap.parse_args(argv)
    # the launcher resolves the device too; failing here keeps a missing
    # card from costing a subprocess
    from repro_torch.device import resolve_device
    resolve_device(args.device)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(SRC), os.environ.get("PYTHONPATH", "")) if p))
    return subprocess.run(command(args.fast, args.steps, args.device),
                          env=env).returncode


if __name__ == "__main__":
    sys.exit(main())
