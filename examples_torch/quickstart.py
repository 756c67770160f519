"""Quickstart: the NestedFP format + dual-precision linear in 20 lines,
on the PyTorch port.

Run: PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]

On the card the encode runs K8 (`nestedfp_encode`), the FP16 linear K1
(`nestedfp16_matmul`) and the FP8 linear K7
(`nestedfp8_matmul_fused_quant`, the per-tensor scale); with
`--device cpu` their plain PyTorch versions run.
"""
import argparse
import sys

import numpy as np
import torch

from repro_torch.core import NestedLinearParams, NestedTensor, nested_linear
from repro_torch.device import resolve_device


def run(device) -> dict:
    # 1. any f16 weight with |w| <= 1.75 splits into two uint8 tensors
    w = torch.from_numpy(np.random.RandomState(0).uniform(
        -1.5, 1.5, (512, 256)).astype(np.float16)).to(device)
    nt = NestedTensor.from_f16(w)
    print(f"storage: upper {nt.upper.nbytes}B + lower {nt.lower.nbytes}B "
          f"== f16 {w.nbytes}B  (zero overhead)")

    # 2. FP16 read is BIT-EXACT (paper's lossless reconstruction)
    assert torch.equal(nt.read_f16().view(torch.int16), w.view(torch.int16))
    print("fp16 reconstruction: bit-exact ✓")

    # 3. FP8 read is the upper byte — a valid e4m3 tensor at scale 2^-8
    w8, scale = nt.read_fp8()
    err = float((w8.to(torch.float32) * float(scale)
                 - w.to(torch.float32)).abs().max())
    print(f"fp8 view: max |err| = {err:.4f} (e4m3 grid)")

    # 4. one linear layer, two precisions, same bytes
    x = torch.from_numpy(np.random.RandomState(1).randn(4, 512)
                         .astype(np.float16)).to(device)
    params = NestedLinearParams(weight=nt, bias=None)
    y16 = nested_linear(params, x, mode="fp16", out_dtype=torch.float32)
    y8 = nested_linear(params, x, mode="fp8", out_dtype=torch.float32)
    cos = float(torch.sum(y16 * y8)
                / (torch.linalg.norm(y16) * torch.linalg.norm(y8)))
    print(f"fp16 vs fp8 output cosine: {cos:.5f}")
    return {"max_err": err, "cosine": cos}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card, the default) or 'cpu'")
    args = ap.parse_args(argv)
    run(resolve_device(args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
