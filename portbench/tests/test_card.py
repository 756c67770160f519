"""The harness on a card at reduced size: a traced run whose per-layer
metrics, breakdown and device times are read from the profiler, and
whose served tokens pass the check. Needs a CUDA device (marked `gpu`);
on the chip: `python -m pytest -q -m gpu portbench/tests`."""

import pytest
import torch

from portbench.tests._cells import reduced_cell, run_reduced


@pytest.mark.gpu
def test_traced_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the traced run needs the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = reduced_cell("dsc33b.chat.fp16", limit=0.02)
    # a reduced step takes a few ms on the card: plan the keys that far
    res = run_reduced(cell, 99, 2.0, trace=True, device="cuda",
                      floor_s=0.0005)
    assert res["correct"], res["readings"]
    assert res["window"]["captured_in_window"] == 0
    dev = res["device"]
    assert 0 < dev["busy_s"] <= dev["window_s"]
    m = res["metrics"]
    assert 0 < m["k1_roofline"]["value"] <= 105
    assert 0 <= m["device_idle_frac"]["value"] < 1
    assert res["breakdown"]["device_ops"]
