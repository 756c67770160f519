"""The cell's control, at a size a test run holds: the comparison that
decides `correct` passes the program's sound runs and fails the control,
the program's own FP8 path (the engine forced to FP8) judged against the
FP16 reference, one step below the configuration's precision. A reduced
model (2 layers at d_model 256) drifts less than the full one, so the
limit here is the test size's own (`TEST_LIMIT`, set from these
readings: sound runs read 0 to 0.007, the control 0.08 to 0.73); the
cell's limit, set on the card at full size, is in PERF.md."""

import pytest

from portbench.tests._cells import reduced_cell, run_reduced

SEEDS = (11, 2**31 + 3, 40961)
TEST_LIMIT = 0.02


@pytest.mark.parametrize("seed", SEEDS)
def test_fp16_cell_fails_its_control(seed):
    name = "dsc33b.chat.fp16"
    sound = run_reduced(reduced_cell(name, limit=TEST_LIMIT), seed)
    control = run_reduced(reduced_cell(name, limit=TEST_LIMIT), seed,
                          policy="fp8")
    assert sound["correct"], sound["readings"]
    assert not control["correct"], control["readings"]
