"""The percentile and rate arithmetic over all requests, and the
reckoning of K1's bytes and FLOPs and of the model FLOPs a token, at
both configurations' shapes, against numbers worked by hand."""

import math

import numpy as np
import pytest

from portbench import reckon, spec
from portbench.loop import StepRec, Track
from portbench.record import Window, percentile

DS = spec.model_of(spec.read_json("configs", "deepseek-coder-33b"))
GR = spec.model_of(spec.read_json("configs", "granite-moe-3b-a800m"))


@pytest.mark.parametrize("xs", [[5.0], [3.0, 1.0], list(range(11)),
                                [0.5, 9.0, 2.25, 7.0, 7.0, 1.0, 3.5]])
@pytest.mark.parametrize("q", [0, 50, 90, 100])
def test_percentile_is_numpys_linear(xs, q):
    assert percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def _track(submit, first, finish, n):
    return Track(client=0, prompt_len=10, max_new=n, req=None,
                 t_submit=submit, t_first=first, t_finish=finish, seen=n)


def _window(tracks, steps):
    return Window(model=DS, policy="fp16", t0=10.0, t1=20.0, steps=steps,
                  step_dt=[1.0] * len(steps), traced=[], tracks=tracks,
                  stats={}, setup_s=1.0, peak_bytes=0)


def test_latencies_are_over_requests_and_gaps_in_the_window():
    from portbench.spec import load_module

    # request i: submitted at 10 + i / 2, first token 0.1 * (i + 1) later,
    # then 10 more tokens 10 * (i + 1) ms apart
    tracks = []
    for i in range(10):
        first = 10 + i / 2 + 0.1 * (i + 1)
        times = [first + 0.01 * (i + 1) * j for j in range(11)]
        tracks.append(_track(10 + i / 2, first, times[-1], 11))
        tracks[-1].token_times = times
    # one finished before the window opened, one never got its first token
    old = _track(1.0, 2.0, 3.0, 11)
    old.token_times = [2.0 + 0.1 * j for j in range(11)]
    tracks += [old, _track(19.0, None, None, 16)]
    w = _window(tracks, [])
    itl = load_module("metrics", "itl_p90_ms").read(w)
    ttft = load_module("metrics", "ttft_p50_ms").read(w)
    assert itl == pytest.approx(percentile([10.0 * (i + 1) for i in range(10)
                                            for _ in range(10)], 90))
    assert ttft == pytest.approx(percentile([100.0 * (i + 1)
                                             for i in range(10)], 50))
    # a gap whose later token came after the close is not counted
    tracks[9].token_times.append(20.5)
    assert load_module("metrics", "itl_p90_ms").read(w) == itl


def test_throughput_counts_every_token_over_the_window():
    from portbench.spec import load_module

    steps = [StepRec(0, 0, 0, 1, 64, 0, e, 0.0) for e in (64, 63, 70, 1)]
    assert load_module("metrics", "throughput_tok_s").read(
        _window([], steps)) == pytest.approx(198 / 10.0)


def test_k1_bytes_and_flops_by_hand():
    # deepseek's gate projection at 8 rows: 2 * 8 * 7168 * 19200 FLOPs;
    # both planes 2 * 7168 * 19200 B, x 2 * 8 * 7168 B, out 4 * 8 * 19200 B
    f, b = reckon.k1_call(8, 7168, 19200)
    assert f == 2202009600.0
    assert b == 275251200 + 114688 + 614400
    # a whole decode dispatch at 8 rows is memory-bound: 62 layers of
    # 2 * (2 * 7168 * 7168 + 2 * 7168 * 1024 + 3 * 7168 * 19200) B of planes
    planes = 62 * 2 * (2 * 7168 * 7168 + 2 * 7168 * 1024 + 3 * 7168 * 19200)
    assert planes == 65_759_346_688
    small = 62 * sum(2 * 8 * k + 4 * 8 * n
                     for k, n in reckon.linear_shapes(DS))
    assert reckon.k1_bound_s(DS, 8) == pytest.approx(
        (planes + small) / 3.35e12)
    # at 4096 rows every call is compute-bound
    flops = 62 * 2 * 4096 * (2 * 7168 * 7168 + 2 * 7168 * 1024
                             + 3 * 7168 * 19200)
    assert reckon.k1_bound_s(DS, 4096) == pytest.approx(flops / 989e12)


def test_model_flops_a_token_by_hand():
    # deepseek: 62 * (2 * 7168^2 + 2 * 7168 * 1024 + 3 * 7168 * 19200)
    # weights a layer, plus the 7168 x 32256 head
    n = 62 * (2 * 7168 ** 2 + 2 * 7168 * 1024 + 3 * 7168 * 19200) \
        + 7168 * 32256
    assert reckon.params_per_token(DS) == n == 33_110_884_352
    # at position 99 a token sees 100 keys: 4 * 100 * 56 * 128 * 62
    assert reckon.token_flops(DS, 99) == 2 * n + 4 * 100 * 56 * 128 * 62
    # granite: attention 1536 x (1536 + 512 + 512) + 1536^2, router
    # 1536 x 40, 8 experts of 3 x 1536 x 512, 32 layers; head 1536 x 49155
    g = 32 * (1536 * 2560 + 1536 ** 2 + 1536 * 40 + 8 * 3 * 1536 * 512) \
        + 1536 * 49155
    assert reckon.params_per_token(GR) == g == 882_774_528
    # a 3-token prompt: positions 0, 1, 2 see 1, 2, 3 keys
    assert reckon.prompt_flops(GR, 3) == pytest.approx(
        sum(reckon.token_flops(GR, p) for p in range(3)))


def test_step_mfu_is_flops_over_time_at_the_modes_peak():
    from portbench.spec import load_module

    steps = [StepRec(0, 0, 0, 1, 64, 0, 64, 989e12 * 0.5)] * 4
    w = _window([], steps)
    w.step_dt = [1.0] * 4
    assert load_module("metrics", "step_mfu").read(w) == pytest.approx(50.0)
    w.policy = "fp8"
    assert load_module("metrics", "step_mfu").read(w) == pytest.approx(
        100 * 0.5 * 989 / 1979)
    assert not math.isnan(reckon.HBM_BYTES_S)


def test_decode_floor_by_hand():
    # deepseek at 24 rows: the nested linears' bound, and the f32 head's
    # 4 * 7168 * 32256 B read once
    assert reckon.decode_floor_s(DS, 24) == pytest.approx(
        reckon.k1_bound_s(DS, 24) + 4 * 7168 * 32256 / 3.35e12)
    # granite at 2 rows: 16 of its 40 experts can be chosen, each
    # 3 * 1536 * 512 f16 weights in each of 32 layers
    assert reckon.decode_floor_s(GR, 2) == pytest.approx(
        reckon.k1_bound_s(GR, 2) + (32 * 16 * 3 * 1536 * 512 * 2
                                    + 4 * 1536 * 49155) / 3.35e12)


def test_idle_share_leaves_out_graph_launches():
    from portbench.spec import load_module
    from portbench.trace import Trace

    # a 100 us stretch: kernels over [10, 40) and [60, 90); the host is
    # inside a graph launch over [0, 20) and [45, 50)
    tr = Trace(device=[("k", 10, 40), ("k", 60, 90)],
               host=[("cudaGraphLaunch", 0, 20), ("cudaGraphLaunch", 45, 50),
                     ("bench.step", 0, 100)], t0_us=0, t1_us=100)
    assert tr.busy_s() == pytest.approx(60e-6)
    assert tr.graph_launch_idle_s() == pytest.approx(15e-6)
    w = _window([], [])
    w.trace = tr
    # idle 40 us, of which 15 in launches: 25 of 85
    assert load_module("metrics", "device_idle_frac").read(w) == \
        pytest.approx(25 / 85)
    assert [round(s * 1e6) for _, s in tr.gaps()] == [10, 20, 10]


def test_torch_ops_are_read_per_mixed_step():
    from portbench.spec import load_module
    from portbench.trace import Trace

    # two traced steps, host spans [0, 100) and [100, 300): a decode step
    # (a port kernel, a copy) and a mixed one (softmax 50 us, a K1 call)
    wg = "void nfp_wg::wg_kernel<nfp_wg::Cfg<128, 1, 8, true, 2, 128, 1> >"
    tr = Trace(device=[(wg, 10, 60), ("copy", 60, 70),
                       ("softmax", 120, 170), (wg, 170, 290)],
               host=[("bench.step", 0, 100), ("bench.step", 100, 300)],
               t0_us=0, t1_us=300)
    assert tr.by_step() == [{wg: pytest.approx(50e-6),
                             "copy": pytest.approx(10e-6)},
                            {"softmax": pytest.approx(50e-6),
                             wg: pytest.approx(120e-6)}]
    steps = [StepRec(0, 0, 0, 1, 24, 0, 24, 0.0),
             StepRec(0, 0, 1, 1, 24, 256, 24, 0.0)]
    w = _window([], steps)
    w.trace, w.traced = tr, [0, 1]
    read = load_module("metrics", "torch_ops_ms_per_mixed_step").read
    assert read(w) == pytest.approx(0.05)
    # a stretch with no mixed step gives nothing to read
    w.steps = [steps[0], steps[0]]
    assert read(w) is None
