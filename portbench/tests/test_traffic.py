"""The chat mix's generator: determinism, seeds that draw different
requests from cycles of the same lengths, its length distributions, and
the closed loop's polling."""

import statistics

from portbench import spec
from portbench.traffic import closed_loop as CL


def chat():
    return spec.read_json("traffic", "chat")


def first(src, n):
    out = src.poll([])
    while len(out) < n:
        out += src.poll([r.client for r in out[-4:]])
    return out[:n]


def test_same_seed_same_requests():
    a = first(CL.make(chat(), 2**31 + 17, 32256, 8), 40)
    b = first(CL.make(chat(), 2**31 + 17, 32256, 8), 40)
    assert [(r.client, r.tokens, r.max_new) for r in a] == \
        [(r.client, r.tokens, r.max_new) for r in b]


def test_seeds_draw_other_requests_from_cycles_of_the_same_lengths():
    params = chat()
    n = params["cycle"]
    prompts = sorted(CL.quantile_lengths(params["prompt"], n))
    outputs = sorted(CL.quantile_lengths(params["output"], n))
    runs = [first(CL.make(params, seed, 32256, 4), 3 * n)
            for seed in (1, 987654321012)]
    sizes = [[(len(r.tokens), r.max_new) for r in rs] for rs in runs]
    for rs in sizes:
        for c in range(3):
            cyc = rs[c * n:(c + 1) * n]
            assert sorted(p for p, _ in cyc) == prompts
            assert sorted(o for _, o in cyc) == outputs
        # the pairing and the order change from cycle to cycle
        assert rs[:n] != rs[n:2 * n]
    # and from seed to seed, with the token ids
    assert sizes[0] != sizes[1]
    assert runs[0][0].tokens != runs[1][0].tokens


def test_lengths_follow_the_lognormals():
    params = chat()
    n = 1024
    prompts = CL.quantile_lengths(params["prompt"], n)
    outputs = CL.quantile_lengths(params["output"], n)
    assert min(prompts) >= 64 and max(prompts) <= 3072
    assert min(outputs) >= 8 and max(outputs) <= 1024
    # the quantile grid's median is the lognormal's: the trace's medians
    assert abs(statistics.median(prompts) - 1020) <= 2
    assert abs(statistics.median(outputs) - 129) <= 1
    # sigma 0.5: the quartiles sit at median * exp(+-0.5 * 0.674)
    q = statistics.quantiles(prompts, n=4)
    assert abs(q[0] - 1020 * 0.7139) < 6 and abs(q[2] - 1020 * 1.4007) < 8
    # clipping leaves a tail at the bounds, not beyond
    assert prompts.count(3072) >= 1 and outputs.count(1024) >= 1
    # the mix's own cycle stays inside the bounds
    cyc = CL.quantile_lengths(params["prompt"], params["cycle"])
    assert max(cyc) < 3072 and min(cyc) > 64


def test_tokens_are_uniform_over_the_vocabulary():
    src = CL.make(chat(), 5, 1000, 1)
    toks = [t for _ in range(30) for t in src.make(0).tokens]
    assert min(toks) >= 0 and max(toks) < 1000
    assert abs(statistics.mean(toks) - 499.5) < 15


def test_closed_loop_polls_one_per_client_then_one_per_finish():
    src = CL.make(chat(), 3, 100, 5)
    assert [r.client for r in src.poll([])] == [0, 1, 2, 3, 4]
    assert [r.client for r in src.poll([3, 1])] == [3, 1]
    assert src.poll([]) == []
