"""The port's CUDA kernels on the card, against their plain PyTorch versions.

These tests need a CUDA device and nvcc (the kernels are built from
src/repro_torch/csrc at first use); without a card they skip. They import
nothing of JAX, so they also run on a machine that has only PyTorch:

    python -m pytest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import nestedfp as nf  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import to_serving  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402

pytestmark = pytest.mark.gpu
GEMM_TOL = dict(rtol=1e-3, atol=1e-2)
ATTN_TOL = dict(rtol=2e-4, atol=2e-4)
SHAPES = [(8, 4096, 1024), (37, 999, 1001), (256, 512, 384), (1, 64, 8)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _gemm(dev, m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(-2, 2, (m, k)).astype(np.float32)).to(dev)
    w = torch.from_numpy((rng.normal(size=(k, n)) * k ** -0.5)
                         .astype(np.float16)).to(dev)
    return x, w


@pytest.mark.parametrize("shape", SHAPES)
def test_nestedfp16_matmul(dev, shape):
    x, w = _gemm(dev, *shape)
    u, l = nf.encode(w)
    n0 = ops.all_launch_counters()["nestedfp16_matmul"]
    got = ops.matmul_nested_f16(x.half(), u, l)
    torch.testing.assert_close(got, ref.nestedfp16_matmul_ref(x.half(), u, l),
                               **GEMM_TOL)
    assert ops.all_launch_counters()["nestedfp16_matmul"] == n0 + 1


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("act_quant", ["per_tensor", "per_token"])
def test_nestedfp8_matmul(dev, shape, act_quant):
    x, w = _gemm(dev, *shape, seed=1)
    u, _ = nf.encode(w)
    xq, s = getattr(quant, f"quantize_act_{act_quant}")(x)
    got = ops.matmul_nested_fp8(xq, u, s)
    torch.testing.assert_close(got, ref.nestedfp8_matmul_ref(xq, u, s),
                               **GEMM_TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_f16_matmul(dev, shape):
    x, w = _gemm(dev, *shape, seed=2)
    got = ops.matmul_f16(x.half(), w)
    torch.testing.assert_close(got, ref.matmul_f16_ref(x.half(), w),
                               **GEMM_TOL)


def test_gemm_rows_do_not_depend_on_the_batch(dev):
    """One row computed alone equals the same row inside M = 256: the
    kernels keep one K order whatever tile shape M selects."""
    x, w = _gemm(dev, 256, 4096, 1024, seed=3)
    u, l = nf.encode(w)
    full = ops.matmul_nested_f16(x.half(), u, l)
    one = ops.matmul_nested_f16(x[17:18].half(), u, l)
    assert torch.equal(full[17:18], one)


@pytest.mark.parametrize("fp8", [False, True])
@pytest.mark.parametrize("window", [None, 0, 5])
def test_paged_planar_decode_attention(dev, fp8, window):
    rng = np.random.default_rng(4)
    b, h, hkv, d, bs, mb = 3, 8, 2, 64, 16, 4
    nb = 1 + b * mb
    tables = rng.permutation(np.arange(1, nb)).astype(np.int32).reshape(b, mb)
    tables[2, :2] = tables[0, :2]
    lens = np.asarray([50, 0, 37], np.int32)
    for r in range(b):
        tables[r, -(-int(lens[r]) // bs):] = 0
    q = torch.from_numpy(rng.normal(size=(b, h, d)).astype(np.float32)).to(dev)
    kv = torch.from_numpy(rng.normal(size=(2, nb, bs, hkv, d))
                          .astype(np.float16)).to(dev)
    planes = dict(zip(("k_hi", "k_lo"), nf.split_bytes(kv[0])))
    planes.update(zip(("v_hi", "v_lo"), nf.split_bytes(kv[1])))
    tab, ln = torch.from_numpy(tables).to(dev), torch.from_numpy(lens).to(dev)
    got = ops.paged_decode_attention(q, planes, tab, ln, fp8=fp8,
                                     window=window)
    want = ref.paged_planar_decode_attention_ref(
        q, planes["k_hi"], planes["k_lo"], planes["v_hi"], planes["v_lo"],
        tab, ln, fp8=fp8, window=window)
    live = ln > 0
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got[live], want[live], **ATTN_TOL)


def test_engine_serves_on_the_card(dev):
    """A reduced model served on the card in both modes: every request
    finishes, and the decode went through the kernels."""
    cfg = get_arch("llama3.1-8b").reduced()
    sp = to_serving(M.init_params(cfg, seed=0, device=dev))
    before = ops.all_launch_counters()
    for mode in ("fp16", "fp8"):
        eng = Engine(cfg, sp, n_slots=4, capacity=64, forced_mode=mode,
                     kv_planar=True)
        for i in range(5):
            eng.submit(Request(f"r{i}", list(range(3 + i, 20 + i)), 6))
        fin = eng.run()
        assert len(fin) == 5 and all(len(r.output) == 6 for r in fin)
    after = ops.all_launch_counters()
    for name in ("nestedfp16_matmul", "nestedfp8_matmul",
                 "paged_planar_decode_attention"):
        assert after[name] > before[name], name
