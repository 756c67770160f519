"""The port's CUDA kernels on the card, against their plain PyTorch versions.

These tests need a CUDA device and nvcc (the kernels are built from
src/repro_torch/csrc at first use); without a card they skip. They import
nothing of JAX, so they also run on a machine that has only PyTorch:

    python -m pytest -m gpu tests/test_torch_gpu.py
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import nestedfp as nf  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import params_to, to_serving  # noqa: E402
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


# K2 runs the TMA + mma.sync body of csrc/fp8_mma_gemm.cuh (shared with
# K7) when K % 16 == 0, N % 16 == 0 and upper and x_q are 16-byte
# aligned, in four tile configs picked by M (<= 16, <= 64, <= 256,
# beyond); other shapes run gemm_tile.cuh's body
K2_M = [1, 8, 16, 17, 64, 65, 256, 257, 1024, 8192]


def _k2(x, w, per_row=True):
    xq, s = quant.quantize_act_per_token(x)
    if not per_row:
        s = s.amax().reshape(1)
    return ops.matmul_nested_fp8(xq, nf.encode(w)[0], s), xq, s


@pytest.mark.parametrize("per_row", [True, False])
@pytest.mark.parametrize("kn", [(4096, 4096), (4096, 1024), (4096, 14336),
                                (14336, 4096)])
@pytest.mark.parametrize("m", K2_M)
def test_nestedfp8_matmul_llama_shapes(dev, m, kn, per_row):
    """Every llama3.1-8b GEMM shape in every tile config, with per-row
    and with one scalar scale, against the plain version (f64 sums)."""
    gen = torch.Generator(device=dev).manual_seed(14)
    k, n = kn
    x = torch.randn((m, k), generator=gen, device=dev)
    w = (torch.randn((k, n), generator=gen, device=dev) * k ** -0.5).half()
    n0 = ops.all_launch_counters()["nestedfp8_matmul"]
    got, xq, s = _k2(x, w, per_row)
    assert ops.all_launch_counters()["nestedfp8_matmul"] == n0 + 1
    torch.testing.assert_close(
        got, ref.nestedfp8_matmul_ref(xq, nf.encode(w)[0], s), **GEMM_TOL)


@pytest.mark.parametrize("case", ["37x999x1001", "5x4096x1000",
                                  "x_q 8 bytes off"])
def test_nestedfp8_matmul_fallback_body(dev, case):
    """Ragged K or N, and an x_q view whose base is not 16-byte aligned,
    take gemm_tile.cuh's body (no dynamic shared memory) and still match
    the plain version."""
    from repro_torch.kernels.nestedfp8_matmul import (
        dynamic_smem_bytes, nestedfp8_matmul)
    m, k, n = {"37x999x1001": (37, 999, 1001), "5x4096x1000": (5, 4096, 1000),
               "x_q 8 bytes off": (8, 4096, 1024)}[case]
    x, w = _gemm(dev, m, k, n, seed=15)
    xq, s = quant.quantize_act_per_token(x)
    if case == "x_q 8 bytes off":
        buf = torch.zeros(m * k + 16, dtype=torch.uint8, device=dev)
        buf[8:8 + m * k] = xq.view(torch.uint8).flatten()
        xq = buf[8:8 + m * k].view(m, k).view(torch.float8_e4m3fn)
    u = nf.encode(w)[0]
    assert dynamic_smem_bytes(xq, u) == 0
    n0 = ops.all_launch_counters()["nestedfp8_matmul"]
    got = nestedfp8_matmul(xq, u, s)
    assert ops.all_launch_counters()["nestedfp8_matmul"] == n0 + 1
    torch.testing.assert_close(got, ref.nestedfp8_matmul_ref(xq, u, s),
                               **GEMM_TOL)


def test_nestedfp8_body_rule(dev):
    """K % 16 == 0, N % 16 == 0 and 16-byte aligned upper and x_q take the
    mma body (dynamic shared memory by M's tile config, the same as K7's
    at that M); anything else gemm_tile.cuh's body (none)."""
    from repro_torch.kernels.nestedfp8_matmul import dynamic_smem_bytes
    from repro_torch.kernels.nestedfp8_matmul_fused_quant import (
        dynamic_smem_bytes as smem_k7)

    def smem(m, k, n, x_off=0, u_off=0):
        x = torch.zeros(m * k + 16, dtype=torch.uint8, device=dev)
        x = x[x_off:x_off + m * k].view(m, k).view(torch.float8_e4m3fn)
        u = torch.zeros(k * n + 16, dtype=torch.uint8, device=dev)
        return dynamic_smem_bytes(x, u[u_off:u_off + k * n].view(k, n))

    for m in (1, 16, 17, 64, 65, 256, 257, 8192):
        u = torch.zeros((4096, 1024), dtype=torch.uint8, device=dev)
        assert smem(m, 4096, 1024) == smem_k7(u, m) > 0
    # at M <= 16 an N above 4224 takes K2's own config (BN = 128)
    wide = torch.zeros((4096, 14336), dtype=torch.uint8, device=dev)
    assert smem(16, 4096, 14336) > smem_k7(wide, 16) > 0
    assert smem(17, 4096, 14336) == smem_k7(wide, 17)
    assert smem(8, 4096, 4096) == smem_k7(wide[:, :4096].contiguous(), 8)
    assert smem(37, 1040, 1008) > 0
    assert smem(37, 999, 1001) == 0              # ragged K and N
    assert smem(5, 4096, 1000) == 0              # N % 16 != 0
    assert smem(8, 4104, 1024) == 0              # K % 16 != 0
    assert smem(8, 4096, 1024, x_off=8) == 0     # x_q 8 bytes off
    assert smem(8, 4096, 1024, u_off=8) == 0     # upper 8 bytes off


def _quant_rows(dev, m, k, dtype, seed):
    """m rows of random magnitudes with the edge rows: all zero, +amax
    and -amax reached exactly, signed zeros."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device=dev) * torch.exp(
        torch.empty((m, 1), device=dev).uniform_(-6, 6, generator=gen))
    if m >= 4:
        x[1] = 0.0
        x[2, k // 3] = x[2].abs().max() * 2
        x[3, k - 1] = -x[3].abs().max() * 2
        x[0, :2] = torch.tensor([-0.0, 0.0], device=dev)
    return x.to(dtype)


@pytest.mark.parametrize("mk", [(1, 4096), (8, 4096), (37, 14336),
                                (8, 1000), (5, 100), (256, 4096),
                                (4, 16392), (4, 20001)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_quant_per_token_bitwise(dev, dtype, mk):
    """The kernel's codes and scales are bitwise those of
    quant.quantize_act_per_token on the card and on the CPU, for every
    input type, the edge rows included; K = 1000, 100 and 20001 take the
    one-element loads, K = 16392 and 20001 the two-pass variant for rows
    longer than the registers hold."""
    x = _quant_rows(dev, *mk, dtype, seed=16)
    n0 = ops.all_launch_counters()["quant_per_token"]
    q, s = ops.quantize_act_per_token(x)
    assert ops.all_launch_counters()["quant_per_token"] == n0 + 1
    assert q.dtype == torch.float8_e4m3fn and s.shape == (mk[0], 1)
    for wq, ws in (quant.quantize_act_per_token(x),
                   quant.quantize_act_per_token(x.cpu())):
        assert torch.equal(s.cpu(), ws.cpu())
        assert torch.equal(q.view(torch.uint8).cpu(),
                           wq.view(torch.uint8).cpu())
    if mk[0] >= 4:
        eps_scale = torch.tensor(1e-12) / torch.tensor(448.0)
        assert s[1].item() == eps_scale.item()
        assert not q[1].view(torch.uint8).any()
        assert q[2].float().abs().max().item() == 448.0
        assert q[3, -1].float().item() == -448.0


def test_per_token_scale_divides_on_the_card(dev):
    """quant.quantize_act_per_token's scale on the card is the IEEE
    quotient amax / 448, bitwise the CPU's, over 20000 amax values."""
    gen = torch.Generator(device=dev).manual_seed(17)
    amax = torch.empty(20000, device=dev).uniform_(1, 2, generator=gen) * (
        2.0 ** torch.randint(-30, 30, (20000,), device=dev, generator=gen))
    x = torch.zeros((20000, 3), device=dev)
    x[:, 1] = -amax
    _, s = quant.quantize_act_per_token(x)
    _, s_cpu = quant.quantize_act_per_token(x.cpu())
    assert torch.equal(s.cpu(), s_cpu)
    _, s_kernel = ops.quantize_act_per_token(x)
    assert torch.equal(s_kernel, s)


@pytest.mark.parametrize("shape", SHAPES)
def test_f16_matmul(dev, shape):
    x, w = _gemm(dev, *shape, seed=2)
    got = ops.matmul_f16(x.half(), w)
    torch.testing.assert_close(got, ref.matmul_f16_ref(x.half(), w),
                               **GEMM_TOL)


# K1 and K3 run the TMA + wgmma body (csrc/wgmma_gemm.cuh) when N % 16 ==
# 0, K % 8 == 0 and the operands are 16-byte aligned, in five tile configs
# picked by M (<= 8, <= 32, <= 64, <= 512, beyond); other shapes run
# gemm_tile.cuh's body
WG_KN = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]


def _k1(x, w):
    return ops.matmul_nested_f16(x, *nf.encode(w))


def _k3(x, w):
    return ops.matmul_f16(x, w)


@pytest.mark.parametrize("kn", WG_KN)
@pytest.mark.parametrize("m", [1, 8, 37, 65, 256, 8192])
@pytest.mark.parametrize("kernel", ["k1", "k3"])
def test_wgmma_gemm_llama_shapes(dev, kernel, m, kn):
    """Every llama3.1-8b GEMM shape in every tile config, up to the
    8192-row prefill, against the plain version (f64 sums)."""
    x, w = _gemm(dev, m, *kn, seed=12)
    x = x.half()
    name = {"k1": "nestedfp16_matmul", "k3": "f16_matmul"}[kernel]
    n0 = ops.all_launch_counters()[name]
    got = {"k1": _k1, "k3": _k3}[kernel](x, w)
    torch.testing.assert_close(got, ref.matmul_f16_ref(x, w), **GEMM_TOL)
    assert ops.all_launch_counters()[name] == n0 + 1


@pytest.mark.parametrize("kernel", ["k1", "k3"])
def test_wgmma_sums_hold_f32_accuracy(dev, kernel):
    """At K = 14336 the f16 wgmma sums stay within 1e-4 of the exact sum
    (in f64) of the same products: sums that kept fewer bits than f32
    would miss it."""
    x, w = _gemm(dev, 16, 14336, 4096, seed=11)
    x = x.half()
    exact = x.double() @ w.double()
    got = {"k1": _k1, "k3": _k3}[kernel](x, w)
    assert (got.double() - exact).abs().max().item() <= 1e-4


@pytest.mark.parametrize("m", [8, 16, 64, 65, 256, 257, 2048])
@pytest.mark.parametrize("kernel", ["k1", "k3", "k2"])
def test_gemm_rows_do_not_depend_on_the_batch(dev, kernel, m):
    """Row 17 (the last row when m is smaller) computed alone equals the
    same row inside a batch of m rows bitwise, across every tile config:
    one k order, no split-K, whatever the wgmma N; K2 with per-row scales
    (m = 16, 64, 256 and 2048 are the last M of its four configs)."""
    x, w = _gemm(dev, 2048, 4096, 1024, seed=13)
    x = x.half()
    fn = {"k1": _k1, "k3": _k3, "k2": lambda x, w: _k2(x, w)[0]}[kernel]
    r = min(17, m - 1)
    assert torch.equal(fn(x[:m], w)[r:r + 1], fn(x[r:r + 1], w))


@pytest.mark.parametrize("m", [16, 17, 64, 257])
def test_k2_rows_do_not_depend_on_the_batch_at_wide_n(dev, m):
    """At N = 14336 K2 runs its wide decode config for M <= 16 and K7's
    configs beyond; row 17 (row 15 at m = 16) alone equals the same row
    inside the batch bitwise."""
    x, w = _gemm(dev, 257, 4096, 14336, seed=18)
    r = min(17, m - 1)
    assert torch.equal(_k2(x[:m], w)[0][r:r + 1], _k2(x[r:r + 1], w)[0])


def test_wgmma_body_rule(dev):
    """N % 16 == 0, K % 8 == 0 and 16-byte aligned x and weights take the
    wgmma body (dynamic shared memory by M's tile config); anything else
    gemm_tile.cuh's body (none)."""
    from repro_torch.kernels.f16_matmul import dynamic_smem_bytes as smem3
    from repro_torch.kernels.nestedfp16_matmul import (
        dynamic_smem_bytes as smem1)

    def both(m, k, n, x_off=0, w_off=0):
        x = torch.zeros(m * k + 8, dtype=torch.float16, device=dev)
        x = x[x_off:x_off + m * k].view(m, k)
        w = torch.zeros(k * n + 16, dtype=torch.float16, device=dev)
        w = w[w_off:w_off + k * n].view(k, n)
        u = torch.zeros(k * n + 16, dtype=torch.uint8, device=dev)
        u = u[2 * w_off:2 * w_off + k * n].view(k, n)
        return smem1(x, u, u), smem3(x, w)

    for m in (1, 8, 37, 256, 8192):
        assert all(b > 0 for b in both(m, 4096, 4096))
    assert all(b > 0 for b in both(37, 1040, 1008))
    assert both(37, 999, 1001) == (0, 0)         # ragged K and N
    assert both(5, 4096, 1000) == (0, 0)         # N % 16 != 0
    assert both(8, 4100, 1024) == (0, 0)         # K % 8 != 0
    assert both(8, 4096, 1024, x_off=4) == (0, 0)     # x 8 bytes off
    assert both(8, 4096, 1024, w_off=4) == (0, 0)     # weights 8 bytes off


def _paged_case(dev, seed, lens, bs, mb, h=8, hkv=2, d=64):
    """A paged pool with shuffled blocks, the first two blocks of row 0
    shared with the last row (COW prefix), holes past each length pointing
    at the trash block 0."""
    rng = np.random.default_rng(seed)
    b = len(lens)
    nb = 1 + b * mb
    tables = rng.permutation(np.arange(1, nb)).astype(np.int32).reshape(b, mb)
    tables[-1, :2] = tables[0, :2]
    lens = np.asarray(lens, np.int32)
    for r in range(b):
        tables[r, -(-int(lens[r]) // bs):] = 0
    q = torch.from_numpy(rng.normal(size=(b, h, d)).astype(np.float32)).to(dev)
    kv = torch.from_numpy(rng.normal(size=(2, nb, bs, hkv, d))
                          .astype(np.float16)).to(dev)
    planes = dict(zip(("k_hi", "k_lo"), nf.split_bytes(kv[0])))
    planes.update(zip(("v_hi", "v_lo"), nf.split_bytes(kv[1])))
    return q, planes, torch.from_numpy(tables).to(dev), \
        torch.from_numpy(lens).to(dev)


# (bs, mb, lens): one split a row (the kernel writes `out` itself), then
# rows of several splits of 512 keys with lens on the split edges, then a
# block size that does not divide 512 (splits of 504 keys)
PAGED_CASES = [(16, 4, [50, 0, 37]),
               (16, 40, [0, 1, 511, 512, 513, 640]),
               (24, 22, [0, 503, 504, 505, 528])]


@pytest.mark.parametrize("fp8", [False, True])
@pytest.mark.parametrize("window", [None, 0, 5, 128, 300])
@pytest.mark.parametrize("bs,mb,lens", PAGED_CASES)
def test_paged_planar_decode_attention(dev, fp8, window, bs, mb, lens):
    """Windows 128 and 300 put the first kept key of the 640-key row on a
    split edge (512) and mid-split (340)."""
    q, planes, tab, ln = _paged_case(dev, 4, lens, bs, mb)
    n0 = ops.all_launch_counters()["paged_planar_decode_attention"]
    got = ops.paged_decode_attention(q, planes, tab, ln, fp8=fp8,
                                     window=window)
    assert ops.all_launch_counters()["paged_planar_decode_attention"] == n0 + 1
    want = ref.paged_planar_decode_attention_ref(
        q, planes["k_hi"], planes["k_lo"], planes["v_hi"], planes["v_lo"],
        tab, ln, fp8=fp8, window=window)
    live = ln > 0
    assert torch.isfinite(got).all()
    assert torch.equal(got[~live], torch.zeros_like(got[~live]))
    torch.testing.assert_close(got[live], want[live], **ATTN_TOL)


def _dense_planes(dev, b, cap, hkv, d, seed):
    rng = np.random.default_rng(seed)
    kv = torch.from_numpy(rng.normal(size=(2, b, cap, hkv, d))
                          .astype(np.float16)).to(dev)
    planes = dict(zip(("k_hi", "k_lo"), nf.split_bytes(kv[0])))
    planes.update(zip(("v_hi", "v_lo"), nf.split_bytes(kv[1])))
    return planes


# (cap, lens): one split (cap <= 512), then splits of 512 with lens on the
# edges; windows 273 and 300 put the first kept key of len 785 on the
# split edge 512 and of len 600 at 327, mid-split and mid-step
DENSE_CASES = [(200, [1, 64, 65, 200]), (3000, [2999, 1, 1500, 3000]),
               (1024, [1, 511, 512, 513]), (800, [785, 600, 512, 16])]


@pytest.mark.parametrize("fp8", [False, True])
@pytest.mark.parametrize("window", [None, 7, 273, 300])
@pytest.mark.parametrize("cap,lens", DENSE_CASES)
def test_planar_decode_attention(dev, fp8, window, cap, lens):
    b, h, hkv, d = 4, 8, 2, 128
    planes = _dense_planes(dev, b, cap, hkv, d, seed=5)
    q = torch.randn((b, h, d), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(5))
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    n0 = ops.all_launch_counters()["planar_decode_attention"]
    got = ops.planar_decode_attention(q, planes, ln, fp8=fp8, window=window)
    want = ref.planar_decode_attention_ref(
        q, planes["k_hi"], planes["k_lo"], planes["v_hi"], planes["v_lo"],
        ln, fp8=fp8, window=window)
    torch.testing.assert_close(got, want, **ATTN_TOL)
    assert ops.all_launch_counters()["planar_decode_attention"] == n0 + 1


@pytest.mark.parametrize("fp8", [False, True])
@pytest.mark.parametrize("window", [None, 4096])
def test_planar_decode_attention_row_of_32768_keys(dev, fp8, window):
    """llama3.1-8b's heads, the decode_32k length: 64 splits of a row,
    beside a short row."""
    b, h, hkv, d, cap = 2, 32, 8, 128, 32768
    planes = _dense_planes(dev, b, cap, hkv, d, seed=6)
    q = torch.randn((b, h, d), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(6))
    ln = torch.tensor([cap, 17], dtype=torch.int32, device=dev)
    got = ops.planar_decode_attention(q, planes, ln, fp8=fp8, window=window)
    want = ref.planar_decode_attention_ref(
        q, planes["k_hi"], planes["k_lo"], planes["v_hi"], planes["v_lo"],
        ln, fp8=fp8, window=window)
    torch.testing.assert_close(got, want, **ATTN_TOL)


@pytest.mark.parametrize("fp8", [False, True])
@pytest.mark.parametrize("kernel", ["k4", "k5"])
def test_decode_rows_do_not_depend_on_the_batch(dev, kernel, fp8):
    """Splits sit on a fixed grid of keys: a row's output is bitwise the
    same alone, in a batch of 8 beside rows of other lengths, and at
    another place in the batch."""
    lens = [700, 1, 256, 1024, 333, 17, 999, 512]
    d, bs = 128, 16
    if kernel == "k5":
        planes = _dense_planes(dev, 8, 1024, 2, d, seed=7)
        q = torch.randn((8, 8, d), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(7))
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)

        def run(rows):
            return ops.planar_decode_attention(
                q[rows].contiguous(),
                {k: v[rows].contiguous() for k, v in planes.items()},
                ln[rows].contiguous(), fp8=fp8)
    else:
        q, planes, tab, ln = _paged_case(dev, 7, lens, bs, 64, d=d)

        def run(rows):
            return ops.paged_decode_attention(
                q[rows].contiguous(), planes, tab[rows].contiguous(),
                ln[rows].contiguous(), fp8=fp8)
    batch = run(list(range(8)))
    moved = run([3, 1, 2, 0, 4, 5, 6, 7])
    for r in range(8):
        assert torch.equal(batch[r:r + 1], run([r])), r
    assert torch.equal(moved[0], batch[3]) and torch.equal(moved[3], batch[0])


@pytest.mark.parametrize("fp8", [False, True])
@pytest.mark.parametrize("window", [None, 300])
def test_dense_equals_paged_over_an_identity_table(dev, fp8, window):
    """K5 over dense planes and K4 over the same bytes as a pool with an
    identity table (row b is blocks b*MB .. b*MB + MB - 1)."""
    b, h, hkv, d, cap, bs = 4, 8, 2, 128, 800, 16
    planes = _dense_planes(dev, b, cap, hkv, d, seed=8)
    q = torch.randn((b, h, d), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(8))
    ln = torch.tensor([785, 600, 512, 16], dtype=torch.int32, device=dev)
    dense = ops.planar_decode_attention(q, planes, ln, fp8=fp8, window=window)
    pool = {k: v.reshape(-1, bs, hkv, d) for k, v in planes.items()}
    mb = cap // bs
    tables = torch.arange(b * mb, dtype=torch.int32, device=dev).reshape(b, mb)
    paged = ops.paged_decode_attention(q, pool, tables, ln, fp8=fp8,
                                       window=window)
    torch.testing.assert_close(dense, paged, rtol=1e-5, atol=1e-6)


def test_decode_split_grid_and_head_dims(dev):
    """The C entries' split of a row (512 keys; K4 rounds down to whole
    table blocks) and the head dims they take; the wrapper refuses other
    D before any launch."""
    from repro_torch.kernels import planar_decode_attention as pda
    assert [pda.dense_splits(c) for c in (1, 512, 513, 32768)] == [1, 1, 2, 64]
    assert [pda.paged_splits(bs, mb) for bs, mb in
            ((16, 32), (16, 33), (24, 22), (1024, 3))] == [1, 2, 2, 3]
    for paged in (False, True):
        for fp8 in (False, True):
            for d in (64, 96, 128):
                assert pda.dynamic_smem_bytes(d, fp8=fp8, paged=paged) > 0
            assert (pda.dynamic_smem_bytes(80, fp8=fp8, paged=paged) > 0) \
                == (not paged)             # K5 only: zamba2's shared caches
            assert pda.dynamic_smem_bytes(72, fp8=fp8, paged=paged) == 0
    planes = _dense_planes(dev, 1, 32, 1, 72, seed=9)
    with pytest.raises(ValueError, match="D=72"):
        ops.planar_decode_attention(torch.zeros((1, 1, 72), device=dev),
                                    planes, torch.ones(1, dtype=torch.int32,
                                                       device=dev), fp8=False)
    q, pool, tab, ln = _paged_case(dev, 9, [5], 16, 1, h=1, hkv=1, d=80)
    n0 = ops.all_launch_counters()["paged_planar_decode_attention"]
    with pytest.raises(ValueError, match="D=80"):
        ops.paged_decode_attention(q, pool, tab, ln, fp8=False)
    assert ops.all_launch_counters()["paged_planar_decode_attention"] == n0


# -- K4 and K5 at gemma3-1b's heads: 4 q heads, 1 kv head, D = 256 ----------

GEMMA_PAGED_LENS = [0, 1, 19, 20, 511, 512, 513, 1088]
GEMMA_DENSE_LENS = [1, 19, 20, 512, 513, 1100]


@pytest.mark.parametrize("fp8", [False, True])
@pytest.mark.parametrize("window", [None, 19, 512])
def test_paged_decode_attention_head_dim_256(dev, fp8, window):
    """Lens on block edges (16) and split edges (512), up to the gemma
    serve capacity of 1088; windows 19 (reduced gemma3) and 512."""
    q, planes, tab, ln = _paged_case(dev, 21, GEMMA_PAGED_LENS, 16, 68, h=4,
                                     hkv=1, d=256)
    n0 = ops.all_launch_counters()["paged_planar_decode_attention"]
    got = ops.paged_decode_attention(q, planes, tab, ln, fp8=fp8,
                                     window=window)
    assert ops.all_launch_counters()["paged_planar_decode_attention"] == n0 + 1
    want = ref.paged_planar_decode_attention_ref(
        q, planes["k_hi"], planes["k_lo"], planes["v_hi"], planes["v_lo"],
        tab, ln, fp8=fp8, window=window)
    live = ln > 0
    assert torch.isfinite(got).all()
    assert torch.equal(got[~live], torch.zeros_like(got[~live]))
    torch.testing.assert_close(got[live], want[live], **ATTN_TOL)


@pytest.mark.parametrize("fp8", [False, True])
@pytest.mark.parametrize("window", [None, 19, 512])
def test_planar_decode_attention_head_dim_256(dev, fp8, window):
    b, h, hkv, d, cap = len(GEMMA_DENSE_LENS), 4, 1, 256, 1100
    planes = _dense_planes(dev, b, cap, hkv, d, seed=22)
    q = torch.randn((b, h, d), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(22))
    ln = torch.tensor(GEMMA_DENSE_LENS, dtype=torch.int32, device=dev)
    n0 = ops.all_launch_counters()["planar_decode_attention"]
    got = ops.planar_decode_attention(q, planes, ln, fp8=fp8, window=window)
    assert ops.all_launch_counters()["planar_decode_attention"] == n0 + 1
    want = ref.planar_decode_attention_ref(
        q, planes["k_hi"], planes["k_lo"], planes["v_hi"], planes["v_lo"],
        ln, fp8=fp8, window=window)
    torch.testing.assert_close(got, want, **ATTN_TOL)


@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.parametrize("fp8", [False, True])
def test_k4_never_reads_slid_out_blocks(dev, fp8, d):
    """A local layer's table points the blocks that slid out of the window
    at the trash block: with the trash block full of NaN bytes, K4 gives
    what the plain version gives with it zeroed."""
    lens, bs, w = [600, 1088, 45], 16, 512 if d == 256 else 19
    q, planes, tab, ln = _paged_case(dev, 23, lens, bs, 68, h=4, hkv=1, d=d)
    for r, n in enumerate(lens):
        tab[r, :max(0, (n - w) // bs)] = 0     # wholly before the window
    for p in planes.values():
        p[0] = 0
    want = ref.paged_planar_decode_attention_ref(
        q, planes["k_hi"], planes["k_lo"], planes["v_hi"], planes["v_lo"],
        tab, ln, fp8=fp8, window=w)
    for p in planes.values():
        p[0] = 0xFF                              # NaN as f16 and e5m2
    got = ops.paged_decode_attention(q, planes, tab, ln, fp8=fp8, window=w)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **ATTN_TOL)


@pytest.mark.parametrize("fp8", [False, True])
@pytest.mark.parametrize("kernel", ["k4", "k5"])
def test_decode_rows_do_not_depend_on_the_batch_at_head_dim_256(dev, kernel,
                                                                fp8):
    """As at D = 64 and 128: a row's output is bitwise the same alone, in
    a batch of 8 and at another place in the batch."""
    lens = [700, 1, 256, 1024, 333, 17, 999, 512]
    d = 256
    gen = torch.Generator(device=dev).manual_seed(24)
    if kernel == "k5":
        planes = _dense_planes(dev, 8, 1024, 1, d, seed=24)
        q = torch.randn((8, 4, d), device=dev, generator=gen)
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)

        def run(rows):
            return ops.planar_decode_attention(
                q[rows].contiguous(),
                {k: v[rows].contiguous() for k, v in planes.items()},
                ln[rows].contiguous(), fp8=fp8, window=512)
    else:
        q, planes, tab, ln = _paged_case(dev, 24, lens, 16, 64, h=4, hkv=1,
                                         d=d)

        def run(rows):
            return ops.paged_decode_attention(
                q[rows].contiguous(), planes, tab[rows].contiguous(),
                ln[rows].contiguous(), fp8=fp8, window=512)
    batch = run(list(range(8)))
    moved = run([3, 1, 2, 0, 4, 5, 6, 7])
    for r in range(8):
        assert torch.equal(batch[r:r + 1], run([r])), r
    assert torch.equal(moved[0], batch[3]) and torch.equal(moved[3], batch[0])


# -- K4 at D = 96 (phi-3-vision), K5 and K6 at D = 80 (zamba2-2.7b's
# shared attention) and 96: MHA (G = 1) and G = 4 -----------------------

NEW_DIM_PAGED = [(16, 4, [50, 0, 37]), (16, 40, [0, 1, 511, 512, 513, 640]),
                 (16, 68, [1, 1024, 1088, 17])]


@pytest.mark.parametrize("fp8", [False, True])
@pytest.mark.parametrize("window", [None, 300])
@pytest.mark.parametrize("h,hkv", [(32, 32), (8, 2)])
@pytest.mark.parametrize("bs,mb,lens", NEW_DIM_PAGED)
def test_paged_decode_attention_head_dim_96(dev, fp8, window, h, hkv, bs, mb,
                                            lens):
    """K4's D = 96 instance: 96-byte plane rows, padded to 96 + 16 in the
    ring; one split a row and several (lens on the 512 edges)."""
    q, planes, tab, ln = _paged_case(dev, 31, lens, bs, mb, h=h, hkv=hkv,
                                     d=96)
    n0 = ops.all_launch_counters()["paged_planar_decode_attention"]
    got = ops.paged_decode_attention(q, planes, tab, ln, fp8=fp8,
                                     window=window)
    assert ops.all_launch_counters()["paged_planar_decode_attention"] == n0 + 1
    want = ref.paged_planar_decode_attention_ref(
        q, planes["k_hi"], planes["k_lo"], planes["v_hi"], planes["v_lo"],
        tab, ln, fp8=fp8, window=window)
    live = ln > 0
    assert torch.isfinite(got).all()
    assert torch.equal(got[~live], torch.zeros_like(got[~live]))
    torch.testing.assert_close(got[live], want[live], **ATTN_TOL)


NEW_DIM_DENSE = [(200, [1, 64, 65, 200]), (1056, [1056, 1040, 17, 1]),
                 (3000, [2999, 1, 1500, 3000])]


@pytest.mark.parametrize("fp8", [False, True])
@pytest.mark.parametrize("window", [None, 273])
@pytest.mark.parametrize("h,hkv", [(32, 32), (8, 2)])
@pytest.mark.parametrize("d", [80, 96])
@pytest.mark.parametrize("cap,lens", NEW_DIM_DENSE)
def test_planar_decode_attention_head_dims_80_and_96(dev, fp8, window, h, hkv,
                                                     d, cap, lens):
    """K5's D = 80 instance (80-byte rows padded to 96 in shared memory,
    the 16 pad bytes zero) and D = 96, ragged lens."""
    b = len(lens)
    planes = _dense_planes(dev, b, cap, hkv, d, seed=32)
    q = torch.randn((b, h, d), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(32))
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    n0 = ops.all_launch_counters()["planar_decode_attention"]
    got = ops.planar_decode_attention(q, planes, ln, fp8=fp8, window=window)
    assert ops.all_launch_counters()["planar_decode_attention"] == n0 + 1
    want = ref.planar_decode_attention_ref(
        q, planes["k_hi"], planes["k_lo"], planes["v_hi"], planes["v_lo"],
        ln, fp8=fp8, window=window)
    torch.testing.assert_close(got, want, **ATTN_TOL)


@pytest.mark.parametrize("fp8", [False, True])
def test_planar_decode_attention_head_dim_80_at_32768(dev, fp8):
    """zamba2-2.7b's dense-slot decode at 32k: 32 heads of 80, 64 splits."""
    b, h, d, cap = 2, 32, 80, 32768
    planes = _dense_planes(dev, b, cap, h, d, seed=33)
    q = torch.randn((b, h, d), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(33))
    ln = torch.tensor([32768, 20001], dtype=torch.int32, device=dev)
    got = ops.planar_decode_attention(q, planes, ln, fp8=fp8)
    want = ref.planar_decode_attention_ref(
        q, planes["k_hi"], planes["k_lo"], planes["v_hi"], planes["v_lo"],
        ln, fp8=fp8)
    torch.testing.assert_close(got, want, **ATTN_TOL)


@pytest.mark.parametrize("fp8", [False, True])
@pytest.mark.parametrize("d", [80, 96])
def test_decode_rows_do_not_depend_on_the_batch_at_head_dims_80_and_96(
        dev, d, fp8):
    planes = _dense_planes(dev, 8, 700, 4, d, seed=34)
    q = torch.randn((8, 4, d), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(34))
    ln = torch.tensor([700, 1, 512, 513, 77, 600, 3, 699], dtype=torch.int32,
                      device=dev)
    batch = ops.planar_decode_attention(q, planes, ln, fp8=fp8)
    for r in range(8):
        one = {n: p[r:r + 1].contiguous() for n, p in planes.items()}
        assert torch.equal(batch[r:r + 1], ops.planar_decode_attention(
            q[r:r + 1].contiguous(), one, ln[r:r + 1], fp8=fp8)), r


def test_decode_head_dim_256_instances(dev):
    """Both C entries have D = 256 instances (the FP16 ring of 4 warps x
    2 stages x 4 planes x 16 keys x 272 B, plus 8 KB of q fragments)."""
    from repro_torch.kernels import planar_decode_attention as pda
    for paged in (False, True):
        assert pda.dynamic_smem_bytes(256, fp8=False, paged=paged) == \
            4 * 2 * 4 * 16 * 272 + 16 * 32 * 16
        assert pda.dynamic_smem_bytes(256, fp8=True, paged=paged) == \
            4 * 2 * 2 * 16 * 272 + 16 * 32 * 16


# (dtype, b, s, h, hkv, d): f32 runs the SIMT body, f16 and bf16 the
# tensor-core body; the second group sits on the 64-key and 64-row tile
# edges for every G = H / Hkv, the third llama3.1-8b's prefill; then
# D = 256 (gemma3-1b's global layers; the tensor-core body takes 32-key
# tiles there) on the same edges, at gemma3-1b's prefill and in f32
PREFILL_CASES = (
    [(dt, *shape) for shape in [(2, 128, 8, 2, 128), (1, 1000, 32, 8, 128),
                                (3, 45, 4, 4, 64)]
     for dt in (torch.float32, torch.float16, torch.bfloat16)]
    + [(dt, 2, s, 2 * g, 2, d) for dt in (torch.float16, torch.bfloat16)
       for s in (1, 63, 64, 65) for g in (1, 2, 4, 8) for d in (64, 128)]
    + [(torch.bfloat16, 8, 1024, 32, 8, 128)]
    + [(dt, 2, s, 2 * g, 2, 256) for dt in (torch.float16, torch.bfloat16)
       for s in (1, 63, 64, 65) for g in (1, 2, 4)]
    + [(torch.bfloat16, 8, 1024, 4, 1, 256), (torch.float32, 2, 65, 4, 1, 256)]
    # D = 80 (zamba2-2.7b's shared attention) and 96 (phi-3-vision): rows
    # of 176 / 208 bytes in shared memory, on the tile edges, G = 1 and 4,
    # then each model's dense prefill, and f32 (V padded to 128 columns)
    + [(dt, 2, s, 2 * g, 2, d) for dt in (torch.float16, torch.bfloat16)
       for s in (1, 63, 64, 65) for g in (1, 4) for d in (80, 96)]
    + [(torch.float32, 2, s, 8, 2, d) for s in (9, 65) for d in (80, 96)]
    + [(torch.bfloat16, 8, 1024, 32, 32, 80),
       (torch.bfloat16, 8, 1600, 32, 32, 96)])


@pytest.mark.parametrize("dtype,b,s,h,hkv,d", PREFILL_CASES)
def test_flash_prefill_attention(dev, dtype, b, s, h, hkv, d):
    gen = torch.Generator(device=dev).manual_seed(6)
    q = torch.randn((b, s, h, d), device=dev, generator=gen).to(dtype)
    k = torch.randn((b, s, hkv, d), device=dev, generator=gen).to(dtype)
    v = torch.randn((b, s, hkv, d), device=dev, generator=gen).to(dtype)
    n0 = ops.all_launch_counters()["flash_prefill_attention"]
    got = ops.flash_prefill_attention(q, k, v)
    torch.testing.assert_close(got, ref.flash_prefill_attention_ref(q, k, v),
                               **ATTN_TOL)
    assert ops.all_launch_counters()["flash_prefill_attention"] == n0 + 1


# G = H / Hkv that does not divide the 64 rows of a block: deepseek-coder-
# 33b's G = 7 (BQ = 9 positions, one dead row) on the 9-position and
# 64-key tile edges, G = 3, 5 and 33, both bodies
PREFILL_ODD_G_CASES = (
    [(dt, 2, s, 7 * hkv, hkv, 128) for dt in (torch.float16, torch.bfloat16)
     for s in (1, 8, 9, 10, 63, 64, 65, 200) for hkv in (1, 2)]
    + [(dt, 2, 70, g, 1, d) for dt in (torch.float16, torch.bfloat16)
       for g in (3, 5, 33) for d in (64, 256)]
    + [(torch.float32, 2, s, 14, 2, d) for s in (9, 65)
       for d in (64, 128, 256)]
    + [(torch.bfloat16, 8, 1024, 56, 8, 128)])


@pytest.mark.parametrize("dtype,b,s,h,hkv,d", PREFILL_ODD_G_CASES)
def test_flash_prefill_attention_groups_not_dividing_64(dev, dtype, b, s, h,
                                                        hkv, d):
    """Dead rows load as zero and are never stored: every output row equals
    the plain version's, including each kv head's last query head."""
    gen = torch.Generator(device=dev).manual_seed(8)
    q = torch.randn((b, s, h, d), device=dev, generator=gen).to(dtype)
    k = torch.randn((b, s, hkv, d), device=dev, generator=gen).to(dtype)
    v = torch.randn((b, s, hkv, d), device=dev, generator=gen).to(dtype)
    got = ops.flash_prefill_attention(q, k, v)
    torch.testing.assert_close(got, ref.flash_prefill_attention_ref(q, k, v),
                               **ATTN_TOL)


@pytest.mark.parametrize("d", [72, 112, 512])
def test_flash_prefill_raises_for_other_head_dims(dev, d):
    """A head dim without an instance raises before any launch; the plain
    version never runs in its place."""
    q, k, v = (torch.zeros(shape, device=dev, dtype=torch.bfloat16)
               for shape in ((1, 8, 4, d), (1, 8, 1, d), (1, 8, 1, d)))
    n0 = ops.all_launch_counters()["flash_prefill_attention"]
    with pytest.raises(ValueError, match="need D in"):
        ops.flash_prefill_attention(q, k, v)
    assert ops.all_launch_counters()["flash_prefill_attention"] == n0


def test_flash_prefill_both_bodies_count_as_launches(dev):
    """The f32 (SIMT) and the bf16 (tensor-core) body are one kernel to
    the launch counter: one call of each adds two."""
    gen = torch.Generator(device=dev).manual_seed(7)
    q, k, v = (torch.randn(shape, device=dev, generator=gen)
               for shape in ((1, 70, 8, 64), (1, 70, 2, 64), (1, 70, 2, 64)))
    n0 = ops.all_launch_counters()["flash_prefill_attention"]
    f32 = ops.flash_prefill_attention(q, k, v)
    bf16 = ops.flash_prefill_attention(q.bfloat16(), k.bfloat16(),
                                       v.bfloat16())
    assert ops.all_launch_counters()["flash_prefill_attention"] == n0 + 2
    torch.testing.assert_close(bf16, ref.flash_prefill_attention_ref(
        q.bfloat16(), k.bfloat16(), v.bfloat16()), **ATTN_TOL)
    torch.testing.assert_close(f32, ref.flash_prefill_attention_ref(q, k, v),
                               **ATTN_TOL)


# K7's mma body masks ragged M, N and K itself when K and N are
# multiples of 16 (37 x 1040 x 1008, 100 x 48 x 80); other shapes take the
# in-register body (the shape rule in csrc/nestedfp8_matmul_fused_quant.cu)
FUSED_SHAPES = SHAPES + [(37, 1040, 1008), (100, 48, 80), (3, 4096, 1040)]
LLAMA_KN = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]


@pytest.mark.parametrize("shape", FUSED_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_nestedfp8_matmul_fused_quant(dev, shape, dtype):
    x, w = _gemm(dev, *shape, seed=7)
    x = x.to(dtype)
    u, _ = nf.encode(w)
    amax = quant.absmax(x)
    n0 = ops.all_launch_counters()["nestedfp8_matmul_fused_quant"]
    got = ops.matmul_nested_fp8_fused_quant(x, u, amax)
    want = ref.nestedfp8_matmul_fused_quant_ref(x, u, amax)
    torch.testing.assert_close(got, want, **GEMM_TOL)
    assert ops.all_launch_counters()["nestedfp8_matmul_fused_quant"] == n0 + 1


@pytest.mark.parametrize("kn", LLAMA_KN)
@pytest.mark.parametrize("m", [1, 8, 64, 65, 256])
def test_fused_quant_llama_shapes(dev, m, kn):
    """Every llama3.1-8b GEMM shape at decode and mid M, bf16 x as the
    serving runtime gives it; K = 14336 is where FP8 accumulation would
    drift if the tensor-core sums kept fewer bits than f32."""
    x, w = _gemm(dev, m, *kn, seed=9)
    x = x.bfloat16()
    u, _ = nf.encode(w)
    amax = quant.absmax(x)
    n0 = ops.all_launch_counters()["nestedfp8_matmul_fused_quant"]
    got = ops.matmul_nested_fp8_fused_quant(x, u, amax)
    torch.testing.assert_close(
        got, ref.nestedfp8_matmul_fused_quant_ref(x, u, amax), **GEMM_TOL)
    assert ops.all_launch_counters()["nestedfp8_matmul_fused_quant"] == n0 + 1


# gemma3-1b's seven GEMMs of a layer (K, N): q k v o gate up down; the
# dense-slot FP8 path runs K7 on them
GEMMA_KN = [(1152, 1024), (1152, 256), (1152, 256), (1024, 1152),
            (1152, 6912), (1152, 6912), (6912, 1152)]


@pytest.mark.parametrize("kn", sorted(set(GEMMA_KN)))
@pytest.mark.parametrize("m", [8, 2048])
def test_fused_quant_gemma_shapes(dev, m, kn):
    x, w = _gemm(dev, m, *kn, seed=13)
    x = x.bfloat16()
    u, _ = nf.encode(w)
    amax = quant.absmax(x)
    got = ops.matmul_nested_fp8_fused_quant(x, u, amax)
    torch.testing.assert_close(
        got, ref.nestedfp8_matmul_fused_quant_ref(x, u, amax), **GEMM_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_quant_sums_hold_f32_accuracy(dev, dtype):
    """At K = 14336 K7 stays within 1e-4 of the exact sum (in f64) of the
    same e4m3 products, as an f32 sum does: FP8 tensor-core sums that
    keep about 14 bits miss it by ~1e-3 here, enough to move the next
    layer's per-tensor amax."""
    x, w = _gemm(dev, 16, 14336, 4096, seed=11)
    x = x.to(dtype)
    u, _ = nf.encode(w)
    amax = quant.absmax(x)
    vals = [nf.fp8_view(c).double()
            for c in (ref.fused_quant_codes(x, amax), u)]
    exact = (vals[0] @ vals[1]) * (amax.double() / 448.0 * 2.0 ** -8)
    got = ops.matmul_nested_fp8_fused_quant(x, u, amax)
    assert (got.double() - exact).abs().max().item() <= 1e-4


def test_fused_quant_prefill_shape(dev):
    x, w = _gemm(dev, 8192, 14336, 4096, seed=10)
    x = x.bfloat16()
    u, _ = nf.encode(w)
    amax = quant.absmax(x)
    got = ops.matmul_nested_fp8_fused_quant(x, u, amax)
    torch.testing.assert_close(
        got, ref.nestedfp8_matmul_fused_quant_ref(x, u, amax), **GEMM_TOL)


def test_fused_quant_body_rule(dev):
    """x of any type with K and N multiples of 16 and a 16-byte aligned
    upper takes the mma body (dynamic shared memory by M's tile
    config); any other shape the in-register body (none)."""
    from repro_torch.kernels.nestedfp8_matmul_fused_quant import (
        dynamic_smem_bytes)

    def upper(k, n):
        return torch.zeros((k, n), dtype=torch.uint8, device=dev)

    assert dynamic_smem_bytes(upper(4096, 4096), 8) > 0
    assert dynamic_smem_bytes(upper(14336, 4096), 8192) > 0
    assert dynamic_smem_bytes(upper(1008, 1040), 37) > 0
    assert dynamic_smem_bytes(upper(999, 1001), 37) == 0
    assert dynamic_smem_bytes(upper(64, 8), 1) == 0
    # a view 8 bytes into its storage breaks the 16-byte alignment
    shifted = torch.zeros(8208, dtype=torch.uint8, device=dev)[8:8200]
    assert dynamic_smem_bytes(shifted.view(16, 512), 8) == 0


@pytest.mark.parametrize("m", [32, 64, 65, 256, 257, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_quant_rows_do_not_depend_on_the_batch(dev, m, dtype):
    """Given the same amax, row 17 computed alone equals row 17 inside a
    batch of m rows bitwise, across every tile config of the mma body
    (M <= 64, 64 < M <= 256, M > 256): one k order, no split-K."""
    x, w = _gemm(dev, 2048, 4096, 1024, seed=8)
    x = x.to(dtype)
    u, _ = nf.encode(w)
    amax = quant.absmax(x)
    batch = ops.matmul_nested_fp8_fused_quant(x[:m], u, amax)
    one = ops.matmul_nested_fp8_fused_quant(x[17:18], u, amax)
    assert torch.equal(batch[17:18], one)


@pytest.mark.parametrize("shape", [(256, 256), (37, 1001), (1, 7)])
def test_nestedfp_encode(dev, shape):
    """Every f16 bit pattern (applicable or not: the formula is total)
    encodes to the bytes of `nestedfp.encode`, on ragged shapes too."""
    n = shape[0] * shape[1]
    bits = torch.arange(n, dtype=torch.int32) * (65536 // n + 1) % 65536
    w = nf._bits_to_f16(bits).reshape(shape)
    n0 = ops.all_launch_counters()["nestedfp_encode"]
    u, l = ops.encode(w.to(dev))
    wu, wl = nf.encode(w)
    assert torch.equal(u.cpu(), wu) and torch.equal(l.cpu(), wl)
    assert ops.all_launch_counters()["nestedfp_encode"] == n0 + 1


def test_nestedfp_encode_every_pattern(dev):
    w = nf._bits_to_f16(torch.arange(65536, dtype=torch.int32))
    u, l = ops.encode(w.reshape(256, 256).to(dev))
    wu, wl = nf.encode(w.reshape(256, 256))
    assert torch.equal(u.cpu(), wu) and torch.equal(l.cpu(), wl)


def test_dense_steps_on_the_card(dev):
    """A reduced llama through the dense-slot steps on the card, fp16 and
    fp8: to_serving runs K8, prefill K6 (and K1 / K7), decode over the
    planarized cache K5; logits stay finite and near the CPU's."""
    cfg = get_arch("llama3.1-8b").reduced()
    before = ops.all_launch_counters()
    sp = to_serving(M.init_params(cfg, seed=0, device=dev))
    sp_cpu = params_to(sp, "cpu")
    toks = torch.randint(1, cfg.vocab_size, (3, 40),
                         generator=torch.Generator().manual_seed(9),
                         dtype=torch.int32)
    for mode in ("fp16", "fp8"):
        out = {}
        for d, p in (("cuda", sp), ("cpu", sp_cpu)):
            logits, caches = steps.make_prefill_step(cfg, mode, capacity=48)(
                p, {"tokens": toks.to(d)})
            caches = M.planarize_cache(caches)
            decode = steps.make_decode_step(cfg, mode)
            nxt = toks[:, -1:]
            seq = [logits.float().cpu()]
            for i in range(3):
                # the step's static logits: the next call overwrites them
                logits, caches = decode(p, caches, nxt.to(d), 40 + i)
                seq.append(logits.float().cpu().clone())
            out[d] = torch.stack(seq)
        assert torch.isfinite(out["cuda"]).all()
        # bf16 activations on both sides; see tests/test_torch_dense.py
        tol = {"fp16": 0.1, "fp8": 0.5}[mode]
        assert (out["cuda"] - out["cpu"]).abs().max() <= tol
    after = ops.all_launch_counters()
    for name in ("nestedfp_encode", "flash_prefill_attention",
                 "planar_decode_attention", "nestedfp16_matmul",
                 "nestedfp8_matmul_fused_quant"):
        assert after[name] > before[name], name


# -- the dense-slot decode step as a CUDA graph (launch/steps.py) ----------

def _dense_case(dev, arch, mode, **over):
    """A reduced model's dense-slot prefill of 3 x 40 tokens (with its stub
    frontend's inputs) on the card -> (cfg, params, planar caches, next
    tokens, cache length: 40 plus a vlm's patches)."""
    import dataclasses
    cfg = dataclasses.replace(get_arch(arch).reduced(), **over)
    sp = to_serving(M.init_params(cfg, seed=0, device=dev))
    gen = torch.Generator(device=dev).manual_seed(9)
    toks = torch.randint(1, cfg.vocab_size, (3, 40), device=dev,
                         generator=gen, dtype=torch.int32)
    batch = {"tokens": toks, **steps.stub_frontend(cfg, 3, 40, generator=gen,
                                                   device=dev)}
    n = 40 + (cfg.frontend_len if cfg.frontend == "vision" else 0)
    logits, caches = steps.make_prefill_step(cfg, mode, capacity=n + 8)(
        sp, batch)
    return cfg, sp, M.planarize_cache(caches), \
        logits.argmax(-1).to(torch.int32)[:, None], n


def _attn_layers(cfg) -> int:
    """Self-attention layers a decode step runs (K5 launches)."""
    return cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" \
        else cfg.n_layers


# the dense families at head dims 128 and 256, then the families this
# path took last: phi-3-vision (D = 96, patches ahead of the text),
# zamba2 (its shared attention at D = 80) and seamless (D = 64, the
# cross caches in the graph's key)
DENSE_GRAPH_CASES = [("llama3.1-8b", {}), ("gemma3-1b", {"head_dim": 256}),
                     ("phi-3-vision-4.2b", {"head_dim": 96}),
                     ("zamba2-2.7b", {"head_dim": 80, "n_layers": 4}),
                     ("seamless-m4t-large-v2", {})]


@pytest.mark.parametrize("arch,over", DENSE_GRAPH_CASES)
@pytest.mark.parametrize("mode", ["fp16", "fp8"])
def test_decode_graph_first_replay_is_its_eager_call(dev, arch, over, mode):
    """The first call captures; the next (the first replay) gives the
    logits and every cache plane of an eager `decode_step` on clones of
    the same caches, bitwise; its launches are counted as one step's."""
    cfg, sp, caches, nxt, n = _dense_case(dev, arch, mode, **over)
    step = steps.make_decode_step(cfg, mode)
    step(sp, caches, nxt, n)
    assert step.n_captured == 1
    n0 = ops.all_launch_counters()["planar_decode_attention"]
    same = step.check_replay(sp, caches, nxt, n)
    assert all(same.values()), same
    assert ops.all_launch_counters()["planar_decode_attention"] == \
        n0 + _attn_layers(cfg)
    assert step.n_captured == len(step.keys()) == 1
    assert step.pool_bytes() > 0


@pytest.mark.parametrize("arch,over", DENSE_GRAPH_CASES)
@pytest.mark.parametrize("length", ["int", "device"])
def test_decode_graph_replays_follow_cache_len(dev, arch, over, length):
    """Replays with cache_len advancing (an int staged from the host, or
    a (B,) device tensor copied on the device) give each next eager
    step's logits bitwise, and write the caches as the eager steps do."""
    cfg, sp, caches, nxt, n = _dense_case(dev, arch, "fp16", **over)
    eager = {sub: {k: p.clone() for k, p in planes.items()}
             for sub, planes in caches.items()}
    step, rt = steps.make_decode_step(cfg, "fp16"), steps.serve_rt("fp16")
    for i in range(5):
        cl = n + i if length == "int" else torch.full(
            (3,), n + i, dtype=torch.int32, device=dev)
        got, _ = step(sp, caches, nxt, cl)
        want, _ = M.decode_step(rt, sp, cfg, nxt, eager, cl)
        assert torch.equal(got, want), i
        nxt = want.argmax(-1).to(torch.int32)[:, None]
    assert step.n_captured == 1
    for sub, planes in caches.items():
        for k, p in planes.items():
            assert torch.equal(p, eager[sub][k]), (sub, k)


def test_decode_graph_failed_capture_raises(dev, monkeypatch):
    """An error while the step is captured reaches the caller; nothing
    runs the eager step in its place."""
    cfg, sp, caches, nxt, _ = _dense_case(dev, "llama3.1-8b", "fp16")
    step = steps.make_decode_step(cfg, "fp16")
    real = M.decode_logits

    def body(*a, **k):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("refused inside a capture")
        return real(*a, **k)
    monkeypatch.setattr(M, "decode_logits", body)
    with pytest.raises(RuntimeError, match="refused inside a capture"):
        step(sp, caches, nxt, 40)
    assert step.n_captured == 0


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


# -- the engine's captured steps (serving/graphs.py) -------------------------

def _fake_clock():
    """4 ms a reading: the dual controller's decisions then depend on the
    step count alone, so two runs take the same modes."""
    import itertools
    c = itertools.count()
    return lambda: next(c) * 0.004


def _graph_engine(cfg, sp, *, dual=False, **kw):
    from repro_torch.core.policy import DualPrecisionController, SLOConfig
    if dual:
        kw.update(controller=DualPrecisionController(
            SLOConfig(tpot_ms=33.3, hysteresis_steps=1),
            fp16_ms_per_token=1.0, fp8_ms_per_token=0.5,
            fixed_overhead_ms=1.0), clock=_fake_clock())
    eng = Engine(cfg, sp, n_slots=4, capacity=64, kv_planar=True, **kw)
    rng = np.random.default_rng(3)
    base = [int(t) for t in rng.integers(1, cfg.vocab_size, 32)]
    for i in range(6):
        toks = base if i % 2 == 0 else \
            [int(t) for t in rng.integers(1, cfg.vocab_size, 20 + i)]
        eng.submit(Request(f"r{i}", toks, 12))
    return eng


@pytest.fixture(scope="module")
def llama_sp():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    cfg = get_arch("llama3.1-8b").reduced()
    return cfg, to_serving(M.init_params(cfg, seed=0, device="cuda"))


def _eager_on_card(eng, monkeypatch):
    """Run every key of `eng` eagerly on the card: the step the graphs
    capture, called as the CPU calls it."""
    g = eng.graphs

    def run(key):
        g._call(g._steps[key])
        return g._steps[key].ids
    monkeypatch.setattr(g, "run", run)


def test_every_captured_replay_is_its_eager_call(dev, llama_sp):
    """Each key a dual run captures (both decode modes, every prefill
    bucket), right after the step that captured it: one replay's ids and
    pool planes are bitwise an eager call of the same step on clones of
    the same inputs, table and pool."""
    cfg, sp = llama_sp
    eng = _graph_engine(cfg, sp, dual=True, chunk_tokens=32)
    g, checked = eng.graphs, set()
    while eng.queue or eng.active or eng.prefilling:
        eng.step()
        for key in sorted(g.keys() - checked):
            same = g.check_replay(key)
            assert all(same.values()), (key, same)
            checked.add(key)
    assert g.keys("decode") == {"fp16", "fp8"}
    assert len(g.keys("prefill")) >= 2
    assert g.n_captured == len(checked) == len(g.keys())


@pytest.mark.parametrize("case", ["dual", "scarce"])
def test_precaptured_keys_give_the_same_tokens(dev, llama_sp, case):
    """A dual-controller run and a scarce-pool run (preemption) finish
    with the same tokens when every key was captured before the run
    (on zeroed inputs, which write only to the trash block), and a
    second engine captures nothing more."""
    cfg, sp = llama_sp
    kw = (dict(dual=True) if case == "dual"
          else dict(forced_mode="fp16", n_blocks=6, chunk_tokens=32))
    first = _graph_engine(cfg, sp, **kw)
    out = {r.request_id: r.output for r in first.run()}
    keys = first.graphs.keys()
    if case == "scarce":
        assert first.stats["preemptions"] > 0
    second = _graph_engine(cfg, sp, **kw)
    for key in sorted(keys):
        second.graphs.capture(key)
    assert second.graphs.n_captured == len(keys)
    assert {r.request_id: r.output for r in second.run()} == out
    assert second.graphs.keys() == keys
    assert second.graphs.n_captured == len(keys)


def test_replayed_launch_counts_are_the_eager_counts(dev, llama_sp,
                                                     monkeypatch):
    """Launch counters after a graph run equal those of the same request
    set with every step eager on the card, and so do the tokens."""
    cfg, sp = llama_sp
    counts, outs = {}, {}
    for eager in (False, True):
        eng = _graph_engine(cfg, sp, dual=True)
        if eager:
            _eager_on_card(eng, monkeypatch)
        ops.reset_launch_counters()
        outs[eager] = {r.request_id: r.output for r in eng.run()}
        counts[eager] = ops.all_launch_counters()
        assert eng.graphs.n_captured == (0 if eager else len(eng.graphs.keys()))
    assert counts[False] == counts[True]
    assert outs[False] == outs[True]
    for name in ("nestedfp16_matmul", "nestedfp8_matmul", "quant_per_token",
                 "paged_planar_decode_attention"):
        assert counts[False][name] > 0, name


def test_a_failed_capture_raises(dev, llama_sp, monkeypatch):
    """An error while a step is captured reaches the caller; nothing
    runs the eager step in its place."""
    cfg, sp = llama_sp
    eng = _graph_engine(cfg, sp, forced_mode="fp16")
    real = M.paged_step

    def step(*a, **k):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("refused inside a capture")
        return real(*a, **k)
    monkeypatch.setattr(M, "paged_step", step)
    with pytest.raises(RuntimeError, match="refused inside a capture"):
        eng.step()
    assert eng.graphs.n_captured == 0


def test_graphs_are_freed_with_their_engine(dev, llama_sp):
    """An engine's graphs, pool and buffers go with it: its pool's
    segments leave the allocator, and the allocated bytes return to
    where they were before the engine (after a first engine has made
    the capture stream's cuBLAS workspace, which stays)."""
    import gc
    cfg, sp = llama_sp
    _graph_engine(cfg, sp, forced_mode="fp8").run()
    # earlier tests' garbage goes first: collected during this test, it
    # would lower the bytes below the base (the engine itself must still
    # go by reference counting alone)
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    eng = _graph_engine(cfg, sp, dual=True)
    eng.run()
    pool = tuple(eng.graphs._pool)
    assert eng.graphs.pool_bytes() > 0
    del eng
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == base
    torch.cuda.empty_cache()
    assert not [s for s in torch.cuda.memory_snapshot()
                if tuple(s.get("segment_pool_id", ())) == pool]


# -- the fleet: two replicas behind the router (serving/router.py) ---------

def _fleet(cfg, sp, plan=None):
    from repro_torch.serving.router import Router
    r = Router.build(cfg, sp, 2, plan=plan, affinity_blocks=1,
                     balance_slack_tokens=40,
                     engine_kwargs=dict(n_slots=4, capacity=64,
                                        kv_planar=True, forced_mode="fp16",
                                        device="cuda"))
    rng = np.random.default_rng(5)
    sysp = [int(t) for t in rng.integers(1, cfg.vocab_size, 32)]
    for i in range(4):
        r.submit(Request(f"r{i}", sysp + [
            int(t) for t in rng.integers(1, cfg.vocab_size, 6)], 12))
    return r


def _allocated():
    import gc
    gc.collect()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def test_router_replicas_share_weights_and_fail_over(dev, llama_sp):
    """Replicas built from one serving tree hold one copy of the weights
    (same addresses) and a pool each; a kill mid-generation loses nothing,
    and its requests finish on the survivor with their failover tokens
    counted (the shared prefix restored, the rest recomputed)."""
    from repro_torch.models.convert import leaves
    from repro_torch.serving.faults import FaultEvent, FaultPlan
    cfg, sp = llama_sp
    r = _fleet(cfg, sp)
    a, b = (rep.engine for rep in r.replicas)
    ptrs = [t.data_ptr() for t in leaves(sp)]
    assert [t.data_ptr() for t in leaves(a.params)] == ptrs
    assert [t.data_ptr() for t in leaves(b.params)] == ptrs
    assert {p.data_ptr() for p in a.caches["attn"].values()}.isdisjoint(
        p.data_ptr() for p in b.caches["attn"].values())
    assert a.queue and b.queue           # the burst spreads over both
    r.run()
    control = {q.request_id: q.output for q in r.finished}
    r = _fleet(cfg, sp, FaultPlan([FaultEvent(4, 0, "kill")]))
    r.run()
    st = r.stats()
    assert st["lost"] == 0 and st["completed"] == 4 and st["kills"] == 1
    assert st["failover_requests"] > 0
    assert st["failover_restored_tokens"] > 0
    assert st["failover_recomputed_tokens"] > 0
    assert {q.request_id: len(q.output) for q in r.finished} \
        == {k: len(v) for k, v in control.items()}


def test_router_rebuild_returns_the_old_engine(dev, llama_sp):
    """A replica whose drain fails is rebuilt from its factory: by the time
    the factory runs, the old engine is gone (no reference left, its pool
    returned to the allocator), its graph pool's segments leave the
    allocator, and the fleet finishes its requests."""
    import weakref
    from repro_torch.serving.faults import FaultEvent, FaultPlan
    cfg, sp = llama_sp
    r = _fleet(cfg, sp, FaultPlan([FaultEvent(3, 0, "raise")]))
    for _ in range(3):
        r.step()
    rep = r.replicas[0]
    old = rep.engine

    def fail():
        raise RuntimeError("drain failed")
    old.drain_requests = fail
    ref, pool = weakref.ref(old), tuple(old.graphs._pool)
    pool_bytes = sum(p.numel() * p.element_size()
                     for p in old.caches["attn"].values())
    assert old.graphs.pool_bytes() > 0
    del old
    build, seen = rep.factory, {}

    def factory():
        seen["free"], seen["alive"] = _allocated(), ref() is not None
        return build()
    rep.factory = factory
    before = _allocated()
    r.step()
    assert r.stats()["rebuilds"] == 1 and not seen["alive"]
    assert before - seen["free"] >= pool_bytes
    torch.cuda.empty_cache()
    assert not [g for g in torch.cuda.memory_snapshot()
                if tuple(g.get("segment_pool_id", ())) == pool]
    r.run()
    assert r.stats()["lost"] == 0 and r.stats()["completed"] == 4


# -- sliding-window serving: gemma3-1b reduced (window 19, D = 64) ----------

@pytest.fixture(scope="module")
def gemma_sp():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    cfg = get_arch("gemma3-1b").reduced()
    return cfg, to_serving(M.init_params(cfg, seed=0, device="cpu"))


def _gemma_requests(vocab, n=6):
    """A shared system prompt longer than the window; the first request
    stops after one token and releases its blocks unslid, so later
    requests attach the prefix (the local group only its last window)."""
    rng = np.random.default_rng(5)
    sys_prompt = [int(t) for t in rng.integers(1, vocab, 40)]
    return [(f"r{i}", sys_prompt + [int(t) for t in rng.integers(
        1, vocab, 1 if i == 0 else 5 + 4 * i)], 1 if i == 0 else 12)
        for i in range(n)]


def _gemma_engine(cfg, sp, device, **kw):
    eng = Engine(cfg, params_to(sp, device), n_slots=3, capacity=96,
                 block_size=8, forced_mode="fp16", kv_planar=True,
                 device=device, **kw)
    for rid, toks, mx in _gemma_requests(cfg.vocab_size):
        eng.submit(Request(rid, toks, mx))
    return eng


def test_gemma_engine_on_the_card_matches_the_cpu(dev, gemma_sp):
    """The same requests on the card and on the CPU, stepped together:
    the same block tables of both window groups after every step, the
    same window counters, and the same greedy tokens up to a near tie (a
    token may differ only where the CPU's top-2 margin, recomputed by the
    dense prefill, is within 2 x 1e-2, SLICE_TOL of the slice phase)."""
    from repro_torch.models.layers import Runtime
    cfg, sp = gemma_sp
    on = {d: _gemma_engine(cfg, sp, d) for d in ("cuda", "cpu")}
    before = ops.all_launch_counters()
    while on["cpu"].queue or on["cpu"].active or on["cpu"].prefilling:
        for e in on.values():
            e.step()
        assert (on["cuda"].blocks.group_tables()
                == on["cpu"].blocks.group_tables()).all()
        assert on["cuda"].blocks.window_freed_blocks == \
            on["cpu"].blocks.window_freed_blocks
    assert ops.all_launch_counters()["paged_planar_decode_attention"] > \
        before["paged_planar_decode_attention"]
    assert on["cpu"].stats["window_reclaimed_blocks"] > 0
    assert on["cpu"].prefix_cache_stats()["hit_tokens"] > 0
    got = {r.request_id: r.output for r in on["cuda"].finished}
    want = {r.request_id: r.output for r in on["cpu"].finished}
    prompts = {r: t for r, t, _ in _gemma_requests(cfg.vocab_size)}
    rt = Runtime(mode="fp16", dtype=torch.float32)
    agreed = 0
    for rid, w in want.items():
        for i, (a, b) in enumerate(zip(got[rid], w)):
            if a != b:
                seq = torch.tensor([prompts[rid] + w[:i]], dtype=torch.int32)
                top2 = M.prefill(rt, sp, cfg, {"tokens": seq})[0][0].topk(2)
                assert float(top2.values[0] - top2.values[1]) <= 2e-2, rid
                break
            agreed += 1
    assert agreed >= len(want)


def test_gemma_replays_are_their_eager_calls(dev, gemma_sp):
    """Each key of a gemma3-reduced engine, right after its capture
    (inside its step: the same step's decode slides blocks the prefill
    wrote), and the decode after every step: one replay bitwise an eager
    call on clones of the group tables and the pool."""
    cfg, sp = gemma_sp
    eng = _gemma_engine(cfg, sp, "cuda")
    g = eng.graphs
    assert tuple(g.tables.shape) == (2, 3, 12)
    g.check_first_runs = True
    n = 0
    while eng.queue or eng.active or eng.prefilling:
        d0 = eng.stats["decode_dispatches"]
        eng.step()
        if eng.stats["decode_dispatches"] > d0 and g.graph(("decode", "fp16")):
            same = g.check_replay(("decode", "fp16"))
            assert all(same.values()), same
            n += 1
    assert set(g.checks) == g.keys() and g.n_captured == len(g.keys())
    assert all(all(v.values()) for v in g.checks.values()), g.checks
    assert n > 5 and eng.stats["window_reclaimed_blocks"] > 0


# -- speculation and the tiered KV cache on the card ----------------------------

def test_spec_key_replay_is_its_eager_call(dev, llama_sp):
    """Repetitive prompts draft and verify: each spec key's first replay
    (checked inside the step that captured it) is bitwise an eager call
    of the verification step on clones of its inputs, table and pool."""
    from repro_torch.core.policy import SpeculationConfig
    cfg, sp = llama_sp
    eng = Engine(cfg, sp, n_slots=4, capacity=96, kv_planar=True,
                 forced_mode="fp16", speculate=SpeculationConfig(ngram_min=1))
    for i in range(3):
        eng.submit(Request(f"r{i}", [5 + i, 6, 7, 8] * 6, 16))
    eng.graphs.check_first_runs = True
    eng.run()
    spec = [k for k in eng.graphs.checks if k[0] == "spec"]
    assert spec and eng.spec_stats()["spec_dispatches"] > 0
    for key in spec:
        assert all(eng.graphs.checks[key].values()), (key,
                                                       eng.graphs.checks[key])
        assert eng.graphs.graph(key) is not None


@pytest.fixture(scope="module")
def tiered_run(llama_sp):
    """Two system prompts through an 11-block pool, bursts A, B, A (FP8
    on planar KV, then a fourth burst B in FP16): A's blocks spill during
    B and are restored in the third burst, lazily lo-completed in the
    fourth. Every upload is checked right after it lands: the pool bytes
    of each written block against its host entry, and the addresses of
    the pool planes, the device table and every step key's buffers
    against those before it."""
    cfg, sp = llama_sp
    eng = Engine(cfg, sp, n_slots=2, capacity=128, forced_mode="fp8",
                 kv_planar=True, block_size=16, n_blocks=11,
                 chunk_tokens=64, debug_invariants=True)
    seen = {"uploads": 0, "bytes_equal": True, "addresses_equal": True,
            "host_buffers": []}

    def addresses():
        out = {n: p.data_ptr() for n, p in eng.caches["attn"].items()}
        out["tables"] = eng.blocks.device_tables().data_ptr()
        out.update({k: st.dev.data_ptr() for k, st in eng.graphs._steps.items()})
        return out

    upload = eng._tier_upload

    def checked_upload(g, items, names):
        before = addresses()
        n = upload(g, items, names)
        torch.cuda.synchronize()
        li = eng._group_layers[g]
        for b, h in items:
            entry = eng.blocks.host.entries[(g, h)]
            for name in names:
                got = eng.caches["attn"][name][li, b].cpu().numpy()
                seen["bytes_equal"] &= got.tobytes() == entry[name].tobytes()
        seen["addresses_equal"] &= addresses() == before
        seen["uploads"] += 1
        return n
    eng._tier_upload = checked_upload
    host_buffer = eng._host_buffer

    def recorded_buffer(nbytes):
        buf = host_buffer(nbytes)
        seen["host_buffers"].append(buf.is_pinned())
        return buf
    eng._host_buffer = recorded_buffer
    rng = np.random.default_rng(0)
    sysp = [[int(t) for t in rng.integers(1, cfg.vocab_size, 96)]
            for _ in range(2)]
    for b, (s, mode) in enumerate([(0, "fp8"), (1, "fp8"), (0, "fp8"),
                                   (1, "fp16")]):
        eng.forced_mode = mode
        for i in range(2):
            eng.submit(Request(f"{b}.{i}", sysp[s] + [7 + i, 9, 11 + b], 6))
        eng.run()
    return eng, seen


def test_restored_bytes_are_the_host_entries(dev, tiered_run):
    eng, seen = tiered_run
    ts = eng.tiered_stats()
    assert ts["restored_blocks"] > 0 and ts["lo_lazy_blocks"] > 0, ts
    assert eng.stats["corrupt_fallbacks"] == 0
    assert seen["uploads"] > 0 and seen["bytes_equal"]


def test_tier_transfers_use_pinned_host_buffers(dev, tiered_run):
    """Every spill capture and restore upload moves its bytes through a
    page-locked host buffer (one copy each way, `non_blocking`)."""
    _eng, seen = tiered_run
    assert seen["host_buffers"] and all(seen["host_buffers"])


def test_host_entries_own_their_storage(dev, tiered_run):
    """Each entry's planes view one host buffer of exactly the entry's
    bytes, shared with no other entry and not the (pinned) staging
    buffer: the host memory the tier holds is `host.bytes`."""
    eng, _ = tiered_run
    host = eng.blocks.host
    owners = {}
    for planes in host.entries.values():
        bases = {id(a.base) for a in planes.values()}
        assert len(bases) == 1
        own = next(iter(planes.values())).base
        assert isinstance(own, np.ndarray)
        assert own.nbytes == host.entry_bytes(planes)
        owners[id(own)] = own.nbytes
    assert len(owners) == len(host) and sum(owners.values()) == host.bytes


def test_restore_keeps_the_graphs_addresses(dev, tiered_run):
    eng, seen = tiered_run
    assert eng.graphs.n_captured > 0 and seen["addresses_equal"]


# ---------------------------------------------------------------------------
# the MoE family: granite-moe-3b's attention shapes (24 q / 8 kv heads,
# D = 64, G = 3) and deepseek-v3's MLA GEMM shapes, K8 over an expert
# bank, and the MoE block on the card
# ---------------------------------------------------------------------------

GRANITE_KN = [(1536, 1536), (1536, 512), (1536, 512), (1536, 1536)]
# wq_a, wq_b, wkv_a (N = 576, not a multiple of 128), wk_b / wv_b, wo
# (K = 16384)
DS3_MLA_KN = [(7168, 1536), (1536, 24576), (7168, 576), (512, 16384),
              (16384, 7168)]


@pytest.mark.parametrize("kn", GRANITE_KN[:2] + DS3_MLA_KN)
@pytest.mark.parametrize("m", [8, 256])
@pytest.mark.parametrize("kernel", ["k1", "k2", "k3"])
def test_gemms_at_moe_family_shapes(dev, kernel, m, kn):
    gen = torch.Generator(device=dev).manual_seed(21)
    k, n = kn
    x = torch.randn((m, k), generator=gen, device=dev)
    w = (torch.randn((k, n), generator=gen, device=dev) * k ** -0.5).half()
    name = {"k1": "nestedfp16_matmul", "k2": "nestedfp8_matmul",
            "k3": "f16_matmul"}[kernel]
    n0 = ops.all_launch_counters()[name]
    if kernel == "k2":
        got, xq, s = _k2(x, w)
        want = ref.nestedfp8_matmul_ref(xq, nf.encode(w)[0], s)
    else:
        got = {"k1": _k1, "k3": _k3}[kernel](x.half(), w)
        want = ref.matmul_f16_ref(x.half(), w)
    assert ops.all_launch_counters()[name] == n0 + 1
    torch.testing.assert_close(got, want, **GEMM_TOL)


@pytest.mark.parametrize("fp8", [False, True])
@pytest.mark.parametrize("window", [None, 300])
def test_paged_decode_attention_granite_heads(dev, fp8, window):
    q, planes, tab, ln = _paged_case(dev, 7, [0, 1, 511, 512, 513, 640, 1088],
                                     16, 68, h=24, hkv=8, d=64)
    got = ops.paged_decode_attention(q, planes, tab, ln, fp8=fp8,
                                     window=window)
    want = ref.paged_planar_decode_attention_ref(
        q, planes["k_hi"], planes["k_lo"], planes["v_hi"], planes["v_lo"],
        tab, ln, fp8=fp8, window=window)
    live = ln > 0
    torch.testing.assert_close(got[live], want[live], **ATTN_TOL)


@pytest.mark.parametrize("fp8", [False, True])
def test_planar_decode_attention_granite_heads(dev, fp8):
    b, h, hkv, d, cap = 8, 24, 8, 64, 1088
    planes = _dense_planes(dev, b, cap, hkv, d, seed=8)
    q = torch.randn((b, h, d), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(8))
    ln = torch.tensor([1, 63, 512, 513, 1024, 1025, 1087, 1088],
                      dtype=torch.int32, device=dev)
    got = ops.planar_decode_attention(q, planes, ln, fp8=fp8)
    want = ref.planar_decode_attention_ref(
        q, planes["k_hi"], planes["k_lo"], planes["v_hi"], planes["v_lo"],
        ln, fp8=fp8)
    torch.testing.assert_close(got, want, **ATTN_TOL)


@pytest.mark.parametrize("dtype,b,s", [(torch.bfloat16, 8, 1024),
                                       (torch.float16, 2, 70),
                                       (torch.float32, 2, 65)])
def test_flash_prefill_attention_granite_heads(dev, dtype, b, s):
    gen = torch.Generator(device=dev).manual_seed(9)
    q = torch.randn((b, s, 24, 64), device=dev, generator=gen).to(dtype)
    k = torch.randn((b, s, 8, 64), device=dev, generator=gen).to(dtype)
    v = torch.randn((b, s, 8, 64), device=dev, generator=gen).to(dtype)
    torch.testing.assert_close(ops.flash_prefill_attention(q, k, v),
                               ref.flash_prefill_attention_ref(q, k, v),
                               **ATTN_TOL)


def test_nestedfp_encode_of_an_expert_bank(dev):
    """K8 over a 3-D bank (48 x 1536 x 512, granite's) is bitwise its
    plain version, through NestedTensor.from_f16 (whole-tensor rule)."""
    gen = torch.Generator(device=dev).manual_seed(10)
    w = torch.randn((48, 1536, 512), generator=gen, device=dev) * 1536 ** -0.5
    n0 = ops.all_launch_counters()["nestedfp_encode"]
    t = nf.NestedTensor.from_f16(w)
    assert ops.all_launch_counters()["nestedfp_encode"] == n0 + 1
    wu, wl = nf.encode(w.half().cpu())
    assert torch.equal(t.upper.cpu(), wu) and torch.equal(t.lower.cpu(), wl)
    assert torch.equal(t.read_f16(), w.half())
    w[3, 2, 1] = 2.0
    assert nf.NestedTensor.from_f16(w).is_exception


@pytest.fixture(scope="module")
def granite_moe():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    cfg = dataclasses.replace(get_arch("granite-moe-3b-a800m"), n_layers=1)
    sp = M.init_serving_params(cfg, seed=0, device="cuda")
    return cfg, sp["layers"][0]["moe"]


@pytest.mark.parametrize("mode", ["fp16", "fp8"])
def test_moe_block_replay_is_its_eager_call(dev, granite_moe, mode):
    """granite's MoE block at full width, a 256-token chunk of 2 rows:
    a CUDA graph's replay equals the eager call bitwise (no float
    atomics), and the output holds the plain CPU call's."""
    from repro_torch.models import moe as MOE
    from repro_torch.models.layers import Runtime
    from repro_torch.serving.graphs import capture
    cfg, p = granite_moe
    rt = Runtime(mode=mode, dtype=torch.float32)
    x = torch.randn((2, 256, cfg.d_model), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(3))
    eager = MOE.moe_block(rt, p, cfg, x)
    out = {}
    graph, _ = capture(lambda: out.update(y=MOE.moe_block(rt, p, cfg, x)),
                       torch.cuda.graph_pool_handle(), dev)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out["y"], eager)
    cpu = MOE.moe_block(rt, params_to(p, "cpu"), cfg, x.cpu())
    torch.testing.assert_close(eager.cpu(), cpu, rtol=1e-3, atol=2e-3)


def test_moe_rows_do_not_depend_on_the_batch(dev, granite_moe):
    """Rows are routing groups. At one batch shape a row's output is
    bitwise independent of what the other rows hold (the engine's steps
    keep their shapes per key); across batch sizes cuBLAS picks its f32
    kernel by M (= rows x capacity), so a row routed alone chooses the
    same experts and keeps the same slots, and its output agrees to
    1e-5, not bitwise."""
    from repro_torch.models import moe as MOE
    from repro_torch.models.layers import Runtime
    cfg, p = granite_moe
    rt = Runtime(mode="fp16", dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(4)
    for c in (1, 16):
        x = torch.randn((8, c, cfg.d_model), device=dev, generator=gen)
        y, aux = MOE.moe_block(rt, p, cfg, x, with_aux=True)
        other = x.clone()
        other[[0, 2, 5]] = torch.randn((3, c, cfg.d_model), device=dev,
                                       generator=gen)
        assert torch.equal(MOE.moe_block(rt, p, cfg, other)[1], y[1])
        alone, aux1 = MOE.moe_block(rt, p, cfg, x[1:2], with_aux=True)
        assert torch.equal(aux1["expert_idx"], aux["expert_idx"][1:2])
        assert torch.equal(aux1["keep"], aux["keep"][1:2])
        torch.testing.assert_close(alone, y[1:2], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the recurrent families (mamba2-2.7b, zamba2-2.7b)
# ---------------------------------------------------------------------------

MAMBA2_KN = [(2560, 5120), (2560, 256), (2560, 80), (5120, 2560),
             (2560, 128)]


@pytest.mark.parametrize("kn", MAMBA2_KN)
@pytest.mark.parametrize("kernel", ["k1", "k2", "k3"])
def test_gemms_at_mamba2_shapes(dev, kernel, kn):
    """in_z / in_x, in_bc (N = 256; zamba2's 128), in_dt (N = 80) and
    out_proj at M = 8."""
    test_gemms_at_moe_family_shapes(dev, kernel, 8, kn)


@pytest.fixture(scope="module")
def recurrent():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    out = {}
    for arch, n in (("mamba2-2.7b", 2), ("zamba2-2.7b", 6)):
        cfg = dataclasses.replace(get_arch(arch), n_layers=n)
        out[arch] = (cfg, M.init_serving_params(cfg, seed=0, device="cuda"))
    return out


@pytest.mark.parametrize("b,l", [(1, 300), (2, 37)])
def test_ssd_on_the_card_matches_the_cpu(dev, b, l):
    """`ssd_chunked` from a carried-in state and `ssd_decode_step` at
    mamba2-2.7b's widths (80 heads of 64, d_state 128, chunk 256), card
    against CPU in f32."""
    from repro_torch.models import mamba2 as M2
    gen = torch.Generator().manual_seed(l)
    h, p, n = 80, 64, 128
    x = torch.randn((b, l, h, p), generator=gen)
    dt = torch.rand((b, l, h), generator=gen) * 0.1 + 0.001
    A = -(torch.rand((h,), generator=gen) * 15 + 1)
    B = torch.randn((b, l, 1, n), generator=gen)
    C = torch.randn((b, l, 1, n), generator=gen)
    D = torch.ones((h,))
    s0 = torch.randn((b, h, p, n), generator=gen) * 0.1
    want = M2.ssd_chunked(x, dt, A, B, C, D, chunk=256, initial_state=s0)
    got = M2.ssd_chunked(*(t.to(dev) for t in (x, dt, A, B, C, D)),
                         chunk=256, initial_state=s0.to(dev))
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-3)
    args = (s0, x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0], D)
    want = M2.ssd_decode_step(*args)
    got = M2.ssd_decode_step(*(t.to(dev) for t in args))
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-3)


def _recurrent_engine(cfg, sp, mode="fp16"):
    return Engine(cfg, sp, n_slots=3, capacity=96, forced_mode=mode,
                  chunk_tokens=32, device="cuda")


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
@pytest.mark.parametrize("mode", ["fp16", "fp8"])
def test_recurrent_replays_are_their_eager_calls(dev, recurrent, arch, mode):
    """Every step key of a recurrent engine (the exact-length chunk keys,
    the decode) captured at its first use: its first replay gives the ids
    and every pool and state plane of an eager call on clones, bitwise
    (`StepGraphs.check_first_runs`)."""
    cfg, sp = recurrent[arch]
    eng = _recurrent_engine(cfg, sp, mode)
    eng.graphs.check_first_runs = True
    rng = np.random.default_rng(1)
    for i, n in enumerate((40, 32, 9)):
        eng.submit(Request(f"r{i}", rng.integers(1, 1000, n).tolist(), 5))
    fin = eng.run()
    assert len(fin) == 3 and all(len(r.output) == 5 for r in fin)
    assert eng.graphs.keys("chunk") == {(mode, 32), (mode, 8), (mode, 24),
                                        (mode, 9)}
    assert eng.graphs.n_captured == len(eng.graphs.keys()) == 5
    for key, same in eng.graphs.checks.items():
        assert all(same.values()), (key, same)
    assert {"conv_x", "conv_bc", "ssm"} <= set(
        eng.graphs.checks[("decode", mode)])


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_idle_slot_state_survives_a_replay(dev, recurrent, arch):
    """A slot with no request keeps its state planes bitwise across decode
    replays and chunk replays of the other slots (kv_len 0 rows keep
    their state; a chunk writes only its own slot's row)."""
    cfg, sp = recurrent[arch]
    eng = _recurrent_engine(cfg, sp)
    for p in eng.caches["ssm"].values():
        p[:, 2].normal_()
    kept = {n: p[:, 2].clone() for n, p in eng.caches["ssm"].items()}
    eng.submit(Request("a", list(range(5, 45)), 6))
    eng.submit(Request("b", list(range(7, 20)), 6))
    eng.run()
    assert eng.graphs.n_captured >= 2
    for n, p in eng.caches["ssm"].items():
        assert torch.equal(p[:, 2], kept[n]), n


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_readmission_zeroes_exactly_one_slot(dev, recurrent, arch):
    """(Re-)admission zeroes the admitted slot's state on the card and
    leaves every other slot's state as it was."""
    cfg, sp = recurrent[arch]
    eng = _recurrent_engine(cfg, sp)
    for p in eng.caches["ssm"].values():
        p.normal_()
    before = {n: p.clone() for n, p in eng.caches["ssm"].items()}
    eng.submit(Request("a", list(range(5, 45)), 4))
    eng._plan_chunks()                      # admits into slot 0
    torch.cuda.synchronize()
    for n, p in eng.caches["ssm"].items():
        assert not p[:, 0].any(), n
        assert torch.equal(p[:, 1:], before[n][:, 1:]), n



# ---------------------------------------------------------------------------
# tensor-parallel serving: the kernels at one shard's shapes, the
# quantizer's halves for row-parallel layers, a mesh on the card
# ---------------------------------------------------------------------------

# (K, N) of one shard's GEMMs: llama3.1-8b at 4 and 2 shards, gemma3-1b
# at 4 (N = 1728 is not a multiple of 128)
TP_KN = sorted({(4096, 1024), (4096, 256), (1024, 4096), (4096, 3584),
                (3584, 4096), (4096, 2048), (4096, 512), (2048, 4096),
                (4096, 7168), (7168, 4096), (1152, 256), (256, 1152),
                (1152, 1728), (1728, 1152)})


@pytest.mark.parametrize("m", [8, 37])
@pytest.mark.parametrize("kn", TP_KN)
@pytest.mark.parametrize("kernel", ["k1", "k2", "k3"])
def test_gemms_at_per_shard_shapes(dev, kernel, kn, m):
    x, w = _gemm(dev, m, *kn, seed=7)
    u, l = nf.encode(w)
    if kernel == "k1":
        got, want = (ops.matmul_nested_f16(x.half(), u, l),
                     ref.nestedfp16_matmul_ref(x.half(), u, l))
    elif kernel == "k3":
        got, want = (ops.matmul_f16(x.half(), w),
                     ref.matmul_f16_ref(x.half(), w))
    else:
        xq, s = ops.quantize_act_per_token(x)
        got, want = (ops.matmul_nested_fp8(xq, u, s),
                     ref.nestedfp8_matmul_ref(xq, u, s))
    torch.testing.assert_close(got, want, **GEMM_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("k,parts", [(4096, 4), (14336, 4), (14336, 2),
                                     (6912, 4), (40000, 2)])
def test_row_parallel_quantizer_halves(dev, dtype, k, parts):
    """`row_absmax` and `quant_per_token_scaled` bitwise their plain
    versions, and a row's column slices quantized under the max of their
    absmaxes give the one-launch quantizer's codes and scales, bitwise
    (rows of zeros and a row whose max lies in the last slice; K = 20000 a
    slice takes the two-pass body)."""
    rng = np.random.default_rng(k + parts)
    x = torch.from_numpy(rng.normal(size=(9, k)).astype(np.float32)).to(dev)
    x[1] = 0.0
    x[2, -1] = 1e3
    x = x.to(dtype)
    q, s = ops.quantize_act_per_token(x)
    c = k // parts
    sl = [x[:, i * c:(i + 1) * c].contiguous() for i in range(parts)]
    n0 = ops.all_launch_counters()
    amaxes = [ops.act_row_absmax(p) for p in sl]
    for p, a in zip(sl, amaxes):
        assert torch.equal(a, ref.row_absmax_ref(p))
    scale = quant.scale_from_amax(torch.stack(amaxes).amax(0))
    codes = [ops.quantize_act_scaled(p, scale) for p in sl]
    for p, cd in zip(sl, codes):
        assert torch.equal(cd.view(torch.uint8),
                           ref.quantize_scaled_ref(p, scale).view(torch.uint8))
    n1 = ops.all_launch_counters()
    assert n1["row_absmax"] - n0["row_absmax"] == parts
    assert n1["quant_per_token_scaled"] - n0["quant_per_token_scaled"] == parts
    assert torch.equal(scale, s)
    assert torch.equal(torch.cat(codes, 1).view(torch.uint8),
                       q.view(torch.uint8))


@pytest.mark.parametrize("fp8", [False, True])
@pytest.mark.parametrize("h,hkv,d,window", [(8, 2, 128, None),
                                            (16, 4, 128, None),
                                            (1, 1, 256, None),
                                            (1, 1, 256, 300),
                                            (2, 1, 256, 300)])
def test_paged_decode_attention_at_per_shard_heads(dev, fp8, h, hkv, d,
                                                   window):
    """K4 on one shard's q heads over its pool planes: llama3.1-8b's at 4
    and 2 shards, gemma3-1b's at 4 and 2 (its one kv head whole on every
    shard, G = 1 and 2)."""
    q, planes, tab, ln = _paged_case(dev, 9, [0, 1, 511, 512, 513, 640],
                                     16, 40, h=h, hkv=hkv, d=d)
    got = ops.paged_decode_attention(q, planes, tab, ln, fp8=fp8,
                                     window=window)
    want = ref.paged_planar_decode_attention_ref(
        q, planes["k_hi"], planes["k_lo"], planes["v_hi"], planes["v_lo"],
        tab, ln, fp8=fp8, window=window)
    live = ln > 0
    torch.testing.assert_close(got[live], want[live], **ATTN_TOL)


@pytest.mark.parametrize("mode", ["fp16", "fp8"])
def test_colocated_mesh_engine_on_the_card(dev, mode):
    """qwen1.5-0.5b reduced on 4 shards of one card (layer 1's wo an
    exception tensor): every step key captured as one CUDA graph, its
    first replay bitwise an eager call on clones (every shard's pool
    planes), `stats` equal to the unsharded engine's (no prefix cache:
    the schedule is the tokens' own), every request finished, and the
    quantizer halves launched in FP8."""
    from repro_torch.launch.mesh import make_serving_mesh

    cfg = get_arch("qwen1.5-0.5b").reduced()

    def plant(i, path, w):
        if (i, path) == (1, "attn/wo/w"):
            w[0, 0] = 2.0
    sp = M.init_serving_params(cfg, seed=0, device="cuda", plant=plant)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (13, 29, 7, 40)]
    runs = {}
    for m in (1, 4):
        mesh = None if m == 1 else make_serving_mesh(m,
                                                     devices=[dev] * m)
        eng = Engine(cfg, sp, n_slots=4, capacity=96, forced_mode=mode,
                     kv_planar=True, prefix_cache=False, device="cuda",
                     mesh=mesh)
        eng.graphs.check_first_runs = True
        n0 = ops.all_launch_counters()
        for i, p in enumerate(prompts):
            eng.submit(Request(f"r{i}", p, 6))
        fin = eng.run()
        n1 = ops.all_launch_counters()
        assert len(fin) == 4 and all(len(r.output) == 6 for r in fin)
        assert eng.graphs.n_captured == len(eng.graphs.keys()) >= 2
        for key, same in eng.graphs.checks.items():
            assert all(same.values()), (key, same)
        runs[m] = (eng.stats, {k: n1[k] - n0[k] for k in n1})
    assert runs[4][0] == runs[1][0]
    if mode == "fp8":
        assert runs[4][1]["row_absmax"] > 0
        assert runs[4][1]["quant_per_token_scaled"] > 0
        assert runs[1][1]["row_absmax"] == 0


def test_reckoned_arguments_are_what_the_dense_decode_holds(dev):
    """The dry run's reckoned `argument_gib` of qwen1.5-0.5b's dense-slot
    decode step on one card (`make_debug_mesh(1, 1)`) against the bytes
    that its params, planar caches, tokens and cache_len hold on the
    card, within 1 %."""
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.convert import serving_memory_bytes
    cfg = get_arch("qwen1.5-0.5b")
    b, cap = 4, 256
    shape = InputShape("decode", cap, b, "decode")
    want = dryrun.argument_bytes(cfg, shape, make_debug_mesh(1, 1),
                                 kv="planar")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    sp = M.init_serving_params(cfg, seed=0, device="cuda")
    caches = M.init_cache(cfg, b, cap, planar=True, device="cuda")
    tokens = torch.ones((b, 1), dtype=torch.int32, device=dev)
    cache_len = torch.tensor(7, dtype=torch.int32, device=dev)
    held = serving_memory_bytes(sp)["total_bytes"] + sum(
        p.numel() * p.element_size() for planes in caches.values()
        for p in planes.values()) + 4 * b + 4
    assert held == pytest.approx(want, rel=1e-2)
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated() - base
    assert allocated == pytest.approx(want, rel=1e-2)
    logits, _ = steps.make_decode_step(cfg, "fp16")(sp, caches, tokens,
                                                    cache_len)
    assert bool(torch.isfinite(logits).all())
