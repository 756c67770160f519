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
            assert pda.dynamic_smem_bytes(64, fp8=fp8, paged=paged) > 0
            assert pda.dynamic_smem_bytes(128, fp8=fp8, paged=paged) > 0
            assert pda.dynamic_smem_bytes(96, fp8=fp8, paged=paged) == 0
    planes = _dense_planes(dev, 1, 32, 1, 96, seed=9)
    with pytest.raises(ValueError, match="D=96"):
        ops.planar_decode_attention(torch.zeros((1, 1, 96), device=dev),
                                    planes, torch.ones(1, dtype=torch.int32,
                                                       device=dev), fp8=False)


# (dtype, b, s, h, hkv, d): f32 runs the SIMT body, f16 and bf16 the
# tensor-core body; the second group sits on the 64-key and 64-row tile
# edges for every G = H / Hkv, the last is llama3.1-8b's prefill
PREFILL_CASES = (
    [(dt, *shape) for shape in [(2, 128, 8, 2, 128), (1, 1000, 32, 8, 128),
                                (3, 45, 4, 4, 64)]
     for dt in (torch.float32, torch.float16, torch.bfloat16)]
    + [(dt, 2, s, 2 * g, 2, d) for dt in (torch.float16, torch.bfloat16)
       for s in (1, 63, 64, 65) for g in (1, 2, 4, 8) for d in (64, 128)]
    + [(torch.bfloat16, 8, 1024, 32, 8, 128)])


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
                logits, caches = decode(p, caches, nxt.to(d), 40 + i)
                seq.append(logits.float().cpu())
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
    cfg, sp = llama_sp
    _graph_engine(cfg, sp, forced_mode="fp8").run()
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
