"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``gpu`` marker and skips (inside the ``cuda``
fixture, never at import) where ``torch.cuda.is_available()`` is false: a
CUDA kernel has no CPU mode. Imports torch only, so it also runs on a
machine without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerance: max |kernel - plain| <= 1e-4 x max |plain| in fp32 and
2e-2 x max |plain| in bf16 (the kernels sum in another order, and in bf16
round their probabilities at other points of the online softmax); the PLAN
sigmoid and its gradient are bit-identical (every product is exact)."""
import pytest
import torch

from repro_torch.core import graphs
from repro_torch.core.packing import pack_matrix
from repro_torch.kernels.attn_decode import kernel as dec_k
from repro_torch.kernels.attn_decode import ops as dec_ops
from repro_torch.kernels.attn_prefill import kernel as pf_k
from repro_torch.kernels.attn_prefill import ops as pf_ops
from repro_torch.kernels.qmatmul import kernel as qmm_k
from repro_torch.kernels.qmatmul import ops as qmm_ops
from repro_torch.kernels.qmatvec import kernel as qmv_k
from repro_torch.kernels.qmatvec import ops as qmv_ops
from repro_torch.kernels.sigmoid_pw import kernel as sig_k
from repro_torch.kernels.sigmoid_pw import ops as sig_ops
from repro_torch.kernels.sigmoid_pw import ref as sig_ref

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _check(got, ref, dtype):
    assert got.device.type == "cuda" and got.dtype == ref.dtype
    got, ref = got.cpu().float(), ref.float()
    assert torch.isfinite(got).all()
    err = (got - ref).abs().max().item()
    assert err <= TOL[dtype] * ref.abs().max().item(), err


def _on(dev, *ts):
    return [None if t is None else t.to(dev) for t in ts]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,k,n", [(8, 1536, 256), (3, 23, 40), (37, 8960, 100),
                                   (512, 1536, 1536), (100, 784, 1022),
                                   (100, 429, 1022), (100, 1022, 1022),
                                   (1, 1536, 1536), (16, 1536, 8960),
                                   (17, 429, 61), (8, 1022, 10),
                                   (8, 8960, 1536), (8, 23, 61),
                                   (2048, 1536, 8960), (2048, 8960, 1536)])
def test_qmatvec(cuda, dtype, m, k, n):
    """The engine's projections at decode M (1, 8, 16) and prefill M (up to
    2048), the paper MLP's layers, K not a multiple of a chunk (23, 429,
    1022) and N not a multiple of any tile (10, 61, 100, 1022): with and
    without bias, in x's dtype and in fp32, through the variant the plan
    picks for M; two runs give the same bits."""
    g = _gen(m + k)
    x = torch.randn((m, k), generator=g).to(dtype)
    w = pack_matrix(torch.randint(-4, 4, (k, n), generator=g,
                                  dtype=torch.int8), 3)
    d = torch.rand(n, generator=g) * 0.1
    b = torch.randn(n, generator=g)
    variant = "decode" if m <= 16 else "prefill"
    assert qmv_k.plan(m, k, n, dtype).variant == variant
    xc, wc, dc = _on(cuda, x, w, d)
    for bias, out_dtype in ((b, None), (None, None), (b, torch.float32),
                            (None, torch.bfloat16)):
        ref = qmv_ops.qmatvec(x, w, d, k=k, bias=bias, out_dtype=out_dtype)
        n0, v0 = qmv_k.launches, qmv_k.launches_by_variant[variant]
        bc = None if bias is None else bias.to(cuda)
        got = qmv_ops.qmatvec(xc, wc, dc, k=k, bias=bc, out_dtype=out_dtype)
        assert qmv_k.launches == n0 + 1
        assert qmv_k.launches_by_variant[variant] == v0 + 1
        _check(got, ref, torch.bfloat16 if torch.bfloat16 in (
            dtype, out_dtype) else torch.float32)
        again = qmv_ops.qmatvec(xc, wc, dc, k=k, bias=bc, out_dtype=out_dtype)
        assert torch.equal(got, again)


SPECIAL = [0.0, -0.0, 1.0, -1.0, 2.375, -2.375, 5.0, -5.0, 0.99999994,
           -1.0000001, 2.3749998, 4.9999995, -5.0000005, 1e-40, -1e-40,
           float("inf"), float("-inf"), float("nan")]


def _same(got, ref):
    """Bit-identical values; NaN where and only where the plain one is."""
    got = got.cpu()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan], ref[~nan])
    assert torch.equal(torch.signbit(got[~nan]), torch.signbit(ref[~nan]))


def _sig_inputs(dtype):
    g = _gen(5)
    yield (torch.cat([torch.linspace(-8, 8, 1000), torch.tensor(SPECIAL)])
           .to(dtype))
    for shape in ((100, 1022), (7,), (3, 5), (2, 3, 129)):
        yield (torch.randn(shape, generator=g) * 4).to(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_sigmoid_pw_forward_and_backward_bit_identical(cuda, dtype):
    for x in _sig_inputs(dtype):
        n0, b0 = sig_k.launches, sig_k.bwd_launches
        xc = x.to(cuda).requires_grad_(True)
        y = sig_ops.sigmoid_pw(xc)
        r = torch.randn(x.shape, generator=_gen(6)).to(dtype)
        (y * r.to(cuda)).sum().backward()
        assert (sig_k.launches, sig_k.bwd_launches) == (n0 + 1, b0 + 1)
        xp = x.clone().requires_grad_(True)
        yp = sig_ref.sigmoid_pw(xp)
        (yp * r).sum().backward()
        _same(y.detach(), yp.detach())
        keep = ~torch.isnan(x)
        _same(xc.grad.cpu()[keep], xp.grad[keep])


@pytest.mark.parametrize("dtype", DTYPES)
def test_sigmoid_pw_views(cuda, dtype):
    """A strided view and a contiguous view whose start is not 16-byte
    aligned (the scalar path) give the plain version's bits."""
    base = (torch.randn((64, 130), generator=_gen(7)) * 4).to(dtype)
    on = base.to(cuda)
    with torch.no_grad():
        _same(sig_ops.sigmoid_pw(on[:, 1:129:2]),
              sig_ref.sigmoid_pw(base[:, 1:129:2]))
        _same(sig_ops.sigmoid_pw(on.reshape(-1)[1:]),
              sig_ref.sigmoid_pw(base.reshape(-1)[1:]))


def _signal_input(m, n, dtype, seed=8):
    """x * 4 with, where there are rows for them, a row of x <= -5 (scale
    1e-12, all zeros), a row holding a NaN and a row with +-inf."""
    x = torch.randn((m, n), generator=_gen(seed)) * 4
    if m >= 3:
        x[0] = -5.0 - x[0].abs()
        x[1, n // 2] = float("nan")
        x[2, 0], x[2, -1] = float("inf"), float("-inf")
    return x.to(dtype)


def _signal_chain(x, bits):
    """The two-call chain the signal route fuses, on the CPU."""
    from repro_torch.core import qat
    return qat.fake_quant_act(sig_ref.sigmoid_pw(x), bits, signed=False)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", [1, 100, 128])
@pytest.mark.parametrize("n", [1022, 61, 64, 7, 4096, 20000])
def test_sigmoid_pw_signal_bit_identical(cuda, dtype, m, n):
    """The signal route (one launch, counted as ``signal``) gives the bits
    of its plain version and of the CPU's two-call chain, for 8 and 4 bits,
    an all-negative row and a NaN row included; a rerun the same bits; the
    plain version on the card the CPU's bits too. N = 20000 streams its
    rows (longer than the 2048 vectors a block holds)."""
    assert (sig_k.signal_plan(m, n, dtype).held == 0) == (n == 20000)
    x = _signal_input(m, n, dtype)
    xc = x.to(cuda)
    with torch.no_grad():
        for bits in (8, 4):
            want = sig_ref.sigmoid_pw_signal(x, bits)
            _same(want, _signal_chain(x, bits))
            n0, v0 = sig_k.launches, dict(sig_k.launches_by_variant)
            got = sig_ops.sigmoid_pw_signal(xc, bits)
            assert sig_k.launches == n0 + 1
            assert sig_k.launches_by_variant == {
                "plain": v0["plain"], "signal": v0["signal"] + 1}
            _same(got, want)
            _same(sig_ops.sigmoid_pw_signal(xc, bits), got.cpu())
            _same(sig_ref.sigmoid_pw_signal(xc, bits), want)
            if m >= 3:
                assert not got[0].any() and torch.isnan(got[1]).all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_sigmoid_pw_signal_views(cuda, dtype):
    """A strided view is made contiguous; a contiguous view whose start is
    not 16-byte aligned takes the scalar accesses: the plain version's
    bits, one launch each."""
    base = _signal_input(100, 1030, dtype)
    on = base.to(cuda)
    with torch.no_grad():
        v0 = sig_k.launches_by_variant["signal"]
        _same(sig_ops.sigmoid_pw_signal(on[:, 3:1025], 8),
              sig_ref.sigmoid_pw_signal(base[:, 3:1025], 8))
        flat = on.reshape(-1)[1:1 + 100 * 1022].view(100, 1022)
        assert flat.is_contiguous() and flat.data_ptr() % 16
        _same(sig_ops.sigmoid_pw_signal(flat, 8), sig_ref.sigmoid_pw_signal(
            base.reshape(-1)[1:1 + 100 * 1022].view(100, 1022), 8))
        assert sig_k.launches_by_variant["signal"] == v0 + 2


def test_sigmoid_pw_signal_in_a_cuda_graph(cuda):
    """Captured once and replayed on new inputs in the fixed buffer: the
    eager call's bits; each replay adds the capture's one signal launch."""
    bufs = [_signal_input(100, 1022, torch.float32, seed=s).to(cuda)
            for s in (9, 10)]
    x = bufs[0].clone()
    out = torch.empty_like(x)
    gs = graphs.Graphs(cuda, capture=True)

    def work():
        out.copy_(sig_ops.sigmoid_pw_signal(x, 8))

    with torch.no_grad():
        for b in bufs:
            x.copy_(b)
            v0 = sig_k.launches_by_variant["signal"]
            gs.run("signal", work)
            torch.cuda.synchronize()
            assert sig_k.launches_by_variant["signal"] >= v0 + 1
            _same(out, sig_ops.sigmoid_pw_signal(b, 8).cpu())
        v0 = sig_k.launches_by_variant["signal"]
        gs.run("signal", work)
        assert sig_k.launches_by_variant["signal"] == v0 + 1
    assert gs.captures == {"signal": 1}


def test_sigmoid_pw_signal_rejects_what_the_kernel_does_not_take(cuda):
    with pytest.raises(ValueError):
        sig_k.sigmoid_pw_signal_cuda(torch.zeros((2, 4)), 8)
    with pytest.raises(ValueError):
        sig_k.sigmoid_pw_signal_cuda(
            torch.zeros((2, 4), dtype=torch.float16, device=cuda), 8)
    with pytest.raises(ValueError):
        sig_k.sigmoid_pw_signal_cuda(torch.zeros((2, 4), device=cuda), 0)
    with pytest.raises(ValueError, match="no gradient"):
        sig_ops.sigmoid_pw_signal(
            torch.zeros((2, 4), device=cuda, requires_grad=True), 8)


def test_sigmoid_pw_rejects_what_the_kernel_does_not_take(cuda):
    with pytest.raises(ValueError):
        sig_k.sigmoid_pw_cuda(torch.zeros(4))
    with pytest.raises(ValueError):
        sig_k.sigmoid_pw_cuda(torch.zeros(4, dtype=torch.float16, device=cuda))
    with pytest.raises(ValueError):
        sig_k.sigmoid_pw_bwd_cuda(torch.zeros(4, device=cuda),
                                  torch.zeros(5, device=cuda))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("m,k,n", [(8, 1536, 4099), (100, 1022, 10),
                                   (128, 1022, 61), (1, 1536, 4099),
                                   (9, 1536, 4099), (100, 1536, 1000),
                                   (8, 1000, 300), (8, 1022, 777),
                                   (37, 23, 64), (9, 100, 65),
                                   (8, 2560, 50304)])
def test_qmatmul(cuda, dtype, transposed, m, k, n):
    """The tied readout (8, 1536, V-like N), stablelm-3b's untied head
    (8, 2560, 50304) and the paper MLP's 8-bit heads; row-major and the
    transposed view (the container export's head), through the layout the plan
    picks (lanes along K for the view and for N <= 64, else along N). Edges:
    M = 1, 8, 9 and 100 (one, two and four 8-row tiles, and a grid over
    them), N not a multiple of any column tile, K not a multiple of 16, and
    a transposed view with K = 1022 (rows not 16-byte aligned)."""
    g = _gen(1)
    x = torch.randn((m, k), generator=g).to(dtype)
    if transposed:                       # the tied readout's q.T view
        w = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8).T
    else:
        w = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
    d, b = torch.rand(n, generator=g) * 0.01, torch.randn(n, generator=g)
    wc = w.to(cuda)
    assert wc.is_contiguous() != transposed
    layout = "k_lanes" if transposed or n <= 64 else "n_lanes"
    assert qmm_k.plan(m, k, n, *wc.stride(), dtype).layout == layout
    for delta, bias in ((d, b), (1.0, None)):
        ref = qmm_ops.qmatmul(x, w, delta, bias=bias)
        n0, l0 = qmm_k.launches, qmm_k.launches_by_layout[layout]
        got = qmm_ops.qmatmul(x.to(cuda), wc, _on(cuda, delta)[0]
                              if torch.is_tensor(delta) else delta,
                              bias=None if bias is None else bias.to(cuda))
        assert qmm_k.launches == n0 + 1
        assert qmm_k.launches_by_layout[layout] == l0 + 1
        _check(got, ref, dtype)
    got32 = qmm_ops.qmatmul(x.to(cuda), wc, d.to(cuda), bias=b.to(cuda),
                            out_dtype=torch.float32)
    _check(got32, qmm_ops.qmatmul(x, w, d, bias=b, out_dtype=torch.float32),
           dtype)


def _cache(g, b, s, kv, d, dtype, quantized):
    if quantized:
        k = torch.randint(-127, 128, (b, s, kv, d), generator=g,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, (b, s, kv, d), generator=g,
                          dtype=torch.int8)
        return k, v, torch.rand((b, s), generator=g) * 0.02, \
            torch.rand((b, s), generator=g) * 0.02
    return (torch.randn((b, s, kv, d), generator=g).to(dtype),
            torch.randn((b, s, kv, d), generator=g).to(dtype), None, None)


def _decode_lens(b, s, split_len):
    """Ragged lengths: an empty row, one key, split boundaries (the last
    key of a split, a whole split, one past it), the whole cache."""
    pat = [s, 0, 1, split_len, split_len + 1, 2 * split_len - 1, s - 1, 17]
    return torch.tensor([min(max(pat[i % len(pat)], 0), s) for i in range(b)],
                        dtype=torch.int32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("d,kv,grp,b,s", [(128, 2, 6, 6, 300),
                                          (64, 4, 1, 6, 300),
                                          (128, 2, 6, 1, 1),
                                          (128, 2, 6, 16, 512),
                                          (128, 2, 6, 8, 512),
                                          (64, 2, 6, 4, 2048),
                                          (256, 1, 4, 3, 77),
                                          (32, 2, 32, 2, 100),
                                          (80, 32, 1, 8, 512),
                                          (64, 32, 1, 8, 512),
                                          (128, 8, 4, 8, 512),
                                          (64, 6, 3, 3, 100),
                                          (80, 8, 5, 4, 300),
                                          (48, 2, 6, 3, 100),
                                          (16, 2, 3, 3, 77),
                                          (240, 1, 8, 2, 90)])
def test_attn_decode(cuda, dtype, quantized, d, kv, grp, b, s):
    """The split kernel and its merge: S not a multiple of the split
    length, S = 1, B = 1 and 16, lengths on split boundaries, an empty row
    (exact zeros); head dims that are not multiples of 32 (16, 48, 80,
    240: lanes past D idle), stablelm-3b's MHA (D = 80, G = 1), zamba2's
    (D = 64, G = 1), phi3.5-moe's G = 4 and a G = 3 (several KV heads a
    block), D = 80 at G = 5 (one); two runs give the same bits, and the
    log-sum-exp beside the output is the plain version's and leaves the
    output's bits as they are."""
    g = _gen(2)
    q = torch.randn((b, 1, kv * grp, d), generator=g).to(dtype)
    k, v, ks, vs = _cache(g, b, s, kv, d, dtype, quantized)
    split_len = dec_k.plan(b, s, kv, grp, d, k.dtype).split_len
    lens = _decode_lens(b, s, split_len)
    ref = dec_ops.attn_decode(q, k, v, lens, ks, vs)
    n0 = dec_k.launches
    args = _on(cuda, q, k, v, lens, ks, vs)
    got = dec_ops.attn_decode(*args)
    assert dec_k.launches == n0 + 1
    _check(got, ref, dtype)
    assert (got.cpu()[lens == 0] == 0).all()          # empty rows: zeros
    assert torch.equal(got, dec_ops.attn_decode(*args))
    o, lse = dec_ops.attn_decode(*args, with_lse=True)
    _, want = dec_ops.attn_decode(q, k, v, lens, ks, vs, with_lse=True)
    assert torch.equal(o, got)
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(lse.cpu()), fin)
    assert (lse.cpu()[fin] - want[fin]).abs().max() <= 1e-4


@pytest.mark.parametrize("quantized", [False, True])
def test_attn_decode_all_rows_empty(cuda, quantized):
    g = _gen(3)
    q = torch.randn((4, 1, 12, 128), generator=g).to(torch.bfloat16)
    k, v, ks, vs = _cache(g, 4, 96, 2, 128, torch.bfloat16, quantized)
    lens = torch.zeros(4, dtype=torch.int32)
    got = dec_ops.attn_decode(*_on(cuda, q, k, v, lens, ks, vs))
    assert torch.equal(got.cpu(), torch.zeros_like(q))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("t", [1, 8, 16, 70, 256])
@pytest.mark.parametrize("d,kv,grp", [(128, 2, 6), (64, 2, 6), (80, 4, 1),
                                      (80, 2, 5)])
def test_attn_prefill(cuda, dtype, quantized, t, d, kv, grp):
    """bf16 queries on the tensor-core kernel, fp32 on the CUDA-core one,
    with bf16/fp32 or int8 K/V and random [lo, hi) windows; batch row 0 has
    only empty windows (its tiles run no key block) and row 1 some: their
    outputs are exact zeros. D = 80 as stablelm-3b (MHA, G = 1) and at
    G = 5."""
    g = _gen(3)
    b = 3
    q = torch.randn((b, t, kv * grp, d), generator=g).to(dtype)
    k, v, ks, vs = _cache(g, b, t, kv, d, dtype, quantized)
    lo = torch.randint(0, t, (b, t), generator=g, dtype=torch.int32)
    hi = torch.clamp(lo + torch.randint(-5, 90, (b, t), generator=g,
                                        dtype=torch.int32), max=t)
    hi[0] = lo[0]                                     # all windows empty
    hi[1, :9] = lo[1, :9]                             # some windows empty
    ref = pf_ops.attn_prefill(q, k, v, hi, lo=lo, k_scale=ks, v_scale=vs)
    variant = "wgmma" if dtype == torch.bfloat16 else "simt"
    n0, v0 = pf_k.launches, pf_k.launches_by_variant[variant]
    got = pf_ops.attn_prefill(*_on(cuda, q, k, v, hi), lo=lo.to(cuda),
                              k_scale=None if ks is None else ks.to(cuda),
                              v_scale=None if vs is None else vs.to(cuda))
    assert pf_k.launches == n0 + 1
    assert pf_k.launches_by_variant[variant] == v0 + 1
    _check(got, ref, dtype)
    empty = (hi <= lo)
    assert (got.cpu()[empty] == 0).all()


@pytest.mark.parametrize("dtype,quantized", [(torch.bfloat16, False),
                                             (torch.bfloat16, True),
                                             (torch.float32, False)])
def test_attn_prefill_verify_shape(cuda, dtype, quantized):
    """Speculative verify: T = 5 queries of 8 slots against a 512-entry
    cache, hi = valid with the frontiers spread over the cache (row 0 at
    length 0, row 7 ending at the last entry) and row 1 without a valid
    key (exact zeros); bf16 on wgmma, fp32 on simt."""
    g = _gen(13)
    b, t, s, kv, grp, d = 8, 5, 512, 2, 6, 128
    q = torch.randn((b, t, kv * grp, d), generator=g).to(dtype)
    k, v, ks, vs = _cache(g, b, s, kv, d, dtype, quantized)
    lens = torch.tensor([0, 1, 37, 128, 200, 333, 480, s - t],
                        dtype=torch.int32)
    valid = torch.clamp(lens[:, None] + torch.arange(1, t + 1,
                                                     dtype=torch.int32),
                        max=s)
    valid[1] = 0
    ref = pf_ops.attn_prefill(q, k, v, valid, k_scale=ks, v_scale=vs)
    variant = "wgmma" if dtype == torch.bfloat16 else "simt"
    v0 = pf_k.launches_by_variant[variant]
    got = pf_ops.attn_prefill(*_on(cuda, q, k, v, valid),
                              k_scale=None if ks is None else ks.to(cuda),
                              v_scale=None if vs is None else vs.to(cuda))
    assert pf_k.launches_by_variant[variant] == v0 + 1
    _check(got, ref, dtype)
    assert (got.cpu()[1] == 0).all()


@pytest.mark.parametrize("dtype,quantized", [(torch.bfloat16, False),
                                             (torch.bfloat16, True),
                                             (torch.float32, False),
                                             (torch.float32, True)])
@pytest.mark.parametrize("shape", ["T16", "verify"])
def test_attn_prefill_lse(cuda, dtype, quantized, shape):
    """``with_lse``: both kernels write each query's log-sum-exp (wgmma from
    its final m and l; simt from them where S is not split, T = 16, and
    from its merge where it is, the verify shape), held against the plain
    version's within the file's tolerance x max|plain lse|, -inf exactly
    where a query sees no key; the output beside it the same bits as
    without it. Then the verify's S cut into two halves, each run alone on
    its clamped windows (rows past a half see nothing there) and merged by
    ``merge_lse``, as two ranks of a sequence-sharded cache are: within
    the file's tolerance of the whole call."""
    g = _gen(29)
    kv, grp, d = 2, 6, 128
    if shape == "verify":
        b, t, s = 8, 5, 512
        lens = torch.tensor([0, 1, 37, 128, 200, 333, 480, s - t],
                            dtype=torch.int32)
        hi = torch.clamp(lens[:, None] + torch.arange(1, t + 1,
                                                      dtype=torch.int32),
                         max=s)
        hi[1] = 0
    else:
        b, t = 3, 16
        s = t
        lens = torch.tensor([t, 1, t // 2 + 1], dtype=torch.int32)
        hi = torch.minimum(torch.arange(t, dtype=torch.int32)[None] + 1,
                           lens[:, None])
        hi[2, :4] = 0
    q = torch.randn((b, t, kv * grp, d), generator=g).to(dtype)
    k, v, ks, vs = _cache(g, b, s, kv, d, dtype, quantized)
    p = pf_k.plan(dtype, k.dtype, grp, d, b, t, kv, s)
    assert (p.variant == "simt" and p.splits > 1) == (
        dtype == torch.float32 and shape == "verify")
    ref, ref_lse = pf_ops.attn_prefill(q, k, v, hi, k_scale=ks, v_scale=vs,
                                       with_lse=True)
    args = _on(cuda, q, k, v, hi)
    scales = dict(k_scale=None if ks is None else ks.to(cuda),
                  v_scale=None if vs is None else vs.to(cuda))
    n0 = pf_k.launches
    got, lse = pf_ops.attn_prefill(*args, with_lse=True, **scales)
    assert pf_k.launches == n0 + 1 and lse.dtype == torch.float32
    assert torch.equal(got, pf_ops.attn_prefill(*args, **scales))
    _check(got, ref, dtype)
    fin = torch.isfinite(ref_lse)
    assert (~fin).any() and torch.equal(torch.isfinite(lse.cpu()), fin)
    assert (lse.cpu()[~fin] == float("-inf")).all()
    _check(lse[fin.to(cuda)], ref_lse[fin], dtype)
    if shape != "verify":
        return
    from repro_torch.kernels.attn_decode.ops import merge_lse
    half = s // 2
    parts = [pf_ops.attn_prefill(
        args[0], args[1][:, s0:s0 + half].contiguous(),
        args[2][:, s0:s0 + half].contiguous(),
        torch.clamp(args[3] - s0, 0, half), with_lse=True,
        **{n: None if x is None else x[:, s0:s0 + half].contiguous()
           for n, x in scales.items()}) for s0 in (0, half)]
    assert not torch.isfinite(parts[1][1][2]).any()     # row 2: none there

    def reduce(x, op):                  # the two halves as two ranks
        r = x.amax(0, keepdim=True) if op == "max" else x.sum(0, keepdim=True)
        return r.expand_as(x)
    out, mlse = merge_lse(torch.stack([o for o, _ in parts]),
                          torch.stack([l_ for _, l_ in parts]), reduce)
    _check(out[0], ref, dtype)
    _check(mlse[0][fin.to(cuda)], ref_lse[fin], dtype)
    assert (out[0].cpu()[hi <= 0] == 0).all()


def test_attn_prefill_refuses_what_no_kernel_takes(cuda):
    """Mixed bf16 / fp32, fp16 and a head_dim that is not a multiple of 16
    raise before a launch; bf16 queries at head_dim 32, which the
    tensor-core kernel once refused, agree with the plain version."""
    q = torch.zeros((1, 4, 2, 128), dtype=torch.bfloat16, device=cuda)
    kv32 = torch.zeros((1, 4, 1, 128), device=cuda)
    hi = torch.ones((1, 4), dtype=torch.int32, device=cuda)
    n0 = pf_k.launches
    with pytest.raises(ValueError):      # bf16 queries, fp32 K/V
        pf_ops.attn_prefill(q, kv32, kv32, hi)
    with pytest.raises(ValueError):      # fp16
        pf_ops.attn_prefill(q.half(), kv32.half(), kv32.half(), hi)
    with pytest.raises(ValueError):      # head_dim 72: not a multiple of 16
        pf_ops.attn_prefill(q[..., :72].contiguous(),
                            *(kv32[..., :72].to(torch.bfloat16),) * 2, hi)
    assert pf_k.launches == n0
    g = _gen(14)
    q32 = torch.randn((2, 40, 4, 32), generator=g).to(torch.bfloat16)
    k, v, _, _ = _cache(g, 2, 40, 2, 32, torch.bfloat16, False)
    hi = torch.minimum(torch.arange(40, dtype=torch.int32)[None] + 1,
                       torch.tensor([[40], [13]], dtype=torch.int32))
    _check(pf_ops.attn_prefill(*_on(cuda, q32, k, v, hi)),
           pf_ops.attn_prefill(q32, k, v, hi), torch.bfloat16)
    assert pf_k.launches_by_variant["wgmma"] >= 1


@pytest.mark.parametrize("dtype,quantized", [(torch.bfloat16, False),
                                             (torch.bfloat16, True),
                                             (torch.float32, False),
                                             (torch.float32, True)])
@pytest.mark.parametrize("d", range(16, 257, 16))
def test_attention_every_head_dim(cuda, d, dtype, quantized):
    """Every head_dim that is a multiple of 16 up to 256 runs both
    attention kernels (prefill: wgmma for bf16, simt for fp32; decode: the
    split and the merge) within the tolerance of the plain versions, with
    ragged windows and an empty row."""
    g = _gen(d)
    b, t, kv, grp = 3, 70, 2, 3
    q = torch.randn((b, t, kv * grp, d), generator=g).to(dtype)
    k, v, ks, vs = _cache(g, b, t, kv, d, dtype, quantized)
    lens = torch.tensor([t, 0, 33], dtype=torch.int32)
    hi = torch.minimum(torch.arange(t, dtype=torch.int32)[None] + 1,
                       lens[:, None])
    scales = dict(k_scale=None if ks is None else ks.to(cuda),
                  v_scale=None if vs is None else vs.to(cuda))
    got = pf_ops.attn_prefill(*_on(cuda, q, k, v, hi), **scales)
    ref = pf_ops.attn_prefill(q, k, v, hi, k_scale=ks, v_scale=vs)
    _check(got, ref, dtype)
    assert (got.cpu()[1] == 0).all()
    q1 = q[:, :1].contiguous()
    got = dec_ops.attn_decode(*_on(cuda, q1, k, v, lens, ks, vs))
    _check(got, dec_ops.attn_decode(q1, k, v, lens, ks, vs), dtype)
    assert (got.cpu()[1] == 0).all()


def _replayed(fn):
    """fn() recorded in a CUDA graph (after an eager warm-up on a side
    stream) and replayed once: the output tensor the graph writes."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    return out


# the q form's projections of qwen2-1.5b: (K, N, QKV bias)
Q_PROJ = [(1536, 1536, True), (1536, 256, True), (1536, 8960, False),
          (8960, 1536, False)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k,n,has_bias", Q_PROJ)
@pytest.mark.parametrize("m", [8, 16, 512, 2048])
def test_qmatmul_n_lanes_q_form(cuda, m, k, n, has_bias, dtype):
    """qmatmul's n_lanes at the q form's shapes: decode (M = 8, 16) and the
    prefill GEMM (512, 2048 rows), bf16 x and fp32 x (three bf16 planes),
    with and without the QKV bias, against the plain
    version; the variant is the one the plan gives, a rerun gives the same
    bits, and a replayed CUDA graph of the call gives them too (the K
    split's scratch comes from the graph's pool)."""
    g = _gen(m + k + n)
    x = torch.randn((m, k), generator=g).to(dtype)
    w = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
    d = torch.rand(n, generator=g) * 0.01
    b = torch.randn(n, generator=g) if has_bias else None
    variant = "decode" if m <= 16 else "prefill"
    p = qmm_k.plan(m, k, n, n, 1, dtype)
    assert (p.layout, p.variant) == ("n_lanes", variant)
    xc, wc, dc, bc = _on(cuda, x, w, d, b)
    for bias, bias_c in ((b, bc), (None, None)):
        ref = qmm_ops.qmatmul(x, w, d, bias=bias)
        n0, v0 = qmm_k.launches, qmm_k.launches_by_variant[variant]
        got = qmm_ops.qmatmul(xc, wc, dc, bias=bias_c)
        assert qmm_k.launches == n0 + 1
        assert qmm_k.launches_by_variant[variant] == v0 + 1
        _check(got, ref, dtype)
        assert torch.equal(got, qmm_ops.qmatmul(xc, wc, dc, bias=bias_c))
        assert torch.equal(got, _replayed(
            lambda: qmm_ops.qmatmul(xc, wc, dc, bias=bias_c)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [(8, 1000, 300), (17, 23, 100),
                                   (300, 1022, 777), (64, 1536, 4100),
                                   (9, 1536, 777), (130, 1001, 272)])
def test_qmatmul_n_lanes_unaligned(cuda, m, k, n, dtype):
    """n_lanes where W's rows or x's rows are not 16-byte aligned (K = 23,
    1001, 1022; N = 300, 777, 4100; odd N for the paired stores), or N and
    K end inside a tile (N = 272, K = 1001), in bf16 and fp32 x: the
    cp.async copies zero-fill a partial 16 bytes at the edge, and what
    they cannot copy (a strided W view, unaligned x rows) is read with
    plain loads."""
    g = _gen(k)
    x = torch.randn((m, k), generator=g).to(dtype)
    w = torch.randint(-127, 128, (k, 2 * n), generator=g, dtype=torch.int8)
    d = torch.rand(n, generator=g) * 0.01
    for wv in (w[:, :n].contiguous(), w[:, ::2]):
        assert qmm_k.plan(m, k, n, *wv.stride(), dtype).layout == "n_lanes"
        got = qmm_ops.qmatmul(x.to(cuda), wv.to(cuda) if wv.is_contiguous()
                              else w.to(cuda)[:, ::2], d.to(cuda))
        _check(got, qmm_ops.qmatmul(x, wv, d), dtype)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("d", range(16, 257, 16))
@pytest.mark.parametrize("shape", ["T16", "T64", "T256", "verify"])
def test_attn_prefill_fp32_tiled(cuda, shape, d, quantized):
    """The fp32 attn_prefill (simt) at the buckets T = S = 16, 64, 256
    with ragged lengths and at the verify shape (T = 5 against 512 keys,
    hi = valid, one row without a valid key) for every head_dim and fp32 /
    int8 K/V, S split across blocks wherever the plan finds too few (here
    every shape but T = 16): within 1e-4 x max|plain|, rows
    with an empty window exact zeros, a rerun the same bits, and a
    replayed CUDA graph of the call the same bits (the split's scratch
    comes from the graph's pool)."""
    g = _gen(d + len(shape))
    kv, grp = 2, 3
    if shape == "verify":
        b, t, s = 4, 5, 512
        lens = torch.tensor([0, 37, 480, s - t], dtype=torch.int32)
        hi = torch.clamp(lens[:, None] + torch.arange(1, t + 1,
                                                      dtype=torch.int32),
                         max=s)
        hi[1] = 0
    else:
        b, t = 3, int(shape[1:])
        s = t
        lens = torch.tensor([t, 1, t // 2 + 1], dtype=torch.int32)
        hi = torch.minimum(torch.arange(t, dtype=torch.int32)[None] + 1,
                           lens[:, None])
    q = torch.randn((b, t, kv * grp, d), generator=g)
    k, v, ks, vs = _cache(g, b, s, kv, d, torch.float32, quantized)
    p = pf_k.plan(torch.float32, k.dtype, grp, d, b, t, kv, s)
    blocks = b * kv * -(-(t * grp) // 64)
    assert p.variant == "simt"
    assert (p.splits > 1) == (blocks < 132 and s > p.key_block)
    ref = pf_ops.attn_prefill(q, k, v, hi, k_scale=ks, v_scale=vs)
    args = _on(cuda, q, k, v, hi)
    scales = dict(k_scale=None if ks is None else ks.to(cuda),
                  v_scale=None if vs is None else vs.to(cuda))
    v0, m0 = pf_k.launches_by_variant["simt"], pf_k.merges
    got = pf_ops.attn_prefill(*args, **scales)
    assert pf_k.launches_by_variant["simt"] == v0 + 1
    assert pf_k.merges == m0 + (p.splits > 1)
    _check(got, ref, torch.float32)
    assert (got.cpu()[hi <= 0] == 0).all()
    assert torch.equal(got, pf_ops.attn_prefill(*args, **scales))
    assert torch.equal(got, _replayed(
        lambda: pf_ops.attn_prefill(*args, **scales)))


def test_bucketed_prefill_mask(cuda):
    g = _gen(4)
    b, t = 4, 256
    q = torch.randn((b, t, 12, 128), generator=g).to(torch.bfloat16)
    k, v, _, _ = _cache(g, b, t, 2, 128, torch.bfloat16, False)
    lens = torch.tensor([1, 256, 100, 7], dtype=torch.int32)
    hi = torch.minimum(torch.arange(t, dtype=torch.int32)[None] + 1,
                       lens[:, None])
    _check(pf_ops.attn_prefill(*_on(cuda, q, k, v, hi)),
           pf_ops.attn_prefill(q, k, v, hi), torch.bfloat16)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((2, 20), device=cuda)
    with pytest.raises(ValueError):      # 3 container rows cannot hold K=20
        qmv_k.qmatvec_cuda(x, torch.zeros((3, 4), dtype=torch.int32,
                                          device=cuda),
                           torch.ones(4, device=cuda))
    with pytest.raises(ValueError):      # delta on the wrong device
        qmv_k.qmatvec_cuda(x, torch.zeros((2, 4), dtype=torch.int32,
                                          device=cuda), torch.ones(4))
    with pytest.raises(ValueError):      # head_dim 72 not a multiple of 16
        dec_k.attn_decode_cuda(
            torch.zeros((1, 1, 2, 72), device=cuda),
            torch.zeros((1, 4, 1, 72), device=cuda),
            torch.zeros((1, 4, 1, 72), device=cuda),
            torch.ones(1, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):      # CPU tensors never reach a kernel
        pf_k.attn_prefill_cuda(*(torch.zeros(1),) * 5)
    # head_dim 48, which the decode kernel once refused, agrees with the
    # plain version
    g = _gen(15)
    q = torch.randn((3, 1, 4, 48), generator=g)
    k, v, _, _ = _cache(g, 3, 40, 2, 48, torch.float32, False)
    lens = torch.tensor([40, 0, 7], dtype=torch.int32)
    _check(dec_ops.attn_decode(*_on(cuda, q, k, v, lens)),
           dec_ops.attn_decode(q, k, v, lens), torch.float32)


@pytest.mark.parametrize("kv_bits", [None, 8])
def test_engine_on_card_matches_cpu(cuda, kv_bits):
    """A small W3 qwen2-1.5b (head_dim 32) served on the card through the
    kernels gives the tokens the CPU plain paths give, fp32, T = 0."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.core import quant_dense
    from repro_torch.core.precision import W3A8
    from repro_torch.models import get_model
    from repro_torch.serving.engine import ServingEngine, generate
    cfg = reduced(get_config("qwen2-1.5b"), d_model=128, vocab=256)
    policy = dataclasses.replace(W3A8, act_bits=None)
    master = get_model(cfg).init(_gen(7), cfg)
    params = quant_dense.export_container(master, policy)
    prompts = [[1, 2, 3], list(range(5, 17)), [9] * 7, [4, 4]]
    outs = []
    for dev in ("cpu", cuda):
        eng = ServingEngine(params, cfg, policy=policy, slots=2, max_len=64,
                            dtype=torch.float32, kv_bits=kv_bits, device=dev)
        uid = {int(eng.submit(p, max_new=6)): i for i, p in enumerate(prompts)}
        outs.append({uid[r.uid]: r.out for r in eng.run_all()})
    assert outs[0] == outs[1]
    g = [generate(params, [[3, 1, 4, 1, 5]], cfg, policy=policy,
                  max_new_tokens=5, dtype=torch.float32, device=dev).cpu()
         for dev in ("cpu", cuda)]
    assert torch.equal(g[0], g[1])


def test_deployed_digit_forward_on_card_matches_cpu(cuda):
    """The paper's digit net at full width, exported to W3A8 containers and
    run with the PLAN sigmoid: each layer on the card (qmatvec or qmatmul,
    then sigmoid_pw) agrees with its plain version on the CPU fed the same
    input, within 1e-4 x max|plain| (the sigmoid and the 8-bit signal stage
    bit for bit); the W3A8 forward takes the signal route, the one without
    8-bit signals the elementwise sigmoid. End to end
    the card's classes agree with the CPU's on >= 98% of the rows, with and
    without the 8-bit signals: PLAN jumps by 1/256 at |x| = 2.375 and an
    8-bit signal can flip at a rounding tie, so logits are not compared
    end to end."""
    import dataclasses

    from repro_torch.core import quant_dense
    from repro_torch.core.precision import W3A8
    from repro_torch.models import dnn
    master = dnn.init(_gen(8), 784, (1022, 1022, 1022), 10)
    served = quant_dense.export_container(master, W3A8)
    x = torch.rand((100, 784), generator=_gen(9))
    on = {k: {kk: v.to(cuda) for kk, v in leaf.items()}
          for k, leaf in served.items()}
    no_a8 = dataclasses.replace(W3A8, act_bits=None)
    h = x.to(cuda)
    with torch.no_grad():
        for name in ("fc0", "fc1", "fc2", "head"):
            role = "output" if name == "head" else "hidden"
            y = quant_dense.apply(on[name], h, policy=no_a8, role=role)
            _check(y, quant_dense.apply(served[name], h.cpu(), policy=no_a8,
                                        role=role), torch.float32)
            if name != "head":
                h = sig_ops.sigmoid_pw(y)
                _same(h, sig_ref.sigmoid_pw(y.cpu()))
                # the 8-bit signal stage of the W3A8 forward, fed the same
                _same(sig_ops.sigmoid_pw_signal(y, 8),
                      _signal_chain(y.cpu(), 8))
        for policy, variant in ((no_a8, "plain"), (W3A8, "signal")):
            n0 = (qmv_k.launches, qmm_k.launches, sig_k.launches)
            v0 = dict(sig_k.launches_by_variant)
            got = dnn.forward(on, x.to(cuda), policy=policy, sigmoid_mode="pw")
            assert (qmv_k.launches, qmm_k.launches, sig_k.launches) == \
                (n0[0] + 3, n0[1] + 1, n0[2] + 3)
            assert sig_k.launches_by_variant == dict(
                v0, **{variant: v0[variant] + 3})
            ref = dnn.forward(served, x, policy=policy, sigmoid_mode="pw")
            agree = (got.cpu().argmax(-1) == ref.argmax(-1)).float().mean()
            assert agree >= 0.98


def test_packed_apply_kernel_on_card(cuda):
    """``packed_apply`` sends a 2-D CUDA input against 3-bit words to the
    qmatvec kernel and unpacks the 8-bit head; both agree with the CPU."""
    from repro_torch.core import quant_dense
    from repro_torch.core.precision import W3A8
    from repro_torch.models import dnn
    packed = quant_dense.export_packed(dnn.init(_gen(10), 784, (64,), 10),
                                       W3A8)
    x = torch.rand((100, 784), generator=_gen(11))
    for name, xin, launched in (("fc0", x, 1), ("head", torch.rand(
            (100, 64), generator=_gen(12)), 0)):
        leaf = {k: v.to(cuda) for k, v in packed[name]["w"].items()}
        n0 = qmv_k.launches
        got = quant_dense.packed_apply(leaf, xin.to(cuda))
        assert qmv_k.launches == n0 + launched
        _check(got, quant_dense.packed_apply(packed[name]["w"], xin),
               torch.float32)


@pytest.mark.parametrize("kv_bits", [None, 8])
def test_rollback_cache_on_card_matches_cpu(cuda, kv_bits):
    """``rollback_cache`` on CUDA tensors gives the CPU's cache: lengths
    rewound (out-of-range rows dropped, never past the current length),
    the wiped band zeroed, int8 scales too."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import api
    cfg = reduced(get_config("qwen2-1.5b"))
    cpu = api.init_cache(cfg, 4, 24, torch.float32, per_slot_len=True,
                         kv_bits=kv_bits, device="cpu")
    g = _gen(14)
    for name, t in cpu.items():
        if name == "len":
            t.copy_(torch.tensor([20, 7, 0, 24], dtype=torch.int32))
        elif t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=g))
        else:
            t.copy_(torch.rand(t.shape, generator=g) + 0.5)
    card = {n: t.to(cuda) for n, t in cpu.items()}
    slots, new = torch.tensor([0, 1, 9, 3]), torch.tensor([15, 9, 1, 19])
    want = api.rollback_cache(cfg, cpu, slots, new)
    got = api.rollback_cache(cfg, card, slots.to(cuda), new.to(cuda))
    assert want["len"].tolist() == [15, 7, 0, 19]
    for name in want:
        assert torch.equal(got[name].cpu(), want[name]), name


def test_spec_engine_on_card_matches_plain(cuda):
    """A small float qwen2-1.5b (head_dim 32) served speculatively on the
    card (its 3-bit export drafting, spec_k = 4, the kernels throughout)
    gives the tokens of the plain engine and of greedy generate, fp32,
    T = 0, with a float and an int8 KV cache."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.precision import FLOAT
    from repro_torch.models import get_model
    from repro_torch.serving.engine import ServingEngine, generate
    cfg = reduced(get_config("qwen2-1.5b"), d_model=128, vocab=256)
    master = get_model(cfg).init(_gen(15), cfg)
    prompts = [[1, 2, 3], list(range(5, 17)), [9] * 7, [4, 4], [7, 1, 7]]
    for kv_bits in (None, 8):
        outs = []
        for spec_k in (0, 4):
            eng = ServingEngine(master, cfg, policy=FLOAT, slots=2,
                                max_len=64, dtype=torch.float32,
                                kv_bits=kv_bits, spec_k=spec_k, device=cuda)
            uid = {int(eng.submit(p, max_new=9)): i
                   for i, p in enumerate(prompts)}
            outs.append({uid[r.uid]: r.out for r in eng.run_all()})
        assert outs[0] == outs[1] and eng.spec_drafted > 0
    n0 = pf_k.launches_by_variant["simt"]
    g = [generate(master, [[3, 1, 4, 1, 5]], cfg, policy=FLOAT,
                  max_new_tokens=9, dtype=torch.float32, spec_k=k,
                  device=cuda).cpu() for k in (0, 4)]
    assert torch.equal(g[0], g[1])
    assert pf_k.launches_by_variant["simt"] > n0     # the fp32 verify


# --- the engine's CUDA graphs -----------------------------------------------------

def _engine_case(case):
    """(cfg, params, engine kwargs) of a small qwen2-1.5b (head_dim 64, which
    the bf16 attn_prefill takes) served on the card: the W3A8 qp export in
    bf16 with a bf16 or an int8 KV cache, its q export (int8 levels) in
    bf16, or the float master in fp32."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import quant_dense
    from repro_torch.core.precision import FLOAT, W3A8
    from repro_torch.models import get_model
    cfg = reduced(get_config("qwen2-1.5b"), d_model=256, vocab=256)
    master = get_model(cfg).init(_gen(16), cfg)
    if case == "fp32":
        return cfg, master, dict(policy=FLOAT, dtype=torch.float32)
    if case == "q-bf16kv":           # int8 levels: qmatmul n_lanes
        return cfg, quant_dense.export_levels(master, W3A8), dict(
            policy=W3A8, dtype=torch.bfloat16)
    return cfg, quant_dense.export_container(master, W3A8), dict(
        policy=W3A8, dtype=torch.bfloat16,
        kv_bits=8 if case == "qp-int8kv" else None)


CARD_PROMPTS = [[1, 2, 3], list(range(5, 17)), [9] * 7, [4, 4], [7, 1, 7],
                list(range(30, 50))]


def _card_serve(eng, max_new=9):
    uid = {int(eng.submit(p, max_new=max_new)): i
           for i, p in enumerate(CARD_PROMPTS)}
    return {uid[r.uid]: (r.status, r.out) for r in eng.run_all()}


def _launch_counts():
    return graphs.read_counters()


@pytest.mark.parametrize("case", ["qp-bf16kv", "qp-int8kv", "q-bf16kv",
                                  "fp32"])
def test_captured_engine_matches_eager(cuda, case):
    """The engine on the card captures its tick once and each admission
    bucket once (buckets 8, 16, 32 here) and serves the tokens of the same
    engine with capture=False, T = 0; a second serve is replay only (no
    capture) and moves every launch counter, by kernel and variant, as far
    as the eager engine's second serve moves it."""
    from repro_torch.serving.engine import ServingEngine
    cfg, params, kw = _engine_case(case)
    engines = [ServingEngine(params, cfg, slots=3, max_len=64, device=cuda,
                             capture=c, **kw) for c in (True, False)]
    first = [_card_serve(e) for e in engines]
    assert first[0] == first[1]
    assert engines[0].captures == {"tick": 1, "admit": {8: 1, 16: 1, 32: 1}}
    assert engines[1].captures == {"tick": 0, "admit": {}}
    moved = []
    for e in engines:
        before = _launch_counts()
        assert _card_serve(e) == first[0]
        torch.cuda.synchronize()
        moved.append(graphs._diff(_launch_counts(), before))
    assert moved[0] == moved[1]
    assert engines[0].captures == {"tick": 1, "admit": {8: 1, 16: 1, 32: 1}}
    assert any(v for k, v in moved[0].items() if k[1] == "launches")


def test_captured_spec_engine_matches_greedy(cuda):
    """The captured fp32 spec engine (spec_k = 4, the float master verifying
    its 3-bit export) serves every request greedy generate's tokens and the
    eager spec engine's, with one tick capture."""
    from repro_torch.serving.engine import ServingEngine, generate
    cfg, master, kw = _engine_case("fp32")
    outs = []
    for capture in (True, False):
        eng = ServingEngine(master, cfg, slots=3, max_len=64, spec_k=4,
                            device=cuda, capture=capture, **kw)
        outs.append(_card_serve(eng))
        assert eng.spec_drafted > 0
        if capture:
            assert eng.captures["tick"] == 1
            assert set(eng.captures["admit"]) <= {8, 16, 32}
    assert outs[0] == outs[1]
    for i, p in enumerate(CARD_PROMPTS):
        g = generate(master, [p], cfg, max_new_tokens=9, device=cuda,
                     **kw).cpu()
        assert outs[0][i] == ("ok", g[0, len(p):].tolist()), i


@pytest.mark.parametrize("spec_k", [0, 4])
def test_captured_quarantine_matches_eager(cuda, spec_k):
    """A FaultPlan NaN in one slot under capture: that request finishes
    "poisoned", the others are served, with the eager engine's statuses,
    tokens and poisoned_count."""
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.resilience import FaultPlan
    cfg, params, kw = _engine_case("fp32" if spec_k else "qp-bf16kv")
    outs = []
    for capture in (True, False):
        eng = ServingEngine(params, cfg, slots=3, max_len=64, spec_k=spec_k,
                            fault_plan=FaultPlan(nan_logits=[(1, 1)]),
                            device=cuda, capture=capture, **kw)
        outs.append((_card_serve(eng), eng.poisoned_count))
    assert outs[0] == outs[1]
    statuses = [s for s, _ in outs[0][0].values()]
    assert statuses.count("poisoned") == 1 == outs[0][1]
    assert statuses.count("ok") == len(CARD_PROMPTS) - 1


@pytest.mark.parametrize("spec_k", [0, 4])
def test_captured_sampling_matches_eager(cuda, spec_k):
    """At T > 0 the captured engine (its generator registered with the
    graphs, restored after the warm-ups) samples the eager engine's stream
    from the same seed."""
    from repro_torch.serving.engine import ServingEngine
    cfg, params, kw = _engine_case("fp32" if spec_k else "qp-bf16kv")
    outs = [_card_serve(ServingEngine(
        params, cfg, slots=3, max_len=64, spec_k=spec_k, temperature=0.9,
        seed=5, device=cuda, capture=capture, **kw)) for capture in
        (True, False)]
    assert outs[0] == outs[1]


@pytest.mark.parametrize("mode", ["float", "w3a8"])
def test_captured_training_matches_eager(cuda, mode):
    """The paper MLP's training step (forward, gradients, in-place momentum
    update) and evaluation forward, each captured once for its batch shape,
    train the eager step's parameters bit for bit, with its losses and
    MCR; float and STE retraining with 8-bit signals."""
    from repro_torch.core.precision import FLOAT, W3A8
    from repro_torch.core.treeutil import flatten_with_path
    from repro_torch.data import synthetic
    from repro_torch.models import dnn
    from repro_torch.paper import pipeline
    task = synthetic.digit_task(n_train=1000, n_test=500)
    init = dnn.init(torch.Generator(device=cuda).manual_seed(17), 784,
                    (1022, 1022), 10, device=cuda)
    policy = FLOAT if mode == "float" else W3A8
    runs = [pipeline.train_mlp(init, task, policy=policy, epochs=2,
                               batch=100, lr=0.1, momentum=0.9, capture=c)
            for c in (True, False)]
    (p1, s1), (p0, s0) = runs
    assert (s1["captures"], s0["captures"]) == (1, 0)
    assert s1["final_loss"] == s0["final_loss"]
    for path, v in flatten_with_path(p0).items():
        assert torch.equal(flatten_with_path(p1)[path], v), path
    assert pipeline.evaluate(p1, task, policy=policy) == \
        pipeline.evaluate(p1, task, policy=policy, capture=False)


# --- overload hardening and durability under capture ------------------------------

def _tick_state(eng):
    """Every tensor a tick writes (restored after a replay under kept())."""
    return [eng._tokens, eng._active, eng._emitted, eng._budget, eng._rec,
            *eng.cache.values()]


def test_flip_and_heal_reach_the_captured_tick(cuda):
    """A bit flipped in place in a qp container reaches the replayed tick:
    the same replay on the same state writes other K/V after the flip (in
    layer 1, which reads layer 0's flipped down projection), the probe
    names the leaf, and after the in-place heal from the golden copy the
    replay writes the clean K/V bit for bit — with the tick captured
    once."""
    from repro_torch.core.treeutil import tree_write_
    from repro_torch.serving.engine import ServingEngine
    cfg, params, kw = _engine_case("qp-bf16kv")
    eng = ServingEngine(params, cfg, slots=3, max_len=64, device=cuda,
                        capture=True, integrity_every=10_000, **kw)
    for p in CARD_PROMPTS[:3]:
        eng.submit(p, max_new=20)
    for _ in range(3):
        eng.step()
    path = "layers/mlp/down/qp"
    kp, n = eng.params["layers"]["mlp"]["down"]["qp"].shape[1:]
    bit = ((0 * kp + 5) * n + 7) * 32 + 3 * 3 + 2   # a field's sign bit

    def replay():
        with graphs.kept(*_tick_state(eng)):
            eng._call_tick()
            return torch.stack([eng.cache["k"], eng.cache["v"]])
    clean = replay()
    assert torch.equal(replay(), clean)
    eng._flip_bit(path, bit)
    flipped = replay()
    assert torch.equal(flipped[:, 0], clean[:, 0])      # layer 0's K/V
    assert not torch.equal(flipped, clean)
    bad = eng._run_probe() != eng._golden_fp
    assert [p for p, b in zip(eng._probe_paths, bad) if b] == [path]
    tree_write_(eng.params, path, eng._golden[path])
    assert torch.equal(replay(), clean)
    assert (eng._run_probe() == eng._golden_fp).all()
    assert eng.captures["tick"] == 1 and eng.captures["probe"] == 1


def test_ladder_recaptures_on_card(cuda):
    """FaultPlan tick failures walk the fp32 spec engine down the ladder on
    the card: spec -> plain at tick 2, kernels -> plain versions at tick 5.
    Each step drops the graphs and the next call captures again; the four
    serving kernels launched before tick 5 and no plain version did; after
    it only plain versions run. Tokens equal the eager twin's and greedy's,
    with the same fallback_events."""
    from repro_torch.serving.engine import ServingEngine, generate
    from repro_torch.serving.resilience import FaultPlan
    cfg, master, kw = _engine_case("fp32")
    outs = []
    for capture in (True, False):
        eng = ServingEngine(master, cfg, slots=3, max_len=64, spec_k=4,
                            fault_plan=FaultPlan(fail_ticks=[2, 5]),
                            device=cuda, capture=capture, **kw)
        uid = {int(eng.submit(p, max_new=9)): i
               for i, p in enumerate(CARD_PROMPTS)}
        before = _launch_counts()
        done = []
        while eng.decode_calls < 5:
            eng.step()
            done += eng.drain()
        torch.cuda.synchronize()
        at_step = _launch_counts()
        caps = dict(eng.captures)
        done += eng.run_all()
        torch.cuda.synchronize()
        outs.append(({uid[r.uid]: (r.status, r.out) for r in done},
                     eng.fallback_events))
        early = graphs._diff(at_step, before)
        kernels = {k[0].split(".")[2] for k in early if k[1] == "launches"}
        assert kernels == {"qmatvec", "qmatmul", "attn_decode",
                           "attn_prefill"}
        assert not [k for k in early if k[1] == "calls"], early
        late = graphs._diff(_launch_counts(), at_step)
        assert late and all(k[1] == "calls" for k in late), late
        if capture:
            assert caps["tick"] == 2 and eng.captures["tick"] == 3
    assert outs[0] == outs[1]
    assert outs[0][1] == [(2, "spec->plain"), (5, "kernel->fallback")]
    for i, p in enumerate(CARD_PROMPTS):
        g = generate(master, [p], cfg, max_new_tokens=9, device=cuda,
                     **kw).cpu()
        assert outs[0][0][i] == ("ok", g[0, len(p):].tolist()), i


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_snapshot_restores_into_a_captured_engine(cuda, tmp_path,
                                                  temperature):
    """A snapshot restored into a captured engine whose graphs are already
    captured (its generator registered with them) continues as the donor
    did, at T = 0 and at T > 0: the caches, the per-slot vectors and the
    generator state are written in place, where the graphs read them."""
    from repro_torch.serving.engine import ServingEngine
    cfg, params, kw = _engine_case("qp-bf16kv")

    def make():
        return ServingEngine(params, cfg, slots=3, max_len=64, device=cuda,
                             capture=True, temperature=temperature, seed=3,
                             **kw)
    donor = make()
    for p in CARD_PROMPTS:
        donor.submit(p, max_new=12)
    for _ in range(4):
        donor.step()
    donor.snapshot(str(tmp_path / "s"))
    mid = {r.uid: r.out for r in donor.drain()}
    want = {**mid, **{r.uid: r.out for r in donor.run_all()}}
    fresh = make()
    _card_serve(fresh)                       # graphs captured, generator used
    caps = dict(fresh.captures)
    fresh.restore(str(tmp_path / "s"))
    got = {**mid, **{r.uid: r.out for r in fresh.run_all()}}
    assert got == want
    assert fresh.captures["tick"] == caps["tick"] == 1


# --- the MoE family and the sliding-window ring -------------------------------

# expert products (M, K, N): phi3.5-moe's at a tick's capacity (M = 1) and
# an admission's (80), mixtral-8x22b's at a tick's (2), its solo prompt's
# (1406) and its 4096 bucket's (10240), up / gate and down
MOE_EXPERTS = ([(m, k, n) for m in (1, 80)
                for k, n in ((4096, 6400), (6400, 4096))]
               + [(m, k, n) for m in (2, 1406, 10240)
                  for k, n in ((6144, 16384), (16384, 6144))])


@pytest.mark.parametrize("m,k,n", MOE_EXPERTS)
def test_moe_expert_products(cuda, m, k, n):
    """Every expert product shape of phi3.5-moe and mixtral-8x22b in bf16:
    one row-major int8 expert (a contiguous ``q[e]`` view of the stack)
    with the per-layer delta, in qmatmul's n_lanes, in the variant its plan
    gives for the capacity M, against the plain version on the card."""
    from repro_torch.kernels.qmatmul.ref import qmatmul_ref
    g = torch.Generator(device=cuda).manual_seed(m + k)
    stack = torch.randint(-3, 4, (2, k, n), generator=g, device=cuda,
                          dtype=torch.int8)
    w = stack[1]
    d = torch.rand((1, 1, n), generator=g, device=cuda) * 0.05
    x = torch.randn((m, k), generator=g, device=cuda).to(torch.bfloat16)
    variant = "decode" if m <= 16 else "prefill"
    assert qmm_k.plan(m, k, n, *w.stride(), torch.bfloat16).variant == variant
    v0 = qmm_k.launches_by_variant[variant]
    got = qmm_ops.qmatmul(x, w, d.expand(2, 1, n)[1].reshape(-1))
    assert qmm_k.launches_by_variant[variant] == v0 + 1
    _check(got, qmatmul_ref(x, w, d.reshape(-1)).cpu(), torch.bfloat16)


@pytest.mark.parametrize("m,k,n", [(8, 4096, 16), (8, 6144, 8),
                                   (16, 4096, 16), (512, 4096, 16),
                                   (32768, 6144, 8), (3, 64, 4),
                                   (100, 1022, 10), (128, 1022, 61)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_router(cuda, m, k, n, dtype):
    """The MoE routers: (d, E) row-major int8 levels, E <= 64 columns,
    fp32 logits, in qmatmul's row-major k_lanes kernel, at a tick's M = 8
    and 16, an admission round's 512 rows, the 4096 bucket's 32768 rows
    and a reduced model's shape; and the MLP's digit (N = 10) and phoneme
    (N = 61) heads on the same route. Reruns give the same bits (the K
    split's sums meet in a fixed order)."""
    from repro_torch.kernels.qmatmul.ref import qmatmul_ref
    g = torch.Generator(device=cuda).manual_seed(m + n)
    w = torch.randint(-127, 128, (k, n), generator=g, device=cuda,
                      dtype=torch.int8)
    d = torch.rand(n, generator=g, device=cuda) * 0.01
    x = torch.randn((m, k), generator=g, device=cuda).to(dtype)
    o0 = qmm_k.launches_by_orientation["row_major"]
    got = qmm_ops.qmatmul(x, w, d, out_dtype=torch.float32)
    assert qmm_k.launches_by_orientation["row_major"] == o0 + 1
    _check(got, qmatmul_ref(x, w, d, out_dtype=torch.float32).cpu(),
           torch.float32)
    assert torch.equal(got, qmm_ops.qmatmul(x, w, d, out_dtype=torch.float32))


@pytest.mark.parametrize("t,window,dtype", [(4500, 4096, torch.bfloat16),
                                            (300, 64, torch.float32),
                                            (300, 64, torch.bfloat16)])
def test_windowed_attn_prefill(cuda, t, window, dtype):
    """mixtral's solo prefill attention (B = 1, T = S, KV = 8, G = 6,
    D = 128), query t seeing max(t - window + 1, 0) <= p <= t, against the
    plain version on the card, and the model-level window through
    ``prefill_attention`` in the kernel mode."""
    from repro_torch.kernels.attn_decode.ref import scale_q
    from repro_torch.kernels.attn_prefill.ref import attn_prefill_ref
    from repro_torch.models.attention import prefill_attention
    g = torch.Generator(device=cuda).manual_seed(t)
    q = torch.randn((1, t, 48, 128), generator=g, device=cuda).to(dtype)
    k, v = (torch.randn((1, t, 8, 128), generator=g, device=cuda).to(dtype)
            for _ in range(2))
    pos = torch.arange(t, dtype=torch.int32, device=cuda)
    hi, lo = (pos + 1)[None], torch.clamp(pos - (window - 1), min=0)[None]
    got = pf_ops.attn_prefill(q, k, v, hi, lo=lo)
    qg = scale_q(q, 128 ** -0.5).reshape(1, t, 8, 6, 128)
    ref = attn_prefill_ref(qg, k, v, lo, hi).reshape(1, t, 48, 128)
    _check(got, ref.cpu(), dtype)
    assert torch.equal(got, prefill_attention(q, k, v, window=window,
                                              mode="kernel"))


def test_attn_decode_full_ring(cuda):
    """attn_decode over a full 4096-slot ring (every row valid = S), B = 8,
    KV = 8, G = 6, D = 128, bf16."""
    from repro_torch.kernels.attn_decode.ref import attn_decode_ref
    g = torch.Generator(device=cuda).manual_seed(4096)
    q = torch.randn((8, 1, 48, 128), generator=g, device=cuda).to(
        torch.bfloat16)
    k, v = (torch.randn((8, 4096, 8, 128), generator=g, device=cuda).to(
        torch.bfloat16) for _ in range(2))
    lens = torch.full((8,), 4096, dtype=torch.int32, device=cuda)
    _check(dec_ops.attn_decode(q, k, v, lens),
           attn_decode_ref(q, k, v, lens).cpu(), torch.bfloat16)


def _moe_model(arch, form="qp", d_model=128):
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.core import quant_dense
    from repro_torch.core.precision import W3A8
    from repro_torch.models import get_model
    cfg = reduced(get_config(arch), d_model=d_model, vocab=256)
    policy = dataclasses.replace(W3A8, act_bits=None)
    master = get_model(cfg).init(_gen(20), cfg)
    export = {"q": quant_dense.export_levels,
              "qp": quant_dense.export_container}[form]
    return cfg, export(master, policy), policy


@pytest.mark.parametrize("tokens", [(3, 7), (2, 512)])
@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "mixtral-8x22b"])
def test_moe_apply_kernel_matches_plain(cuda, arch, tokens):
    """One MoE layer at reduced width on the card, fp32: the kernel path
    (router in the row-major k_lanes, each expert in n_lanes) routes every
    token as the plain path does and its output agrees within 1e-4 x
    max|plain|, in one group (21 tokens) and in two (1024)."""
    from repro_torch.models import moe
    from repro_torch.models.transformer import _layer
    cfg, params, policy = _moe_model(arch)
    lp = _layer(params["layers"]["moe"], 0)
    lp = {k: {n: t.to(cuda) for n, t in v.items()} for k, v in lp.items()}
    x = torch.randn(tokens + (cfg.d_model,), generator=_gen(3)).to(cuda)
    outs, traces = [], []
    for mode in ("kernel", "dequant"):
        with moe.trace_routing() as trace:
            outs.append(moe.moe_apply(lp, x, cfg, policy=policy,
                                      matmul_mode=mode)[0])
        traces.append(trace[0])
    assert torch.equal(traces[0]["top_i"], traces[1]["top_i"])
    assert torch.equal(traces[0]["keep"], traces[1]["keep"])
    _check(outs[0], outs[1].cpu(), torch.float32)


def test_mixtral_ring_engine_captured_matches_eager(cuda):
    """A reduced mixtral (window 32, max_len 64: a 32-slot ring) served on
    the card from its qp export in bf16: a prompt past the ring is
    admitted solo (an eager prefill between replayed ticks), bucketed rows
    decode past slot 31, and the captured engine serves the tokens of its
    capture=False twin."""
    from repro_torch.serving.engine import ServingEngine
    cfg, params, policy = _moe_model("mixtral-8x22b")
    prompts = [[1, 2, 3], list(range(5, 30)), list(range(40, 80)), [9] * 7]
    outs, solos = [], []
    for capture in (True, False):
        eng = ServingEngine(params, cfg, policy=policy, slots=3, max_len=64,
                            dtype=torch.bfloat16, capture=capture,
                            device=cuda)
        solo = eng._admit_solo
        n = []
        eng._admit_solo = lambda s, r: (n.append(1), solo(s, r))
        uid = {int(eng.submit(p, max_new=14)): i for i, p in enumerate(prompts)}
        outs.append({uid[r.uid]: r.out for r in eng.run_all()})
        solos.append(len(n))
        assert int(eng.cache["len"].max()) > 32
    assert outs[0] == outs[1] and solos == [1, 1]
    assert all(len(o) == 14 for o in outs[0].values())


@pytest.mark.parametrize("kernel,m,k,n", [
    ("qmatvec", 512, 6144, 1024), ("qmatvec", 2, 6144, 6144),
    ("n_lanes", 512, 16384, 1024), ("n_lanes", 2, 16384, 6144),
    ("k_lanes", 8, 6144, 4096), ("row_major", 8, 6144, 8),
    ("row_major", 32768, 6144, 8), ("row_major", 100, 1022, 10)])
def test_fp32_x_sums_keep_fp32_precision(cuda, kernel, m, k, n):
    """fp32 x on the tensor cores (three bf16 planes) at a long K: the sum
    is promoted to an fp32 total on the CUDA cores every run of K, so the
    output stays within 3e-6 x max|out| of a float64 product (unpromoted,
    mma.sync's truncating accumulator gave 1e-5 to 3e-5 at these K), in
    qmatvec, qmatmul's n_lanes (decode and prefill), its K-major k_lanes
    and its row-major k_lanes (the MoE routers and the digit head)."""
    g = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn((m, k), generator=g, device=cuda)
    delta = torch.rand(n, generator=g, device=cuda) * 0.05 + 0.01
    lv = torch.randint(-4 if kernel == "qmatvec" else -127,
                       4 if kernel == "qmatvec" else 128, (k, n),
                       generator=g, device=cuda, dtype=torch.int8)
    if kernel == "qmatvec":
        out = qmv_ops.qmatvec(x, pack_matrix(lv, 3), delta, k=k)
    else:
        w = lv if kernel in ("n_lanes", "row_major") else lv.T.contiguous().T
        p = qmm_k.plan(m, k, n, *w.stride(), x.dtype)
        assert (p.orientation if kernel == "row_major" else p.layout) \
            == kernel
        out = qmm_ops.qmatmul(x, w, delta)
    ref = x.double() @ (lv.double() * delta.double())
    err = float((out.double() - ref).abs().max() / ref.abs().max())
    assert err <= 3e-6, err


@pytest.mark.parametrize("kernel,m,k,n", [
    ("qmatvec", 512, 16384, 1024), ("n_lanes", 512, 16384, 1024),
    ("n_lanes", 2, 16384, 6144), ("k_lanes", 8, 16384, 4096),
    ("row_major", 8, 6144, 8), ("row_major", 32768, 6144, 8),
    ("row_major", 8, 4096, 16)])
def test_bf16_x_sums_keep_fp32_precision(cuda, kernel, m, k, n):
    """bf16 x at K = 16384 with an fp32 output: the mma sums are promoted
    into an fp32 total as for fp32 x, so the output stays within 1e-6 x
    max|out| of a float64 product, as an fp32 matmul of the same bf16 x
    does (unpromoted: 2.3e-6 in qmatvec prefill, 1.8e-5 in n_lanes prefill
    and 2.1e-5 in the K-major k_lanes); the row-major k_lanes (the MoE
    routers) the same."""
    g = torch.Generator(device=cuda).manual_seed(12)
    x = torch.randn((m, k), generator=g, device=cuda).to(torch.bfloat16)
    delta = torch.rand(n, generator=g, device=cuda) * 0.05 + 0.01
    lv = torch.randint(-4 if kernel == "qmatvec" else -127,
                       4 if kernel == "qmatvec" else 128, (k, n),
                       generator=g, device=cuda, dtype=torch.int8)
    f32 = torch.float32
    if kernel == "qmatvec":
        out = qmv_ops.qmatvec(x, pack_matrix(lv, 3), delta, k=k,
                              out_dtype=f32)
    else:
        w = lv if kernel in ("n_lanes", "row_major") else lv.T.contiguous().T
        p = qmm_k.plan(m, k, n, *w.stride(), x.dtype)
        assert (p.orientation if kernel == "row_major" else p.layout) \
            == kernel
        out = qmm_ops.qmatmul(x, w, delta, out_dtype=f32)
    ref = x.double() @ (lv.double() * delta.double())
    err = float((out.double() - ref).abs().max() / ref.abs().max())
    assert err <= 1e-6, err


def test_mixtral_ring_kernel_path_matches_plain(cuda):
    """A reduced mixtral (window 32) on the card in fp32: two unpadded
    64-token prompts (the windowed prefill, kept and rolled into the
    32-slot ring) and 4 decode steps past the wrap, through the kernels
    and through the plain versions: the same routing at every MoE call
    and logits within 1e-4 x max|plain| at every step."""
    from repro_torch.models import api, moe
    from repro_torch.serving.engine import _to_device
    cfg, params, policy = _moe_model("mixtral-8x22b")
    params = _to_device(params, cuda)
    toks = (torch.arange(128, dtype=torch.int32).reshape(2, 64) * 7 % 255
            + 1).to(cuda)
    outs, traces, feed = [], [], []
    for mm, am in (("kernel", "kernel"), ("dequant", "ref")):
        kw = dict(policy=policy, dtype=torch.float32, matmul_mode=mm,
                  attn_mode=am)
        with moe.trace_routing() as trace:
            logits, cache = api.prefill(params, {"tokens": toks}, cfg,
                                        max_len=128, **kw)
            steps = [logits[:, -1]]
            for i in range(4):
                if len(feed) <= i:
                    feed.append(steps[-1].argmax(-1).to(torch.int32)[:, None])
                logits, cache = api.decode_step(params, cache, feed[i], cfg,
                                                **kw)
                steps.append(logits[:, -1])
        outs.append(torch.stack(steps))
        traces.append(list(trace))
    assert cache["k"].shape[2] == 32 and len(traces[0]) == 5 * cfg.num_layers
    for rk, rp in zip(*traces):
        assert torch.equal(rk["top_i"], rp["top_i"])
        assert torch.equal(rk["keep"], rp["keep"])
    _check(outs[0], outs[1].cpu(), torch.float32)


@pytest.mark.parametrize("shape,block", [((2, 4, 512, 2048), 4 * 512 * 1024),
                                         ((2, 2, 4500, 1536), 9000 * 768)])
def test_quantize_leaf_chunked_on_card(cuda, shape, block, monkeypatch):
    """On the card too, a stacked leaf quantised by stacked index and block
    of output columns gives the levels and deltas of fitting the whole
    leaf at once, bit for bit (each column's delta is its own)."""
    from repro_torch.core import quant_dense
    from repro_torch.core.quantizer import QuantSpec, _optimal_delta_rows
    monkeypatch.setattr(quant_dense, "_FIT_BLOCK", block)
    spec = QuantSpec(bits=3)
    g = torch.Generator(device=cuda).manual_seed(9)
    leaf = torch.randn(shape, generator=g, device=cuda) * 0.05
    flat = leaf.reshape(shape[0], -1, shape[-1])
    d = _optimal_delta_rows(flat.transpose(1, 2).reshape(-1, flat.shape[1]),
                            3, spec.iters).reshape(shape[0], 1, -1)
    q = torch.clamp(torch.round(flat / torch.clamp(d, min=1e-12)), -3, 3)
    part = quant_dense._quantize_leaf(leaf, spec, 1)
    assert torch.equal(part[0], q.to(torch.int8).reshape(shape))
    assert torch.equal(part[1], d.reshape(shape[0], 1, 1, shape[-1]))


def test_device_ms_by_kernel_equals_key_averages(cuda):
    """``profile_engine.device_ms_by_kernel`` reads the trace's CUDA events
    without ``key_averages()``: the same ms by kernel as the CUDA-type
    rows of ``key_averages()`` give, a port kernel and a library one."""
    from repro_torch.launch.profile_engine import (KERNELS,
                                                   device_ms_by_kernel)
    g = _gen(3)
    x = torch.randn((8, 1536), generator=g).to(cuda, torch.bfloat16)
    w = pack_matrix(torch.randint(-3, 4, (1536, 512), generator=g,
                                  dtype=torch.int8), 3).to(cuda)
    d = (torch.rand(512, generator=g) * 0.1).to(cuda)
    qmv_ops.qmatvec(x, w, d, k=1536)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            qmv_ops.qmatvec(x, w, d, k=1536)
            x @ x.T
        torch.cuda.synchronize()
    want = dict.fromkeys(KERNELS + ("other",), 0.0)
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            name = next((k for k in KERNELS if f"{k}_kernel" in ev.key),
                        "other")
            want[name] += ev.self_device_time_total / 1e3
    got = device_ms_by_kernel(prof)
    assert got.keys() == want.keys()
    for name, ms in want.items():
        assert got[name] == pytest.approx(ms, rel=1e-9, abs=1e-9), name
    assert got["qmatvec"] > 0 and got["other"] > 0


def test_init_export_layer_by_layer_on_card(cuda):
    """The layer-wise build of a config whose fp32 layer is 1.95 GB
    (qwen3-32b at full width, 4 of its 64 layers) on the card: its peak
    above what was allocated before stays under its export, two fp32
    layers, the fp32 embedding and 1 GB, and the export is bit-identical
    to export_container(init(...)) from a generator in the same state."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.treeutil import flatten_with_path
    from repro_torch.launch.serve import export_qp
    from repro_torch.models import api, get_model

    def nbytes(tree):
        return sum(t.numel() * t.element_size()
                   for t in flatten_with_path(tree).values())
    cfg = dataclasses.replace(get_config("qwen3-32b"), num_layers=4)
    shapes = get_model(cfg).init(torch.Generator(), cfg, device="meta")
    layer = nbytes(shapes["layers"]) / cfg.num_layers
    embed = nbytes(shapes["embed"])
    assert layer > 1.9e9
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    built = api.init_export(torch.Generator(device=cuda).manual_seed(0), cfg,
                            export_qp, device=cuda)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    export = nbytes(built)
    assert peak <= export + 2 * layer + embed + 1e9, (peak, export, layer,
                                                      embed)
    want = flatten_with_path(export_qp(get_model(cfg).init(
        torch.Generator(device=cuda).manual_seed(0), cfg, device=cuda)))
    got = flatten_with_path(built)
    assert list(got) == list(want)
    for path, w in want.items():
        assert (got[path].dtype, got[path].shape, got[path].stride()) == \
            (w.dtype, w.shape, w.stride()), path
        assert torch.equal(got[path], w), path


# --- the state-space and hybrid families --------------------------------------------

# every projection (K, N) of mamba2-2.7b (in_proj, out_proj) and of
# zamba2-1.2b (in_proj, out_proj, the shared block's q/k/v/o, up/gate, down)
SSM_PROJ = [(2560, 10576), (5120, 2560), (2048, 8384), (4096, 2048),
            (2048, 2048), (2048, 8192), (8192, 2048)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", [8, 2048])
@pytest.mark.parametrize("k,n", SSM_PROJ)
def test_ssm_projections(cuda, k, n, m, dtype):
    """qmatvec at the new families' projections, a tick's M and the
    largest admission's, through the variant its plan gives for M."""
    g = _gen(k + n + m)
    x = torch.randn((m, k), generator=g).to(dtype)
    w = pack_matrix(torch.randint(-4, 4, (k, n), generator=g,
                                  dtype=torch.int8), 3)
    d = torch.rand(n, generator=g) * 0.05
    ref = qmv_ops.qmatvec(x, w, d, k=k)
    before = dict(qmv_k.launches_by_variant)
    got = qmv_ops.qmatvec(*_on(cuda, x, w, d), k=k)
    want = qmv_k.plan(m, k, n, dtype).variant
    assert qmv_k.launches_by_variant[want] == before[want] + 1
    _check(got, ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d,v", [(2560, 50280), (2048, 32000)])
def test_ssm_tied_readouts(cuda, d, v, dtype):
    """The tied readouts of mamba2-2.7b and zamba2-1.2b: the (V, D) int8
    table read as its transposed view, in qmatmul's k_lanes layout."""
    g = _gen(d)
    table = torch.randint(-127, 128, (v, d), generator=g, dtype=torch.int8)
    h = torch.randn((8, d), generator=g).to(dtype)
    ref = qmm_ops.qmatmul(h, table.T, 1.0)
    tc, hc = _on(cuda, table, h)
    assert qmm_k.plan(8, d, v, *tc.T.stride(), dtype).layout == "k_lanes"
    _check(qmm_ops.qmatmul(hc, tc.T, 1.0), ref, dtype)


def _hybrid_card(d_model=128, vocab=256):
    from repro_torch.configs import get_config, reduced
    return reduced(get_config("zamba2-1.2b"), layers=5, d_model=d_model,
                   vocab=vocab)


def test_hybrid_rollback_on_card_matches_cpu(cuda):
    """``rollback_cache`` of a hybrid cache with a trajectory on CUDA
    tensors gives the CPU's cache, written into the same tensors: each
    row's mamba snapshot selected, the wiped K/V zeroed, the lengths
    rewound (an out-of-range slot dropped)."""
    from repro_torch.core.treeutil import flatten_with_path, unflatten
    from repro_torch.models import api
    cfg = _hybrid_card()
    cpu = api.init_cache(cfg, 4, 24, torch.float32, per_slot_len=True,
                         device="cpu")
    g = _gen(21)
    flat = flatten_with_path(cpu)
    for path, t in flat.items():
        if path == "len":
            t.copy_(torch.tensor([20, 7, 5, 24], dtype=torch.int32))
        else:
            t.copy_(torch.rand(t.shape, generator=g) + 0.5)
    traj = {name: {k: torch.rand((6,) + tuple(v.shape), generator=g)
                   for k, v in cpu[name].items()}
            for name in ("groups", "tail")}
    card = unflatten({p: t.to(cuda) for p, t in flat.items()})
    ptrs = {p: t.data_ptr() for p, t in flatten_with_path(card).items()}
    tcard = unflatten({p: t.to(cuda)
                       for p, t in flatten_with_path(traj).items()})
    slots, new = torch.tensor([0, 1, 9, 3]), torch.tensor([15, 4, 1, 22])
    want = api.rollback_cache(cfg, cpu, slots, new, traj)
    got = api.rollback_cache(cfg, card, slots.to(cuda), new.to(cuda), tcard)
    assert want["len"].tolist() == [15, 4, 5, 22]
    for path, t in flatten_with_path(want).items():
        assert torch.equal(flatten_with_path(got)[path].cpu(), t), path
    for path, ptr in ptrs.items():
        if path != "len":
            assert flatten_with_path(got)[path].data_ptr() == ptr, path


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b"])
def test_ssm_kernel_path_matches_plain(cuda, arch):
    """A small model's qp export, fp32 activations: prefill of right-padded
    prompts and 4 decode steps through the kernels on the card, against
    the plain paths on the CPU: logits within 2e-3 x max|logit|."""
    import dataclasses
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import quant_dense
    from repro_torch.core.precision import W3A8
    from repro_torch.core.treeutil import flatten_with_path, unflatten
    from repro_torch.models import api, get_model
    cfg = reduced(get_config(arch), layers=5, d_model=128, vocab=256)
    pol = dataclasses.replace(W3A8, act_bits=None)
    params = quant_dense.export_container(
        get_model(cfg).init(_gen(22), cfg), pol)
    card = unflatten({p: t.to(cuda)
                      for p, t in flatten_with_path(params).items()})
    toks = torch.zeros((4, 16), dtype=torch.int32)
    lens = torch.tensor([3, 16, 9, 1], dtype=torch.int32)
    for i, n in enumerate(lens.tolist()):
        toks[i, :n] = torch.arange(n) + 2 + i
    logits = {}
    for name, p, dev in (("card", card, cuda), ("cpu", params, "cpu")):
        kw = dict(policy=pol, dtype=torch.float32)
        lg, c = api.prefill(p, {"tokens": toks.to(dev)}, cfg, max_len=32,
                            lengths=lens.to(dev), **kw)
        steps = [lg.cpu()]
        for i in range(4):
            nxt = torch.full((4, 1), 5 + i, dtype=torch.int32, device=dev)
            lg, c = api.decode_step(p, c, nxt, cfg, **kw)
            steps.append(lg.cpu())
        logits[name] = torch.stack(steps)
    err = float((logits["card"] - logits["cpu"]).abs().max())
    assert err <= 2e-3 * float(logits["cpu"].abs().max()), err


@pytest.mark.parametrize("arch,kv_bits", [("mamba2-2.7b", None),
                                          ("zamba2-1.2b", None),
                                          ("zamba2-1.2b", 8)])
def test_ssm_captured_engine_matches_eager(cuda, arch, kv_bits):
    """The qp export of a small mamba2 / hybrid served on the card, bf16:
    the captured engine (one tick capture, one per admission bucket; the
    tick's warm-ups leave the recurrent state as they found it) serves the
    tokens of its capture=False twin."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import quant_dense
    from repro_torch.core.precision import W3A8
    from repro_torch.models import get_model
    from repro_torch.serving.engine import ServingEngine
    cfg = reduced(get_config(arch), layers=5, d_model=256, vocab=256)
    params = quant_dense.export_container(
        get_model(cfg).init(_gen(23), cfg), W3A8)
    outs = []
    for capture in (True, False):
        eng = ServingEngine(params, cfg, policy=W3A8, slots=3, max_len=64,
                            dtype=torch.bfloat16, kv_bits=kv_bits,
                            capture=capture, device=cuda)
        outs.append(_card_serve(eng))
        if capture:
            assert eng.captures == {"tick": 1,
                                    "admit": {8: 1, 16: 1, 32: 1}}
    assert outs[0] == outs[1]


def test_hybrid_captured_spec_engine_matches_greedy(cuda):
    """A small fp32 hybrid served speculatively on the card (its 3-bit
    export drafting, spec_k = 4; both caches rolled back through their
    state trajectories inside the captured tick) gives greedy generate's
    tokens and the eager spec engine's."""
    from repro_torch.core.precision import FLOAT
    from repro_torch.models import get_model
    from repro_torch.serving.engine import ServingEngine, generate
    cfg = _hybrid_card()
    master = get_model(cfg).init(_gen(24), cfg)
    outs = []
    for capture in (True, False):
        eng = ServingEngine(master, cfg, policy=FLOAT, slots=3, max_len=64,
                            dtype=torch.float32, spec_k=4, capture=capture,
                            device=cuda)
        outs.append(_card_serve(eng))
        assert eng.spec_drafted > 0
    assert outs[0] == outs[1]
    for i, p in enumerate(CARD_PROMPTS):
        g = generate(master, [p], cfg, policy=FLOAT, max_new_tokens=9,
                     dtype=torch.float32, device=cuda).cpu()
        assert outs[0][i] == ("ok", g[0, len(p):].tolist()), i


# --- LM training on the card -----------------------------------------------------

def _train_setup(device, capture, policy_name="w3a8", frozen=True,
                 steps=4, ckpt=None):
    """A reduced qwen2 W3A8 train step (frozen per-layer deltas in the
    state) and its state, bf16 compute, on ``device``."""
    from repro_torch.configs import TrainConfig, get_config, reduced
    from repro_torch.core import quant_dense
    from repro_torch.core.precision import FLOAT, W3A8
    from repro_torch.models import get_model
    from repro_torch.training.loop import make_train_step
    cfg = reduced(get_config("qwen2-1.5b"), layers=3, d_model=128, vocab=512)
    policy = W3A8 if policy_name == "w3a8" else FLOAT
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=steps,
                       grad_clip=1.0)
    params = get_model(cfg).init(torch.Generator(device=device).manual_seed(0),
                                 cfg, device=device)
    extra = ({"deltas": quant_dense.fit_deltas_stacked(params, policy)}
             if frozen and policy_name == "w3a8" else None)
    step, init = make_train_step(cfg, tcfg, policy, capture=capture)
    return cfg, step, init(params, extra)


def _train_batches(cfg, device, n, start=0):
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.data.synthetic import lm_batch
    return [shard_batch(lm_batch(0, start + i, batch=4, seq=32,
                                 vocab=cfg.vocab_size), device)
            for i in range(n)]


@pytest.mark.parametrize("policy", ["w3a8", "float"])
def test_train_step_captured_equals_eager(cuda, policy):
    """4 replayed steps of one captured graph equal 4 eager steps bit for
    bit (metrics, parameters, AdamW state, step), and the lr changes at
    every replay: it is computed on the card from the step counter, not
    frozen at capture."""
    from repro_torch.core.treeutil import flatten_with_path
    out = {}
    for capture in (True, False):
        cfg, step, state = _train_setup(cuda, capture, policy)
        ms = []
        for b in _train_batches(cfg, cuda, 4):
            state, m = step(state, b)
            ms.append({k: float(v) for k, v in m.items()})
        out[capture] = (ms, flatten_with_path(state), step.captures)
    (cm, cs, ccap), (em, es, ecap) = out[True], out[False]
    assert list(ccap.values()) == [1] and ecap == {}
    assert cm == em
    assert len({m["lr"] for m in cm}) == 4
    for path, v in es.items():
        assert torch.equal(cs[path], v), path
    assert int(cs["step"]) == 4


def test_train_step_lr_frozen_at_capture_shows(cuda):
    """The trap the schedule avoids: an lr read on the host at capture is
    frozen into the graph (replays keep it), while the step's own device
    lr follows the step counter."""
    cfg, step, state = _train_setup(cuda, True)
    seen = []
    sched = step.sched

    def host_lr(s):
        lr = sched(s)
        seen.append(lr)
        return lr
    step.sched = host_lr
    lrs = []
    for b in _train_batches(cfg, cuda, 4):
        state, m = step(state, b)
        lrs.append(float(m["lr"]))
    # the schedule ran at the warm-ups and the capture only, yet every
    # replay's lr is its own step's
    assert len(seen) == 3 and len(set(lrs)) == 4


def test_trainer_async_checkpoints_restore_under_replay(cuda, tmp_path):
    """Trainer with save_async every 2 steps on a replayed step: restored
    at step 4 (onto the card) and continued by a fresh captured step, the
    state after 6 steps equals an uninterrupted run's bit for bit."""
    from repro_torch import checkpoint
    from repro_torch.core.treeutil import flatten_with_path
    from repro_torch.data.pipeline import HostLoader
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.training.loop import Trainer

    def loader(cfg, start=0):
        return HostLoader(lambda seed, s: lm_batch(
            seed, s, batch=4, seq=32, vocab=cfg.vocab_size),
            start_step=start, device=cuda)

    cfg, step, state = _train_setup(cuda, True, steps=6)
    full = Trainer(step, state, log_every=1)
    full.run(loader(cfg), 6)
    cfg, step, state = _train_setup(cuda, True, steps=6)
    ck = checkpoint.Checkpointer(str(tmp_path), keep=3)
    part = Trainer(step, state, checkpointer=ck, ckpt_every=2, log_every=1)
    part.run(loader(cfg), 4)
    assert checkpoint.all_steps(str(tmp_path)) == [2, 4]
    tree, meta = checkpoint.restore(str(tmp_path), device=cuda)
    assert meta["step"] == 4
    _, step, _ = _train_setup(cuda, True, steps=6)
    resumed = Trainer(step, tree, log_every=1)
    resumed.run(loader(cfg, meta["step"]), 2)
    assert list(step.captures.values()) == [1]
    want = flatten_with_path(full.state)
    for path, v in flatten_with_path(resumed.state).items():
        assert torch.equal(v, want[path]), path
    assert resumed.history[-1]["loss"] == full.history[-1]["loss"]


def test_train_launcher_on_the_card(cuda):
    """``launch/train.py --reduced --steps 8`` on cuda: captured, finite,
    its loss falls."""
    from repro_torch.launch import train
    tr = train.main(["--arch", "qwen2-1.5b", "--reduced", "--steps", "8"])
    first, last = tr.history[0]["loss"], tr.history[-1]["loss"]
    assert torch.isfinite(torch.tensor([first, last])).all() and last < first
    assert list(tr.train_step.captures.values()) == [1]


# --- the kernels as registered ops ------------------------------------------------

def _op_cases(dev):
    """(label, inputs, call) of every kernel route at its main shape; the
    call takes the inputs, real or fake."""
    g = _gen(24)
    bf, f32 = torch.bfloat16, torch.float32
    rn = lambda *s, dt=bf: torch.randn(s, generator=g).to(dt).to(dev)  # noqa
    ri = lambda lo, hi, *s, dt: torch.randint(  # noqa: E731
        lo, hi, s, generator=g, dtype=dt).to(dev)
    words = ri(-2 ** 31, 2 ** 31 - 1, 154, 8960, dt=torch.int32)
    delta = rn(8960, dt=f32).abs()
    lv = ri(-127, 128, 1536, 8960, dt=torch.int8)
    table = ri(-127, 128, 151936, 1536, dt=torch.int8)
    hi = torch.minimum(torch.arange(256, dtype=torch.int32)[None] + 1,
                       torch.tensor([[256], [7], [100], [1]],
                                    dtype=torch.int32)).to(dev)
    lens = torch.tensor([512, 3, 400, 1], dtype=torch.int32).to(dev)
    x1 = rn(100, 1022, dt=f32)
    return [
        ("qmatvec decode", (rn(8, 1536), words, delta),
         lambda x, w, d: qmv_ops.qmatvec(x, w, d, k=1536)),
        ("qmatvec prefill", (rn(512, 1536), words, delta),
         lambda x, w, d: qmv_ops.qmatvec(x, w, d, k=1536)),
        ("qmatmul k_lanes", (rn(8, 1536), table),
         lambda x, t: qmm_ops.qmatmul(x, t.T, 1.0)),
        ("qmatmul n_lanes decode", (rn(8, 1536), lv, delta),
         lambda x, w, d: qmm_ops.qmatmul(x, w, d)),
        ("qmatmul n_lanes prefill", (rn(512, 1536), lv, delta),
         lambda x, w, d: qmm_ops.qmatmul(x, w, d)),
        ("qmatmul k_lanes row_major", (rn(8, 4096), lv[:, :16].contiguous()
                                       .repeat(3, 1)[:4096], delta[:16]),
         lambda x, w, d: qmm_ops.qmatmul(x, w, d, out_dtype=f32)),
        ("attn_decode", (rn(4, 1, 12, 128), rn(4, 512, 2, 128), lens),
         lambda q, k, n: dec_ops.attn_decode(q, k, k, n)),
        ("attn_prefill wgmma", (rn(4, 256, 12, 128), rn(4, 256, 2, 128), hi),
         lambda q, k, h: pf_ops.attn_prefill(q, k, k, h)),
        ("attn_prefill simt", (rn(4, 256, 12, 128, dt=f32),
                               rn(4, 256, 2, 128, dt=f32), hi),
         lambda q, k, h: pf_ops.attn_prefill(q, k, k, h)),
        ("sigmoid_pw", (x1,), sig_k.sigmoid_pw_cuda),
        ("sigmoid_pw_bwd", (x1, x1), sig_k.sigmoid_pw_bwd_cuda)]


def _meta(t):
    return tuple(t.shape), t.dtype, t.device, t.stride()


@pytest.mark.parametrize("case", range(11))
def test_fake_op_allocates_what_the_real_launch_allocates(cuda, case):
    """Each op's fake implementation gives the real launch's output
    (shape, dtype, device, strides) and notes the same plan: variant,
    grid, dynamic shared memory and scratch."""
    from repro_torch.analysis.trace import fake_mode, fake_tree
    from repro_torch.kernels import _ops
    label, inputs, call = _op_cases(cuda)[case]
    with torch.no_grad(), _ops.recording() as real_notes:
        real = call(*inputs)
    torch.cuda.synchronize()
    fm = fake_mode()
    fake_in = fake_tree(list(inputs), fm)
    with fm, torch.no_grad(), _ops.recording() as fake_notes:
        fake = call(*fake_in)
    assert _meta(fake) == _meta(real), label
    assert len(real_notes) == len(fake_notes) == 1, label
    keep = ("kernel", "variant", "grid", "dynamic_smem", "scratch", "plan")
    assert ({k: fake_notes[0][k] for k in keep}
            == {k: real_notes[0][k] for k in keep}), label


def test_a_real_cpu_tensor_reaching_a_kernel_op_raises(cuda):
    with pytest.raises(NotImplementedError):
        torch.ops.repro_torch.attn_decode(
            torch.zeros((1, 1, 2, 16)), torch.zeros((1, 4, 1, 16)),
            torch.zeros((1, 4, 1, 16)), torch.ones(1, dtype=torch.int32),
            None, None, 1.0)
