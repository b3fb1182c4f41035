"""The launch plans of the port's redesigned CUDA kernels, on the CPU.

Which kernel and layout each call takes is decided in pure Python
(``kernels/qmatmul/kernel.py::plan``, ``kernels/attn_prefill/kernel.py::
plan``) before anything is launched, so these tests pin the dispatch that
the card runs: the qmatmul layout for the tied readout's transposed view,
the paper MLP's 8-bit heads and a wide row-major W; the attn_prefill kernel
for each query / K-V dtype, and the refusal of what no kernel takes; and
the dynamic shared memory each launch asks for, twice of which must fit the
H100's 232 448 bytes a block (two blocks per SM). Also the exact arithmetic the qmatmul tensor-core layout rests on:
an int8 level is a bf16 exactly, and an fp32 x is the sum of its three
bf16 planes. Imports no JAX."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.attn_prefill import kernel as pf_k
from repro_torch.kernels.qmatmul import kernel as qmm_k

QWEN = get_config("qwen2-1.5b")
SMEM = 232448                    # shared memory one block may use, H100
_FLOATS = (torch.bfloat16, torch.float32)


def _w_view(k, n, transposed):
    """A (k, n) int8 W as the callers pass it: the tied readout's ``q.T``
    view of a (n, k) table, or a row-major matrix."""
    if transposed:
        return torch.zeros((n, k), dtype=torch.int8).T
    return torch.zeros((k, n), dtype=torch.int8)


def _qplan(m, k, n, transposed, dtype=torch.bfloat16):
    w = _w_view(k, n, transposed)
    return qmm_k.plan(m, k, n, *w.stride(), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_readout_view_takes_k_lanes(dtype):
    """The tied readout (slots 8, d_model, vocab) reads ``q.T``: lanes along
    K, x staged once per block (one 8-row tile, all of K in one chunk)."""
    d, v = QWEN.d_model, QWEN.vocab_size
    p = _qplan(8, d, v, True, dtype)
    assert p.layout == "k_lanes"
    assert (p.p0, p.p1) == (1, d)
    planes = 3 if dtype == torch.float32 else 1
    assert p.dynamic_smem >= planes * 8 * 2 * d      # all of x, in bf16
    assert 2 * p.dynamic_smem <= SMEM                # two blocks per SM


@pytest.mark.parametrize("m,k,n", [(100, 1022, 10), (128, 1022, 61)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlp_heads_take_k_lanes(m, k, n, dtype):
    """The digit (N = 10) and phoneme (N = 61) heads are row-major: lanes
    along K, no dynamic shared memory (x is read once, straight from
    device memory)."""
    p = _qplan(m, k, n, False, dtype)
    assert p.layout == "k_lanes"
    assert (p.p0, p.p1, p.dynamic_smem) == (0, 0, 0)


@pytest.mark.parametrize("m,k,n", [(8, 1536, 8960), (512, 1536, 1536),
                                   (8, 8960, 1536), (3, 23, 65)])
def test_wide_row_major_keeps_n_lanes(m, k, n):
    """A row-major W wider than 64 columns (the ``q`` form's projections)
    keeps lanes along N, whose reads are already coalesced."""
    p = _qplan(m, k, n, False)
    assert p.layout == "n_lanes" and p.dynamic_smem == 0


@pytest.mark.parametrize("m,nt", [(1, 1), (8, 1), (9, 2), (16, 2), (17, 4),
                                  (100, 4)])
def test_readout_m_tiles(m, nt):
    """M beyond one 8-row tile (admission): 2 or 4 tiles of x per block,
    each staged in bf16; the launcher's grid covers the rest of M."""
    p = _qplan(m, 1536, 4099, True)
    assert p.p0 == nt
    assert p.dynamic_smem >= 8 * nt * 2 * p.p1
    assert 2 * p.dynamic_smem <= SMEM


@pytest.mark.parametrize("m", [1, 8, 9, 37, 100])
@pytest.mark.parametrize("k", [1, 23, 1022, 1536, 8960, 151936])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_qmatmul_smem_within_the_card(m, k, dtype):
    """Every K-contiguous plan stages x in whole 128-wide steps, at most 96
    KB a block; K beyond that is walked in chunks."""
    p = _qplan(m, k, 4099, True, dtype)
    assert p.p1 % 128 == 0 and p.p1 >= 128
    per_k = (3 if dtype == torch.float32 else 1) * 8 * p.p0 * 2
    assert p.p1 >= k or per_k * (p.p1 + 128 + 8) > 96 * 1024  # chunk is full
    assert p.dynamic_smem <= 96 * 1024 and 2 * p.dynamic_smem <= SMEM
    for n in (10, 61, 4099):                         # row-major: static only
        assert _qplan(m, k, n, False, dtype).dynamic_smem == 0


@pytest.mark.parametrize("q_dtype,kv_dtype,variant", [
    (torch.bfloat16, torch.bfloat16, "wgmma"),
    (torch.bfloat16, torch.int8, "wgmma"),
    (torch.float32, torch.float32, "simt"),
    (torch.float32, torch.int8, "simt")])
@pytest.mark.parametrize("d", [64, 128])
def test_attn_prefill_kernel_by_dtype(q_dtype, kv_dtype, variant, d):
    """bf16 queries (the engine's admission) run on the tensor cores, fp32
    queries (the fp32 parity path) on the CUDA cores; each within the
    card's shared memory."""
    g = QWEN.num_heads // QWEN.num_kv_heads
    p = pf_k.plan(q_dtype, kv_dtype, g, d)
    assert p.variant == variant
    assert 2 * p.dynamic_smem <= SMEM
    if variant == "simt":
        assert p.dynamic_smem == 0


@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("d", [64, 128])
def test_attn_prefill_wgmma_smem_fits_two_blocks_per_sm(kv_dtype, d):
    """The tensor-core kernel holds its 64-row Q tile and two buffers of
    K/V blocks (double buffering: the next block loads while this one is
    multiplied), and fits twice in an SM, so a second block's loads overlap
    the first's products."""
    p = pf_k.plan(torch.bfloat16, kv_dtype, 6, d)
    kv_block = 64 * d * torch.tensor([], dtype=kv_dtype).element_size()
    assert p.dynamic_smem >= 64 * d * 2 + 2 * 2 * kv_block
    assert 2 * p.dynamic_smem <= SMEM


@pytest.mark.parametrize("q_dtype,kv_dtype,d", [
    (torch.bfloat16, torch.float32, 128),   # no mixed bf16 / fp32 kernel
    (torch.float32, torch.bfloat16, 128),
    (torch.float16, torch.float16, 128),    # no fp16 kernel
    (torch.bfloat16, torch.bfloat16, 32),   # the tensor-core kernel: D 64/128
    (torch.bfloat16, torch.int8, 256),
    (torch.float32, torch.float32, 48)])
def test_attn_prefill_refuses_what_no_kernel_takes(q_dtype, kv_dtype, d):
    with pytest.raises(ValueError):
        pf_k.plan(q_dtype, kv_dtype, 6, d)


def test_attn_prefill_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError):
        pf_k.attn_prefill_cuda(*(torch.zeros((1, 1, 1, 1, 128)),) * 5)


def test_launch_counters_name_each_layout_and_variant():
    """Every layout and kernel a plan can pick has its launch counter (the
    wrappers add one to ``launches_by_*[plan.*]``), and each has a case
    that picks it."""
    layouts = {_qplan(m, k, n, tr, dt).layout
               for m in (1, 8, 100) for k, n in ((1536, 151936), (1022, 61))
               for tr in (True, False) for dt in _FLOATS}
    variants = {pf_k.plan(qd, kd, 6, 128).variant
                for qd, kd in ((torch.bfloat16, torch.bfloat16),
                               (torch.bfloat16, torch.int8),
                               (torch.float32, torch.float32),
                               (torch.float32, torch.int8))}
    assert layouts == set(qmm_k.launches_by_layout)
    assert variants == set(pf_k.launches_by_variant)


def test_int8_levels_are_exact_in_bf16():
    """The qmatmul and attn_prefill tensor-core paths widen int8 to bf16:
    the byte-permute trick (level + 128 in the mantissa of 2^23, minus
    2^23 + 128) gives every level exactly, and its top 16 bits are the
    level's bf16."""
    lv = np.arange(-128, 128, dtype=np.int32)
    u = (lv + 128).astype(np.uint32)
    f = (np.uint32(0x4B000000) | u).view(np.float32) - np.float32(8388736.0)
    assert np.array_equal(f, lv.astype(np.float32))
    top = (f.view(np.uint32) >> 16).astype(np.uint16)
    assert not np.any(f.view(np.uint32) & 0xFFFF)
    bf = torch.from_numpy(lv.astype(np.float32)).to(torch.bfloat16)
    assert np.array_equal(top, bf.view(torch.int16).numpy().view(np.uint16))


def test_fp32_x_is_the_sum_of_three_bf16_planes():
    """The readout's fp32 x enters the bf16 tensor cores as hi + mid + lo,
    each the bf16 rounding of what is left: the sum is x exactly, so every
    product with an int8 level is exact in fp32."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(np.concatenate([
        rng.standard_normal(4096) * 10.0 ** rng.integers(-20, 20, 4096),
        [0.0, -0.0, 1.0, 3.0e38, -1e-30]]).astype(np.float32))
    rest, planes = x.clone(), []
    for _ in range(3):
        p = rest.to(torch.bfloat16)
        planes.append(p)
        rest = rest - p.float()
    total = planes[0].float() + planes[1].float() + planes[2].float()
    assert x.dtype == torch.float32 and torch.equal(total, x)
