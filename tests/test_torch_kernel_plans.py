"""The launch plans of the port's redesigned CUDA kernels, on the CPU.

Which kernel and layout each call takes is decided in pure Python (``plan``
in ``kernels/{qmatvec,qmatmul,attn_decode,attn_prefill}/kernel.py``) before
anything is launched, so these tests pin the dispatch that the card runs:
the qmatvec variant and tiles by M, and its split of K; the qmatmul layout
for the tied readout's transposed view, the untied head of each export
form, the paper MLP's 8-bit heads and a wide row-major W; the attn_decode
split of S; the attn_prefill kernel for each query / K-V dtype and every
head_dim that is a multiple of 16 to 256, and the refusal of what no
kernel takes; and the
dynamic shared memory each launch asks for, within the H100's 232 448
bytes a block. Also the exact arithmetic the tensor-core kernels rest on:
an int8 or 3-bit level is a bf16 exactly, an fp32 x is the sum of its
three bf16 planes, qmatvec's permuted K order gives x . W exactly, and
attn_decode's split-and-merge softmax equals one softmax; and how
``launch/profile_engine.py`` books attn_prefill's split merges. Imports
no JAX."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.packing import pack_matrix
from repro_torch.kernels.attn_decode import kernel as dec_k
from repro_torch.kernels.attn_prefill import kernel as pf_k
from repro_torch.kernels.qmatmul import kernel as qmm_k
from repro_torch.kernels.qmatvec import kernel as qmv_k

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
    """The digit (N = 10) and phoneme (N = 61) heads are row-major: the
    row-major k_lanes kernel, one 16-row tile a block (too few tiles for
    the SMs), K split across the blocks of a cluster in whole 64-K steps,
    W staged whole for the block's slice, two blocks an SM."""
    p = _qplan(m, k, n, False, dtype)
    assert p.layout == "k_lanes" and p.orientation == "row_major"
    assert p.p0 == 1 and p.ksplit > 1
    steps = -(-k // 64)
    spz = -(-steps // p.ksplit)
    assert (p.ksplit - 1) * spz < steps                 # no empty slice
    assert p.p1 == spz * 64                             # one W chunk
    nt = next(v for v in (1, 2, 4, 8) if 8 * v >= n)
    assert p.dynamic_smem == qmm_k.rows_smem(nt, p.p1, p.p0, dtype)
    assert 2 * (p.dynamic_smem + 1024) <= 228 * 1024


@pytest.mark.parametrize("m,k,n,transposed,orientation", [
    (8, 1536, 151936, True, "k_major"),          # the tied readout
    (100, 1022, 10, False, "row_major"),         # the digit head
    (8, 4096, 16, False, "row_major"),           # phi3.5-moe's router
    (32768, 6144, 8, False, "row_major"),        # mixtral's, 4096 bucket
    (8, 4096, 6400, False, "")])                 # an expert: n_lanes
def test_plan_names_k_lanes_orientation(m, k, n, transposed, orientation):
    """``plan`` names the orientation of W that a k_lanes launch reads,
    which ``launches_by_orientation`` counts: K-major for the readout and
    the container head, row-major for the MLP heads and the MoE routers;
    none for n_lanes."""
    p = _qplan(m, k, n, transposed)
    assert p.orientation == orientation
    assert (p.layout == "k_lanes") == bool(orientation)


@pytest.mark.parametrize("m,k,n", [(8, 1536, 8960), (512, 1536, 1536),
                                   (8, 8960, 1536), (3, 23, 65)])
def test_wide_row_major_keeps_n_lanes(m, k, n):
    """A row-major W wider than 64 columns (the ``q`` form's projections)
    keeps lanes along N, whose 16-byte loads are already coalesced, in the
    variant its M gives: decode stages two int8 chunks and one (64, 64 + 8)
    bf16 tile per warp, prefill three cp.async stages of its raw 128-row x
    tile (rows padded to 72 bf16) and (64, 128) int8 W tile, and one
    widened (64, 128 + 8) bf16 W tile."""
    p = _qplan(m, k, n, False)
    assert p.layout == "n_lanes"
    if m <= 16:
        assert p.variant == "decode"
        assert p.dynamic_smem == p.p0 * (2 * 64 * 64 + 64 * 72 * 2)
    else:
        assert p.variant == "prefill"
        assert p.dynamic_smem == 3 * (128 * 72 * 2 + 64 * 128) + 64 * 136 * 2


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
    for n in (10, 61):                    # row-major, narrow: two an SM
        rp = _qplan(m, k, n, False, dtype)
        assert rp.p1 % 64 == 0 and 0 < rp.dynamic_smem
        assert 2 * (rp.dynamic_smem + 1024) <= 228 * 1024
    assert 0 < _qplan(m, k, 4099, False, dtype).dynamic_smem <= SMEM


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
    if variant == "simt":            # the 64-row Q tile and a key block
        assert 64 * d * 4 + 2 * p.key_block * d * 4 <= p.dynamic_smem
        assert p.dynamic_smem <= SMEM
    else:
        assert 2 * p.dynamic_smem <= SMEM


@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("d", [16, 32, 64, 80, 128])
def test_attn_prefill_wgmma_smem_fits_two_blocks_per_sm(kv_dtype, d):
    """The tensor-core kernel holds its 64-row Q tile and two buffers of
    K/V blocks (double buffering: the next block loads while this one is
    multiplied), and fits twice in an SM up to D = 128, so a second block's
    loads overlap the first's products."""
    p = pf_k.plan(torch.bfloat16, kv_dtype, 6, d)
    kv_block = 64 * d * torch.tensor([], dtype=kv_dtype).element_size()
    assert p.dynamic_smem >= 64 * d * 2 + 2 * 2 * kv_block
    assert 2 * p.dynamic_smem <= SMEM


@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("d", range(16, 257, 16))
def test_attention_plans_take_every_head_dim(kv_dtype, d):
    """Every head_dim that is a multiple of 16 from 16 to 256 (a wgmma
    k-step; stablelm-3b's 80 among them) has a plan in both attention
    kernels, within one block's shared memory."""
    p = pf_k.plan(torch.bfloat16, kv_dtype, 8, d)
    assert p.variant == "wgmma" and p.dynamic_smem <= SMEM
    fp = torch.float32 if kv_dtype == torch.bfloat16 else torch.int8
    assert pf_k.plan(torch.float32, fp, 8, d).variant == "simt"
    for dt in (kv_dtype, fp):
        assert dec_k.plan(8, 512, 32, 1, d, dt).dynamic_smem <= SMEM


@pytest.mark.parametrize("q_dtype,kv_dtype,d", [
    (torch.bfloat16, torch.float32, 128),   # no mixed bf16 / fp32 kernel
    (torch.float32, torch.bfloat16, 128),
    (torch.float16, torch.float16, 128),    # no fp16 kernel
    (torch.bfloat16, torch.bfloat16, 72),   # head_dim not a multiple of 16
    (torch.bfloat16, torch.int8, 272),      # past 256
    (torch.float32, torch.float32, 8)])
def test_attn_prefill_refuses_what_no_kernel_takes(q_dtype, kv_dtype, d):
    with pytest.raises(ValueError):
        pf_k.plan(q_dtype, kv_dtype, 6, d)


@pytest.mark.parametrize("g,d", [(6, 72), (6, 40), (33, 128), (1, 264)])
def test_attention_refuses_head_shapes_no_kernel_takes(g, d):
    """A head_dim that is not a multiple of 16 (stablelm-style 80 is; 72
    and 40 are not), past 256, or more than 32 query heads per KV head:
    both attention kernels raise, with the reason."""
    for fn in (lambda: pf_k.plan(torch.bfloat16, torch.bfloat16, g, d),
               lambda: dec_k.check_head(g, d, "attn_decode")):
        with pytest.raises(ValueError, match="head_dim|query heads"):
            fn()


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


# --- qmatvec: the variant by M, the tile shape, the K permutation ---------

# the engine's four projection shapes (K, N) and the paper MLP's layers
_QMV_SHAPES = [(1536, 1536), (1536, 256), (1536, 8960), (8960, 1536),
               (784, 1022), (429, 1022), (1022, 1022), (1022, 61), (23, 10)]


@pytest.mark.parametrize("m,variant,nt", [(1, "decode", 1), (8, "decode", 1),
                                          (9, "decode", 2),
                                          (16, "decode", 2),
                                          (17, "prefill", 2),
                                          (64, "prefill", 2),
                                          (100, "prefill", 2),
                                          (255, "prefill", 2),
                                          (256, "prefill", 8),
                                          (2048, "prefill", 8)])
def test_qmatvec_plan_picks_the_variant_by_m(m, variant, nt):
    """M <= 16 (a decode tick's slots) takes the decode kernel, anything
    larger (admission's slots x bucket, the MLP's batch) the prefill
    kernel: 16-row tiles below M = 256, 64-row tiles that stage x from
    there."""
    for k, n in _QMV_SHAPES:
        p = qmv_k.plan(m, k, n, torch.bfloat16)
        assert (p.variant, p.nt) == (variant, nt)


@pytest.mark.parametrize("m", [1, 8, 16, 17, 100, 512, 2048])
@pytest.mark.parametrize("k,n", _QMV_SHAPES)
@pytest.mark.parametrize("dtype", _FLOATS)
def test_qmatvec_plan_is_a_valid_launch(m, k, n, dtype):
    """What csrc/qmatvec.cu checks before it launches: a column group of
    32 in 1/2/4/8, slices of K across blocks that cover K with none empty,
    a staged piece no longer than a slice, and shared memory for the staged
    x (64-row tiles) and for the partial sums, within the card's 232 448 bytes a
    block. A slice whose x fits in 96 KB is staged whole."""
    p = qmv_k.plan(m, k, n, dtype)
    nch = -(-(-(-k // 10)) // 8)
    assert p.cg in (1, 2, 4, 8) and 1 <= p.ksplit <= 16
    assert p.cps * p.ksplit >= nch and (p.ksplit - 1) * p.cps < nch
    assert 1 <= p.piece <= p.cps
    planes = 3 if dtype == torch.float32 else 1
    per_chunk = planes * 8 * p.nt * 80 * 2
    assert p.dynamic_smem >= 8 * 32 * 2 * p.nt * 4 * 4
    assert p.dynamic_smem <= SMEM
    if p.nt == 8:                    # x staged in shared memory
        assert p.dynamic_smem >= planes * 8 * p.nt * (80 * p.piece + 8) * 2
        assert p.piece == p.cps or p.piece == 96 * 1024 // per_chunk
    else:                            # x read in place, one pass over K
        assert p.piece == p.cps


@pytest.mark.parametrize("m,k,n,ksplit", [(8, 1536, 8960, 1),
                                          (8, 1536, 1536, 1),
                                          (8, 1536, 256, 7),
                                          (8, 8960, 1536, 4),
                                          (100, 784, 1022, 1),
                                          (2048, 1536, 8960, 1),
                                          (2048, 8960, 1536, 1),
                                          (512, 8960, 1536, 1)])
def test_qmatvec_grid_and_k_split(m, k, n, ksplit):
    """At the engine's shapes and the MLP's: 64-row tiles hold a block for
    each of the H100's 132 SMs; smaller tiles at least 48 blocks, none of
    whose warps walks more than 4 chunks of K. K is split across blocks
    (and summed by a second kernel) only where that needs it: the 256-wide
    k/v projections and the 8960-deep down projection at decode."""
    p = qmv_k.plan(m, k, n, torch.bfloat16)
    blocks = -(-n // (32 * p.cg)) * -(-m // (8 * p.nt)) * p.ksplit
    assert p.ksplit == ksplit
    if p.nt == 8:
        assert blocks >= 132
    else:
        assert blocks >= 48 and -(-p.cps // (8 // p.cg)) <= 4


@pytest.mark.parametrize("k,n", [(23, 10), (429, 61), (784, 100),
                                 (1022, 1022), (1536, 40), (8960, 7)])
@pytest.mark.parametrize("dtype", _FLOATS)
def test_qmatvec_fragment_permutation_is_exact(k, n, dtype):
    """The kernel's 80-K chunk permutation and its level decoding (xor
    bias, 128 + field in bf16, minus 132), summed in float64 over the bf16
    plane(s) of x, give x . W exactly: bf16 x as is, fp32 x as three
    planes."""
    g = torch.Generator().manual_seed(k + n)
    lv = torch.randint(-4, 4, (k, n), generator=g, dtype=torch.int8)
    x = torch.randn((5, k), generator=g).to(dtype)
    got = qmv_k.fragment_product(x, pack_matrix(lv, 3), k)
    assert torch.equal(got, x.double() @ lv.double())


def test_qmatvec_levels_are_exact_in_bf16():
    """Every 3-bit level of every field position decodes exactly."""
    lv = torch.arange(-4, 4, dtype=torch.int64)
    for f in range(10):
        words = ((lv & 7) << (3 * f)) ^ 0x24924924
        pair = qmv_k._level_pair(words, f // 2)
        assert torch.equal(pair[:, f % 2].float(), lv.float())


# --- attn_decode: the split of S, the merge --------------------------------

@pytest.mark.parametrize("b,s,split_len,splits", [(8, 512, 32, 16),
                                                  (16, 512, 32, 16),
                                                  (8, 2048, 32, 64),
                                                  (1, 1, 32, 1),
                                                  (8, 96, 32, 3),
                                                  (8, 8192, 128, 64),
                                                  (1, 524288, 1024, 512)])
def test_attn_decode_plan_splits_by_s(b, s, split_len, splits):
    """The split length comes from the cache's static length S (and B, KV),
    never from cache_len: a power of two from 32, as many splits as cover
    S, at most 1024 of them (the merge's shared memory)."""
    p = dec_k.plan(b, s, 2, 32, 128, torch.bfloat16)
    assert p.splits <= 1024
    assert (p.split_len, p.splits) == (split_len, splits)
    assert p.splits * p.split_len >= s > (p.splits - 1) * p.split_len


def test_attn_decode_grid_fills_the_card_at_the_engine_shape():
    b, s = 8, 512                      # ServingEngine(slots=8, max_len=512)
    kvh = QWEN.num_kv_heads
    for dtype in (torch.bfloat16, torch.int8):
        p = dec_k.plan(b, s, kvh, QWEN.num_heads // kvh, QWEN.head_dim, dtype)
        assert p.splits * b * kvh >= 132


@pytest.mark.parametrize("d", [16, 32, 64, 80, 128, 256])
@pytest.mark.parametrize("g", [1, 6, 32])
@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16,
                                      torch.int8])
def test_attn_decode_smem_within_the_card(d, g, kv_dtype):
    """The split kernel's buffers: q of the block's hb * G heads, two
    stages of 32 keys of K and V, a staged row the hb KV heads' D values
    and 16 bytes of padding; within one block's limit, and where a block
    serves several KV heads, within two blocks an SM."""
    p = dec_k.plan(8, 512, 2, g, d, kv_dtype)
    row = p.hb * d * torch.tensor([], dtype=kv_dtype).element_size() + 16
    assert p.dynamic_smem >= p.hb * g * d * 4 + 2 * 2 * 32 * row
    assert p.dynamic_smem <= SMEM
    if p.hb > 1:
        assert 2 * (p.dynamic_smem + 1024) <= 228 * 1024


def _parent_decode_plan(b, s, kv, g, d, kv_dtype):
    """attn_decode's plan before KV heads were packed into a block: one KV
    head a block, the shortest split that keeps about eight blocks an
    SM; returns (grid, split_len, splits, dynamic_smem)."""
    want = -(-max(s, 1) * b * kv // (8 * 132))
    split_len = 32
    while split_len < want or -(-max(s, 1) // split_len) > 1024:
        split_len *= 2
    row = d * kv_dtype.itemsize + 16
    kv_buf = 2 * 32 * row + (2 * 32 * 4 if kv_dtype == torch.int8 else 0)
    smem = g * d * 4 + 8 * 4 * 32 * 4 + 2 * kv_buf
    splits = -(-max(s, 1) // split_len)
    return (splits, b * kv), split_len, splits, smem


@pytest.mark.parametrize("b,s,kv,g,d", [
    (8, 512, 2, 6, 128),          # qwen2-1.5b
    (8, 4096, 8, 6, 128),         # mixtral-8x22b, the full ring
    (8, 512, 8, 5, 128),          # qwen2.5-14b
    (8, 512, 8, 8, 128),          # qwen3-32b
    (8, 512, 8, 7, 128), (16, 2048, 4, 12, 64), (1, 1, 1, 32, 256)])
@pytest.mark.parametrize("kv_dtype", _FLOATS + (torch.int8,))
def test_attn_decode_plan_at_g5_and_above_is_the_parents(b, s, kv, g, d,
                                                         kv_dtype):
    """With five or more query heads a KV head, a block keeps one KV head:
    the grid, split and shared memory of the launch are what they were
    before KV heads were packed (hb = 1)."""
    p = dec_k.plan(b, s, kv, g, d, kv_dtype)
    grid = (p.splits, b * kv // p.hb)
    assert p.hb == 1
    assert (grid, p.split_len, p.splits, p.dynamic_smem) == \
        _parent_decode_plan(b, s, kv, g, d, kv_dtype)


@pytest.mark.parametrize("kv,g,hb", [(32, 1, 4), (8, 4, 2), (16, 2, 4),
                                     (6, 3, 2), (1, 1, 1), (2, 1, 2),
                                     (3, 1, 1)])
def test_attn_decode_packs_kv_heads_below_g5(kv, g, hb):
    """Below five query heads a KV head, a block serves hb neighbouring KV
    heads (a power of two dividing KV, at most 4, hb * G <= 8), and the
    grid still fills the card at the engine's shape."""
    p = dec_k.plan(8, 512, kv, g, 80, torch.bfloat16)
    assert p.hb == hb
    assert kv % p.hb == 0 and p.hb * g <= 8
    if kv * 8 >= 64:
        assert p.splits * 8 * kv // p.hb >= 132


@pytest.mark.parametrize("m,k,n,rw,ksplit", [
    (8, 4096, 16, 1, 8),          # phi3.5-moe's router at a tick
    (8, 6144, 8, 1, 8),           # mixtral-8x22b's
    (16, 4096, 16, 1, 8),
    (512, 4096, 16, 1, 8),        # an admission round of 8 x 64 tokens
    (32768, 6144, 8, 8, 1),       # mixtral's 4096 bucket
    (3, 64, 4, 1, 1)])
@pytest.mark.parametrize("dtype", _FLOATS)
def test_router_plan_tiles_rows_and_splits_k(m, k, n, rw, ksplit, dtype):
    """The MoE routers take the row-major k_lanes: eight 16-row tiles a
    block where that still gives a block for each SM, else one tile a
    block with K split across the blocks of a cluster (at most 8, no slice
    empty); W staged in as few 64-K-aligned chunks as keep two blocks on
    an SM; no K-split scratch (the cluster sums in shared memory)."""
    p = _qplan(m, k, n, False, dtype)
    assert (p.layout, p.orientation) == ("k_lanes", "row_major")
    assert (p.p0, p.ksplit) == (rw, ksplit)
    assert qmm_k._grid(p, m, n) == (-(-m // (16 * rw)), ksplit)
    assert p.p1 % 64 == 0 and p.p1 > 0 and ksplit <= 8
    assert 2 * (p.dynamic_smem + 1024) <= 228 * 1024


@pytest.mark.parametrize("s,split_len", [(1, 32), (77, 32), (300, 64),
                                         (512, 32), (1000, 256)])
def test_attn_decode_split_softmax_matches_one_pass(s, split_len):
    """Each split's softmax statistics merged in order equal one softmax
    over the row within fp32 rounding; splits past a row's length and rows
    of length 0 give no NaN, and the empty rows exact zeros."""
    g = torch.Generator().manual_seed(s)
    b, h, d = 6, 3, 16
    sc = torch.randn((b, h, s), generator=g) * 4
    v = torch.randn((b, s, d), generator=g)
    lens = torch.tensor([0, 1, min(split_len, s), min(split_len + 1, s),
                         s // 2, s], dtype=torch.int32)
    got = dec_k.split_softmax(sc, v, lens, split_len)
    valid = torch.arange(s)[None, :] < lens[:, None]
    p = torch.softmax(torch.where(valid[:, None], sc.double(),
                                  torch.tensor(float("-inf"),
                                               dtype=torch.float64)), -1)
    p = torch.nan_to_num(p)
    want = torch.einsum("bhs,bsd->bhd", p, v.double())
    assert torch.isfinite(got).all()
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    assert torch.allclose(got.double(), want, rtol=1e-5, atol=1e-6)


def test_qmatvec_launch_counters_name_each_variant():
    variants = {qmv_k.plan(m, 1536, 8960, torch.bfloat16).variant
                for m in (1, 8, 16, 17, 2048)}
    assert variants == set(qmv_k.launches_by_variant)


@pytest.mark.parametrize("arch", ["stablelm-3b", "qwen2.5-14b", "qwen3-32b"])
def test_untied_head_layout_by_form(arch):
    """The container export (qp) stores the untied 8-bit head's (K, N)
    levels K-contiguous, so its readout plans k_lanes; the q form keeps a
    row-major head, n_lanes (N > 64). The full-width head shapes plan the
    same way, with x staged in shared memory within the card."""
    from repro_torch.configs import reduced
    from repro_torch.core import quant_dense
    from repro_torch.core.precision import W3A8
    from repro_torch.models import api
    full = get_config(arch)
    cfg = reduced(full)
    master = api.get_model(cfg).init(torch.Generator().manual_seed(0), cfg)
    for export, layout in ((quant_dense.export_container, "k_lanes"),
                           (quant_dense.export_levels, "n_lanes")):
        q = export(master, W3A8)["head"]["q"]
        assert q.shape == (cfg.d_model, cfg.vocab_size)
        assert qmm_k.plan(8, *q.shape, *q.stride(),
                          torch.bfloat16).layout == layout
    p = _qplan(8, full.d_model, full.vocab_size, True)
    assert p.layout == "k_lanes" and 2 * p.dynamic_smem <= SMEM


# --- qmatmul n_lanes: the variant by M, the grid, the K permutation --------

# the q form's projections of qwen2-1.5b (K, N): wq / wo, wk / wv, up /
# gate, down
_Q_PROJ = [(1536, 1536), (1536, 256), (1536, 8960), (8960, 1536)]


@pytest.mark.parametrize("m,variant", [(1, "decode"), (8, "decode"),
                                       (9, "decode"), (16, "decode"),
                                       (17, "prefill"), (64, "prefill"),
                                       (512, "prefill"), (2048, "prefill")])
def test_n_lanes_variant_by_m(m, variant):
    """M <= 16 (a decode tick's slots) takes n_lanes decode, anything larger
    (admission's slots x bucket) the prefill GEMM, at every q-form shape
    and for both x dtypes; each variant has its launch counter."""
    for k, n in _Q_PROJ:
        for dtype in _FLOATS:
            p = _qplan(m, k, n, False, dtype)
            assert (p.layout, p.variant) == ("n_lanes", variant)
    assert set(qmm_k.launches_by_variant) == {"decode", "prefill"}


def _slices_after(k, p):
    """The number of K slices of the next finer split than ``p``'s."""
    nch = -(-k // 64)
    for want in range(p.ksplit + 1, nch + 1):
        cps = -(-nch // want)
        if -(-nch // cps) > p.ksplit:
            return -(-nch // cps)
    return p.ksplit


@pytest.mark.parametrize("m", [8, 16, 512, 2048])
@pytest.mark.parametrize("k,n", _Q_PROJ + [(4096, 14336), (5120, 25600)])
def test_n_lanes_grid_and_k_split(m, k, n):
    """The grid fills the H100's 132 SMs: decode (64-column blocks) splits
    K across blocks until there are two blocks for each SM, or until every
    warp walks one 64-row chunk (N = 256: 4 column blocks of 24 chunks);
    prefill (128 x 128 tiles) splits K while the tiles are fewer than the
    SMs, keeping at least 4 steps of K a slice. The slices cover K, none
    empty; a decode block has as many warps as its slice has chunks, up
    to 4 (three blocks fit an SM: one wave, which only N / 64 above 396
    column blocks, qwen3-32b's 25600, oversteps, unsplit); prefill does not
    split where its tiles already fill the card (N = 8960)."""
    p = _qplan(m, k, n, False)
    nch = -(-k // 64)
    assert p.ksplit * p.p1 >= nch > (p.ksplit - 1) * p.p1
    assert 1 <= p.ksplit <= 16
    if p.variant == "decode":
        blocks = -(-n // 64) * p.ksplit
        assert p.p0 in (1, 2, 4) and p.p0 <= p.p1
        assert p.p0 == 4 or 2 * p.p0 > p.p1
        assert blocks <= 3 * 132 or p.ksplit == 1       # one wave
        finer = _slices_after(k, p)
        assert blocks >= 2 * 132 or p.p0 == p.p1 or p.ksplit == 16 \
            or -(-n // 64) * finer > 3 * 132
    else:
        blocks = -(-n // 128) * -(-m // 128) * p.ksplit
        assert blocks >= 132 or p.p1 <= 4 or nch < 8     # no finer slices
        assert p.p1 >= 4 or p.ksplit == 1
    if n == 8960 and p.variant == "prefill":
        assert p.ksplit == 1


@pytest.mark.parametrize("m", [1, 8, 16, 17, 512, 2048])
@pytest.mark.parametrize("k,n", _Q_PROJ + [(23, 65), (1022, 777)])
@pytest.mark.parametrize("dtype", _FLOATS)
def test_n_lanes_smem_fits_the_card(m, k, n, dtype):
    """Decode: two int8 chunk stages and a (64, 72) bf16 tile per warp,
    which the KW partial sums reuse after the walk; prefill: three
    cp.async stages of raw x (bf16 rows of 72, fp32 rows of 68) and int8
    W, the widened W tile, and for fp32 x its three bf16 planes. All
    within one block's 232 448 bytes, decode leaving room for three
    blocks an SM and bf16 prefill for two."""
    p = _qplan(m, k, n, False, dtype)
    if p.variant == "decode":
        nt = 1 if m <= 8 else 2
        assert p.dynamic_smem == p.p0 * (2 * 64 * 64 + 64 * 72 * 2)
        assert p.dynamic_smem >= p.p0 * 32 * 4 * nt * 4 * 4
        assert 3 * p.dynamic_smem <= SMEM
    else:
        fp32 = dtype == torch.float32
        raw_x = 128 * 68 * 4 if fp32 else 128 * 72 * 2
        planes = 3 * 128 * 72 * 2 if fp32 else 0
        assert p.dynamic_smem == (3 * (raw_x + 64 * 128) + 64 * 136 * 2
                                  + planes)
        assert p.dynamic_smem <= SMEM
        if not fp32:
            assert 2 * p.dynamic_smem <= SMEM    # two blocks an SM


def test_n_lanes_decode_permutation_feeds_each_lane_its_x():
    """n_lanes decode writes chunk row r of W to tile row
    decode_tile_row(r), a permutation of the 64 rows; ldmatrix then reads
    tile row 16 s + j as A slot j of k16 step s, and lane t's B slots
    (2t, 2t+1, 2t+8, 2t+9) of every step are the chunk rows 16 t + 4 s +
    (0, 1, 2, 3): 16 consecutive K values of x over the chunk, so the
    products pair each level with its own x value."""
    rows = [qmm_k.decode_tile_row(r) for r in range(64)]
    assert sorted(rows) == list(range(64))
    inv = {tr: r for r, tr in enumerate(rows)}
    for s in range(4):
        for t in range(4):
            slots = (2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9)
            assert [inv[16 * s + j] for j in slots] == \
                [16 * t + 4 * s + q for q in range(4)]


# --- attn_prefill simt: shared memory, the split of S, the softmax --------

@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.int8])
@pytest.mark.parametrize("d", range(16, 257, 16))
def test_attn_prefill_simt_smem_every_head_dim(kv_dtype, d):
    """The fp32 kernel's Q tile, two buffers of K/V (fp32, or int8 bytes
    widened into one fp32 tile) and P fit one block's 232 448 bytes for
    every head_dim: 64-key blocks where they fit, else 32 (fp32 K/V from
    D = 176, int8 from D = 208); the shared memory the plan asks for is
    the kernel's layout exactly."""
    p = pf_k.plan(torch.float32, kv_dtype, 6, d)
    assert p.variant == "simt" and p.dynamic_smem <= SMEM
    quant = kv_dtype == torch.int8
    want = 4 * (64 * (d + 4) + (2 if quant else 4) * p.key_block * (d + 4)
                + 64 * (p.key_block + 4) + 128
                + (2 * (2 * p.key_block * d // 4 + 2 * p.key_block)
                   if quant else 0))
    assert p.dynamic_smem == want
    bigger = pf_k._simt_smem(d, 64, quant)
    assert p.key_block == (64 if bigger <= SMEM else 32)


@pytest.mark.parametrize("b,t,kv,g,s,splits", [
    (8, 5, 2, 6, 512, 8),          # speculative verify: 16 blocks alone
    (8, 256, 2, 6, 256, 1),        # the largest bucket: 384 blocks
    (8, 64, 2, 6, 64, 1),          # 96 blocks, one key block: nothing to split
    (8, 256, 32, 1, 256, 1),       # stablelm-3b's MHA
    (8, 16, 2, 6, 16, 1),
    (1, 5, 2, 6, 2048, 32)])
def test_attn_prefill_simt_splits_s_only_where_blocks_are_few(b, t, kv, g,
                                                              s, splits):
    """S is split across blocks (whole key blocks a split, a second kernel
    merging) where B * KV * ceil(T G / 64) blocks leave SMs idle: at the
    verify shape T = 5 (16 blocks, 8 splits of 64 keys), not at T = 256."""
    p = pf_k.plan(torch.float32, torch.float32, g, 128, b, t, kv, s)
    assert p.splits == splits
    assert p.split_len % p.key_block == 0
    assert p.splits * p.split_len >= s > (p.splits - 1) * p.split_len
    blocks = b * kv * -(-(t * g) // 64)
    if splits > 1:
        assert blocks * (splits - 1) < 132 <= blocks * splits \
            or p.split_len == p.key_block


def _tiled_softmax(scores: torch.Tensor, v: torch.Tensor,
                   lo: torch.Tensor, hi: torch.Tensor, key_block: int,
                   split_len: int) -> torch.Tensor:
    """The simt kernel's (csrc/attn_prefill.cu) softmax-weighted sum in
    fp32 torch: (R, S) scores
    of R query rows against (S, D) values, row r seeing the key positions
    lo[r] <= p < hi[r]. Each split of ``split_len`` positions walks the
    keys [min lo, max hi) of all rows inside it in blocks of ``key_block``
    from the first, keeping per row a max m, a sum l and an accumulator,
    rescaled once per block; a split no row's window reaches gives l = 0.
    The merge takes sum acc e^(m - M) / sum l e^(m - M) over the splits
    with l > 0 in order (M their largest m); a row none reached gives
    zeros, as one split dividing by l does."""
    r, s = scores.shape
    live = hi > lo
    kmin = int(lo[live].min()) if bool(live.any()) else s
    kmax = int(hi[live].max()) if bool(live.any()) else 0
    nsplit = -(-max(s, 1) // split_len)
    ms, ls, accs = [], [], []
    for sp in range(nsplit):
        a, e = max(kmin, sp * split_len), min(kmax, (sp + 1) * split_len)
        m = torch.full((r,), -1e30)
        l = torch.zeros((r,))
        acc = torch.zeros((r, v.shape[-1]))
        for k0 in range(a, e, key_block):
            pos = torch.arange(k0, min(k0 + key_block, e))
            valid = (pos[None, :] >= lo[:, None]) & (pos[None, :] < hi[:, None])
            sv = scores[:, pos]
            mx = torch.where(valid, sv, torch.tensor(-1e30)).amax(-1)
            m_new = torch.maximum(m, mx)
            corr = torch.exp(m - m_new)
            p = torch.where(valid, torch.exp(sv - m_new[:, None]),
                            torch.zeros(()))
            l = l * corr + p.sum(-1)
            acc = acc * corr[:, None] + p @ v[pos]
            m = m_new
        ms.append(m)
        ls.append(l)
        accs.append(acc)
    if nsplit == 1:
        return accs[0] / torch.clamp(ls[0], min=1e-30)[:, None]
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    big = torch.where(l > 0, m, torch.tensor(-1e30)).amax(0)
    num = torch.zeros_like(acc[0])
    den = torch.zeros_like(l[0])
    for i in range(nsplit):
        w = torch.where(l[i] > 0, torch.exp(m[i] - big), torch.zeros(()))
        num = num + acc[i] * w[:, None]
        den = den + l[i] * w
    return torch.where(den[:, None] > 0,
                       num / torch.where(den > 0, den, torch.ones(()))[:, None],
                       torch.zeros(()))


@pytest.mark.parametrize("key_block,split_len", [(64, 512), (64, 64),
                                                 (32, 96), (32, 32)])
@pytest.mark.parametrize("shape", ["prefill", "verify"])
def test_attn_prefill_tiled_softmax_matches_one_pass(key_block, split_len,
                                                     shape):
    """The simt kernel's per-key-block online softmax over its rows'
    [min lo, max hi), each split of S kept apart and merged in order,
    equals one softmax over each row's window within 1e-6 (fp32
    rounding); rows with an empty window give zeros, never NaN."""
    g = torch.Generator().manual_seed(key_block + split_len)
    s, d = 300, 16
    if shape == "prefill":
        r = 64
        hi = torch.minimum(torch.arange(r) + 1, torch.tensor(250))
        lo = torch.zeros(r, dtype=torch.int64)
        hi[5] = 0                                # an empty window
    else:
        r = 30                                   # T = 5, G = 6
        hi = (torch.arange(r) // 6 + 1 + 200).clamp(max=s)
        lo = torch.zeros(r, dtype=torch.int64)
        lo[7] = hi[7]                            # an empty window
    sc = torch.randn((r, s), generator=g) * 4
    v = torch.randn((s, d), generator=g)
    got = _tiled_softmax(sc, v, lo, hi, key_block, split_len)
    pos = torch.arange(s)
    valid = (pos[None] >= lo[:, None]) & (pos[None] < hi[:, None])
    p = torch.softmax(torch.where(valid, sc.double(),
                                  torch.tensor(float("-inf"),
                                               dtype=torch.float64)), -1)
    want = torch.nan_to_num(p) @ v.double()
    assert torch.isfinite(got).all()
    empty = ~valid.any(-1)
    assert bool(empty.any()) and torch.equal(got[empty],
                                             torch.zeros_like(got[empty]))
    assert torch.allclose(got.double(), want, rtol=1e-6, atol=1e-6)


def test_profile_attn_prefill_by_use_folds_each_merge_into_its_launch():
    """profile_engine's attribution of attn_prefill device time to
    admissions and verify: the fp32 kernel's split merge
    (``attn_prefill_kernel_merge``) is no launch of its own; its time goes
    to the launch before it, and it is counted apart."""
    from types import SimpleNamespace as NS

    from repro_torch.launch.profile_engine import (attn_prefill_ms_by_use,
                                                   launch_uses)
    cuda = torch.autograd.DeviceType.CUDA

    def ev(name, start, us):
        return NS(device_type=cuda, name=name,
                  time_range=NS(start=start, end=start + us))
    split = "void (anonymous namespace)::attn_prefill_kernel<float>(...)"
    merge = "(anonymous namespace)::attn_prefill_kernel_merge(...)"
    evs = [ev(split, 0, 100), ev(split, 200, 50), ev(merge, 260, 10),
           ev("qmatvec_kernel_decode", 270, 5), ev(split, 300, 40),
           ev(merge, 350, 4)]
    prof = NS(events=lambda: list(reversed(evs)))
    uses = launch_uses([(1, 0), (0, 1)], layers=1, draft_layers=1)
    assert uses == ["admission", "admission", "verify"]
    got = attn_prefill_ms_by_use(prof, uses)
    assert got["admission"] == pytest.approx(0.16)
    assert got["verify"] == pytest.approx(0.044)
    assert (got["admission_launches"], got["verify_launches"],
            got["merges"]) == (2, 1, 2)
    with pytest.raises(RuntimeError):
        attn_prefill_ms_by_use(prof, uses[:2])
