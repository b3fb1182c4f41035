"""The hand-written kernels on DTensor shards.

The kernels (``qmatvec``, ``qmatmul``, ``attn_decode``, ``attn_prefill``)
are ctypes launches that read plain local tensors. When a serve-form
weight or an activation is a DTensor, the model code calls them through
these helpers: each brings its operands to placements the kernel can use,
runs the kernel (through its public wrapper: the CUDA kernel on the card,
its plain version on the CPU) on the local shards, and wraps the local
result as a DTensor.

* :func:`matmul_on_shards`: a weight sharded over N gives an output
  ``Shard(-1)``; one sharded over K (the packed words of a ``qp``
  container, or the levels of a ``q`` leaf) gives fp32 partial sums that
  are all-reduced (``Partial`` -> ``Replicate``), then the bias, then the
  one cast. A replicated weight keeps the activation's batch sharding.
* :func:`decode_on_shards`: one-token attention on the cache as it is
  placed (``sharding.cache_specs``: batch over the data axes, sequence
  over ``model``): q takes the local rows, each rank attends over its own
  keys and the ranks merge their softmax statistics by all-reduces, as
  XLA's partitioner does (the kernel by its log-sum-exp, the plain
  versions by the softmax's max, sum and P . V sums); the cache is never
  gathered.
* :func:`attention_on_shards` (prefill, verify): the same on the keys as
  they are placed, T queries a row each with its own window: a
  sequence-sharded cache is merged across ranks as decode merges it,
  never gathered; batch and query heads keep their sharding where the
  keys' heads are sharded alike.
* :func:`write_on_shards`: a cache write on the rows and positions each
  rank holds (a sequence-sharded cache included), in place.
* :func:`einsum` / :func:`matmul`: a batched product of DTensors on the
  local shards, each mesh dim sharding one of the output's letters (the
  batch and head dims of the SSM state update, the experts of an MoE
  layer), forward and backward: DTensor itself flattens such operands
  into a strided sharding that its ``bmm`` / ``mm`` cannot propagate.
  Plain tensors take ``torch.einsum`` / ``torch.matmul``.

A mesh dim of size 1 holds the whole tensor on its one rank, whatever its
placement says, so it is read as ``Replicate`` with no communication: on
a one-device mesh every helper is the plain call on the whole tensors.

Every gather a helper makes because a placement cannot feed a kernel is
counted in :data:`gathers` by its reason, so a run can list them.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

__all__ = ["is_dtensor", "any_dtensor", "whole", "gathers",
           "matmul_on_shards", "einsum", "matmul", "decode_on_shards",
           "attention_on_shards", "write_on_shards", "replicate_dims",
           "align_heads", "layer"]

gathers: Dict[str, int] = {}


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def any_dtensor(*xs) -> bool:
    return any(is_dtensor(x) for x in xs)


def whole(t):
    """A DTensor's whole value as a plain tensor (a gather where it is
    sharded; every rank must call it); anything else as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def _count(reason: str):
    gathers[reason] = gathers.get(reason, 0) + 1


def _stride(shape) -> tuple:
    out, acc = [], 1
    for s in reversed(shape):
        out.append(acc)
        acc *= s
    return tuple(reversed(out))


def _wrap(local: torch.Tensor, mesh, placements, shape):
    """``local`` (made contiguous: the DTensor's stride is the global
    contiguous one) as a DTensor of global ``shape``."""
    from torch.distributed.tensor import DTensor
    shape = tuple(shape)
    return DTensor.from_local(local.contiguous(), mesh, placements,
                              run_check=False,
                              shape=torch.Size(shape), stride=_stride(shape))


def _as_dtensor(x, mesh):
    """``x`` as a DTensor on ``mesh`` (a plain tensor is every rank's same
    value: replicated), its placements on size-1 mesh dims read as
    ``Replicate`` (no communication: that dim's one rank holds it all)."""
    from torch.distributed.tensor import Replicate
    if not is_dtensor(x):
        return _wrap(x, mesh, [Replicate()] * mesh.ndim, x.shape)
    pl = [Replicate() if mesh.size(i) == 1 else p
          for i, p in enumerate(x.placements)]
    if pl == list(x.placements):
        return x
    return _wrap(x.to_local(), mesh, pl, x.shape)


def _offsets(x) -> tuple:
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    return tuple(compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, x.placements)[1])


def _redistribute(x, placements, reason: str):
    """``x`` on ``placements``, counting a gather under ``reason`` when a
    sharded or partial dim becomes replicated."""
    from torch.distributed.tensor import Replicate
    cur = list(x.placements)
    if cur == list(placements):
        return x
    if any(isinstance(t, Replicate) and not isinstance(c, Replicate)
           for c, t in zip(cur, placements)):
        _count(reason)
    return x.redistribute(x.device_mesh, list(placements))


def replicate_dims(x, dims: Sequence[int], reason: str):
    """``x`` with tensor dims ``dims`` (and any partial sum) replicated on
    every mesh dim; other placements kept. A plain tensor comes back as it
    is."""
    from torch.distributed.tensor import Replicate, Shard
    if not is_dtensor(x):
        return x
    x = _as_dtensor(x, x.device_mesh)
    dims = {d % x.ndim for d in dims}
    want = [Replicate() if (isinstance(p, Shard) and p.dim in dims)
            or p.is_partial() else p for p in x.placements]
    return _redistribute(x, want, reason)


def _whole(t, mesh, reason: str):
    """The whole value of ``t`` (plain or DTensor) as a plain tensor."""
    from torch.distributed.tensor import Replicate
    if t is None or not is_dtensor(t):
        return t
    return _redistribute(_as_dtensor(t, mesh), [Replicate()] * mesh.ndim,
                         reason).to_local()


def _rows_local(t, mesh, row_pl):
    """The local rows of a per-row tensor ``t`` (dim 0 = batch; a 0-d
    tensor is every row's) under the batch placements ``row_pl``."""
    if t is None:
        return None
    from torch.distributed.tensor import Replicate, Shard
    if not isinstance(t, torch.Tensor) or t.dim() == 0:
        return _whole(t, mesh, "per-row operand")
    want = [Shard(0) if isinstance(p, Shard) else Replicate()
            for p in row_pl]
    return _redistribute(_as_dtensor(t, mesh), want,
                         "per-row operand").to_local()


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous: a local
    gradient that ``torch.einsum``'s backward leaves permuted becomes a
    DTensor (``to_local``'s backward) whose later ``view`` fails on every
    rank."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def einsum(eq: str, *ops, grad_on_shards: bool = True):
    """``torch.einsum(eq, *ops)``; with a DTensor operand, on the local
    shards. Each mesh dim keeps sharding the letter the first operand
    sharded on it there, where that letter is one of the output's: every
    operand holding the letter is sharded on it alike (a replicated one
    takes its local slice, no communication), the others are replicated on
    that mesh dim. A sharded contracted letter is gathered. The result is
    a DTensor sharded on those letters.

    Differentiable, under the same rule: the local product is
    ``torch.einsum`` (its own backward, on the shards), the output's
    gradient comes back to the output's placements, and each operand's
    local gradient is declared with the placements it has
    (``to_local(grad_placements=)``): sharded on a kept letter it holds,
    ``Partial`` on a mesh dim whose kept letter it lacks (it met only its
    rank's slice of that letter), which the redistribution that placed the
    operand reduces. Every rank issues the same collectives in the same
    order, an empty shard included: none depends on a shard's size.
    DTensor's own einsum flattens such operands into a strided sharding
    that its ``bmm`` (and, in a backward, ``mm``) cannot propagate. With
    ``grad_on_shards=False`` an operand that needs a gradient takes
    DTensor's own einsum (whose backward runs the global product's
    decomposition on the shards, as one process would round it)."""
    if not any_dtensor(*ops) or (not grad_on_shards and torch.is_grad_enabled()
                                 and any(getattr(o, "requires_grad", False)
                                         for o in ops)):
        return torch.einsum(eq, *ops)
    from torch.distributed.tensor import Partial, Replicate, Shard
    ins, out = eq.replace(" ", "").split("->")
    ins = ins.split(",")
    if "." in eq or len(ins) != len(ops) or any(
            len(set(x)) != len(x) for x in ins + [out]):
        raise ValueError(f"shards.einsum: explicit letters only, each "
                         f"once an operand, got {eq!r}")
    mesh = next(o for o in ops if is_dtensor(o)).device_mesh
    ops = [_as_dtensor(o, mesh) for o in ops]
    size = {c: n for o, letters in zip(ops, ins)
            for c, n in zip(letters, o.shape)}
    keep = []                        # the letter each mesh dim shards
    for i in range(mesh.ndim):
        letter = None
        for o, letters in zip(ops, ins):
            p = o.placements[i]
            if isinstance(p, Shard) and type(p) is Shard:
                letter = letters[p.dim]
                break
        keep.append(letter if letter is not None and letter in out
                    else None)
    local = []
    for o, letters in zip(ops, ins):
        want = [Shard(letters.index(c)) if c is not None and c in letters
                else Replicate() for c in keep]
        grad_pl = [Replicate() if c is None else
                   Shard(letters.index(c)) if c in letters else Partial()
                   for c in keep]
        local.append(_ContiguousGrad.apply(_redistribute(
            o, want, "einsum operand").to_local(grad_placements=grad_pl)))
    pl = [Shard(out.index(c)) if c is not None else Replicate()
          for c in keep]
    return _wrap(torch.einsum(eq, *local), mesh, pl,
                 [size[c] for c in out])


def matmul(a, b):
    """``a @ b`` for operands of one rank >= 3 (batch dims, then the
    matrices); with a DTensor operand, on the local shards (see
    :func:`einsum`)."""
    if not any_dtensor(a, b):
        return torch.matmul(a, b)
    if a.dim() != b.dim() or a.dim() < 3 or a.dim() > 24:
        raise ValueError(f"shards.matmul: operands of one rank >= 3, got "
                         f"{a.dim()} and {b.dim()}")
    batch = "abcdefghijklmnopqrstuvw"[:a.dim() - 2]
    return einsum(f"{batch}xy,{batch}yz->{batch}xz", a, b)


def align_heads(q, k, v):
    """q, k, v with their head dims (2) sharded alike on every mesh dim,
    as a GQA reshape of q needs; where they differ (KV heads that the
    model axis does not divide are replicated by the rules) the heads are
    gathered. Attention against a cache takes :func:`decode_on_shards` or
    :func:`attention_on_shards` instead, which keep the cache's sequence
    sharded."""
    from torch.distributed.tensor import Shard
    if not any_dtensor(q, k, v):
        return q, k, v
    mesh = next(t for t in (q, k, v) if is_dtensor(t)).device_mesh
    q, k, v = (_as_dtensor(t, mesh) for t in (q, k, v))
    heads = [[p == Shard(2) for p in t.placements] for t in (q, k, v)]
    if heads[0] != heads[1] or heads[1] != heads[2]:
        q, k, v = (replicate_dims(t, [2], "attention heads (GQA)")
                   for t in (q, k, v))
    return q, k, v


def matmul_on_shards(x, w, run: Callable, *, delta, bias, k: int,
                     packed: bool, out_dtype):
    """``run(x_local, w_local, delta_local, bias_local, k_local,
    out_dtype)`` on each rank's shards of ``x`` (..., K) and the 2-D weight
    ``w`` ((KP, N) container words when ``packed``, else (K, N) levels);
    ``delta`` (N,) or a scalar, ``bias`` (N,) or None. Returns the (..., N)
    output as a DTensor."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = (w if is_dtensor(w) else x).device_mesh
    x, w = _as_dtensor(x, mesh), _as_dtensor(w, mesh)
    xd = x.ndim
    x_pl, out_pl, k_split = [], [], False
    for i, wp in enumerate(w.placements):
        xp = x.placements[i]
        if isinstance(wp, Shard) and wp.dim == w.ndim - 1:     # over N
            x_pl.append(Replicate())
            out_pl.append(Shard(xd - 1))
        elif isinstance(wp, Shard):                            # over K
            k_split = True
            x_pl.append(Replicate() if packed else Shard(xd - 1))
            out_pl.append(Partial())
        elif isinstance(xp, Shard) and xp.dim < xd - 1:        # batch rows
            x_pl.append(xp)
            out_pl.append(xp)
        else:
            x_pl.append(Replicate())
            out_pl.append(Replicate())
    x = _redistribute(x, x_pl, "matmul activation")
    xl, wl = x.to_local(), w.to_local()
    off = _offsets(w)
    # per-column operands take w's sharding of N (a local chunk, no
    # communication when they are replicated)
    n_pl = [Shard(0) if isinstance(p, Shard) and p.dim == w.ndim - 1
            else Replicate() for p in w.placements]

    def cols(t):
        if not isinstance(t, torch.Tensor) or t.numel() == 1:
            return _whole(t, mesh, "matmul per-column operand")
        t = _as_dtensor(t, mesh) if is_dtensor(t) else _wrap(
            t.reshape(-1), mesh, [Replicate()] * mesh.ndim, (t.numel(),))
        return _redistribute(t.reshape(-1), n_pl,
                             "matmul per-column operand").to_local()

    d, b = cols(delta), cols(bias)
    if packed:
        r0 = off[-2] * 10
        k_l = min(wl.shape[-2] * 10, k - r0)
        xl = xl[..., r0:r0 + k_l]
    else:
        k_l = xl.shape[-1]
    want = out_dtype or x.dtype
    shape = tuple(x.shape[:-1]) + (w.shape[-1],)
    if not k_split:
        return _wrap(run(xl, wl, d, b, k_l, out_dtype), mesh, out_pl, shape)
    # partial sums in fp32, all-reduced, then the bias and the one cast
    out = _wrap(run(xl, wl, d, None, k_l, torch.float32), mesh, out_pl,
                shape)
    out = out.redistribute(mesh, [Replicate() if p.is_partial() else p
                                  for p in out_pl])
    if b is not None:      # b is this rank's N range, as out's local is
        out = _wrap(out.to_local() + b.to(torch.float32), mesh,
                    out.placements, shape)
    return out.to(want)


def attention_on_shards(run: Callable, q, k, v, hi, lo=None, k_scale=None,
                        v_scale=None):
    """Windowed attention of q (B, T, H, D) against k / v (B, S, KV, D)
    (prefill, verify) on each rank's shards, the keys left as they are
    placed where q does not shard the same sequence.

    Per mesh dim: where the keys' sequence is sharded and q's is not, q is
    replicated there and the ranks of that dim reduce together; where
    either batch is sharded, both take their local rows (a slice where one
    is replicated there); where both q's and the keys' heads are sharded
    alike, they stay; every other dim is gathered (q and the keys sharded
    on the same sequence among them). Each rank attends over its own keys with its local window,
    ``clamp(hi - s0, 0, S_local)`` and the same of ``lo``: ``run(q, k, v,
    hi, lo, k_scale, v_scale, reduce=)`` -> (B_l, T, H_l, D), where
    ``reduce(t, op)`` all-reduces ``t`` (``op`` "max" or "sum") over the
    mesh dims that shard the keys' sequence, in the same order on every
    rank, and is None where none does. ``hi`` / ``lo`` (B, T) per-row
    windows (``lo`` None for all zeros); ``k_scale`` / ``v_scale`` (B, S)
    int8 scales follow the keys. Returns the (B, T, H, D) output as a
    DTensor."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = next(t for t in (q, k, v) if is_dtensor(t)).device_mesh
    q, k, v = (_as_dtensor(t, mesh) for t in (q, k, v))
    v = _redistribute(v, list(k.placements), "attention values")
    q_pl, kv_pl, row_pl, merge = [], [], [], []
    for i in range(mesh.ndim):
        qp, kp = q.placements[i], k.placements[i]
        if kp == Shard(1) and qp != Shard(1):             # local keys
            q_pl.append(Replicate())
            kv_pl.append(Shard(1))
            row_pl.append(Replicate())
            merge.append(i)
        elif qp == Shard(0) or kp == Shard(0):            # local rows
            q_pl.append(Shard(0))
            kv_pl.append(Shard(0))
            row_pl.append(Shard(0))
        elif qp == Shard(2) and kp == Shard(2):           # local heads
            q_pl.append(Shard(2))
            kv_pl.append(Shard(2))
            row_pl.append(Replicate())
        else:
            q_pl.append(Replicate())
            kv_pl.append(Replicate())
            row_pl.append(Replicate())
    ql = _redistribute(q, q_pl, "attention q").to_local()
    kd = _redistribute(k, kv_pl, "attention keys")
    kl = kd.to_local()
    vl = _redistribute(v, kv_pl, "attention values").to_local()
    sc_pl = [p if isinstance(p, Shard) and p.dim < 2 else Replicate()
             for p in kv_pl]
    scales = [None if t is None else _redistribute(
        _as_dtensor(t, mesh), sc_pl, "attention keys").to_local()
        for t in (k_scale, v_scale)]
    hi, lo = (_rows_local(t, mesh, row_pl) for t in (hi, lo))
    reduce = None
    if merge:
        s0, sl = _offsets(kd)[1], kl.shape[1]
        hi, lo = (None if t is None else torch.clamp(
            t.to(torch.int32) - s0, 0, sl) for t in (hi, lo))
        reduce = lambda t, op: _reduce(t, mesh, merge, op)     # noqa: E731
    out = run(ql, kl, vl, hi, lo, *scales, reduce=reduce)
    return _wrap(out, mesh, q_pl, tuple(q.shape[:3]) + (v.shape[-1],))


def layer(buf, i: int):
    """``buf[i]`` of a stacked (L, ...) cache leaf: for a DTensor, the
    local shard's entry wrapped with the same placements on the remaining
    dims (no communication, and no global-shape propagation, which for a
    long cache allocates a whole-cache meta tensor a call). A leaf
    sharded on its layer dim is indexed by DTensor itself."""
    if not is_dtensor(buf):
        return buf[i]
    from torch.distributed.tensor import Shard
    if any(isinstance(p, Shard) and p.dim == 0 for p in buf.placements):
        return buf[i]
    pl = [Shard(p.dim - 1) if isinstance(p, Shard) else p
          for p in buf.placements]
    return _wrap(buf.to_local()[i], buf.device_mesh, pl, buf.shape[1:])


def _reduce(t, mesh, dims, op: str):
    """``t`` all-reduced with ``op`` over each mesh dim in ``dims`` (every
    rank calls it, in the same order)."""
    from torch.distributed import _functional_collectives as funcol
    for i in dims:
        t = funcol.wait_tensor(funcol.all_reduce(t, op, (mesh, i)))
    return t


def decode_on_shards(run: Callable, q, k, v, cache_len, k_scale=None,
                     v_scale=None):
    """One-token attention of q (B, 1, H, D) against a (B, S, KV, D)
    cache on each rank's shards, the cache left as it is placed: the
    T = 1 case of :func:`attention_on_shards`, ``cache_len`` (a scalar or
    (B,)) its ``hi``. Each rank attends over its own keys with its local
    lengths, ``clamp(len - s0, 0, S_local)``: ``run(q, k, v, lens,
    k_scale, v_scale, reduce=)`` -> (B_l, 1, H_l, D), ``lens`` (B_l,).
    Returns a DTensor."""
    if not is_dtensor(cache_len):
        dev = (q.to_local() if is_dtensor(q) else q).device
        cache_len = torch.as_tensor(cache_len, device=dev)

    def run_decode(ql, kl, vl, hi, lo, k_scale, v_scale, reduce):
        lens = hi.reshape(-1).expand(ql.shape[0])
        return run(ql, kl, vl, lens, k_scale, v_scale, reduce=reduce)

    return attention_on_shards(run_decode, q, k, v, cache_len, None,
                               k_scale, v_scale)


def write_on_shards(buf, i: int, rows, slot, vals,
                    keep: Optional[torch.Tensor] = None, src=None):
    """``buf[i, rows, slot] = vals`` in place on a (L, B, S, ...) DTensor
    cache, each rank writing the entries it holds (its rows and, for a
    sequence-sharded cache, its positions). ``rows`` and ``slot`` are
    global index tensors that broadcast together to ``vals``'s leading
    dims (``vals[rows, src]`` when ``src`` is given); an entry with
    ``keep`` False is not written. Every operand is
    first made whole (they are one token's or one verify's K/V: small).
    The written entries are picked by a boolean mask (a host sync): the
    sharded cells run eagerly."""
    mesh = buf.device_mesh
    rows, slot = (_whole(t, mesh, "cache index") for t in (rows, slot))
    keep = _whole(keep, mesh, "cache index")
    vals = _whole(vals, mesh, "cache write values")
    loc = buf.to_local()
    off = _offsets(_as_dtensor(buf, mesh))
    b0, s0 = off[1], off[2]
    bl, sl = loc.shape[1], loc.shape[2]
    lead = torch.broadcast_shapes(rows.shape, slot.shape)
    rows_b, slot_b = rows.expand(lead).long(), slot.expand(lead).long()
    if src is not None:
        vals = vals[rows_b, _whole(src, mesh, "cache index").expand(lead)]
    mine = ((rows_b >= b0) & (rows_b < b0 + bl)
            & (slot_b >= s0) & (slot_b < s0 + sl))
    if keep is not None:
        mine = mine & keep.expand(lead)
    sel = mine.nonzero(as_tuple=True)
    loc[i, rows_b[sel] - b0, slot_b[sel] - s0] = vals[sel].to(loc.dtype)
