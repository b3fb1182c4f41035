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
* :func:`attention_on_shards`: batch and query heads keep their sharding
  where the keys' heads are sharded alike; the key sequence is gathered.
* :func:`write_on_shards`: a cache write on the rows and positions each
  rank holds (a sequence-sharded cache included), in place.
* :func:`einsum` / :func:`matmul`: a batched product of DTensors on the
  local shards, each mesh dim sharding one of the output's letters (the
  batch and head dims of the SSM state update), for the serve paths:
  DTensor itself flattens such operands into a strided sharding that its
  ``bmm`` cannot propagate. Plain tensors, and operands that need a
  gradient, take ``torch.einsum`` / ``torch.matmul``.

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
           "matmul_on_shards", "einsum", "matmul",
           "attention_on_shards", "write_on_shards", "replicate_dims",
           "align_heads"]

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


def einsum(eq: str, *ops):
    """``torch.einsum(eq, *ops)``; with a DTensor operand, on the local
    shards. Each mesh dim keeps sharding the letter the first operand
    sharded on it there, where that letter is one of the output's: every
    operand holding the letter is sharded on it alike (a replicated one
    takes its local slice, no communication), the others are replicated on
    that mesh dim. A sharded contracted letter is gathered. The result is
    a DTensor sharded on those letters. Only without autograd (the serve
    paths): an operand that needs a gradient takes DTensor's own einsum."""
    if not any_dtensor(*ops) or (torch.is_grad_enabled() and any(
            getattr(o, "requires_grad", False) for o in ops)):
        return torch.einsum(eq, *ops)
    from torch.distributed.tensor import Replicate, Shard
    ins, out = eq.replace(" ", "").split("->")
    ins = ins.split(",")
    if "." in eq or len(ins) != len(ops):
        raise ValueError(f"shards.einsum: explicit letters only, got {eq!r}")
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
        local.append(_redistribute(o, want, "einsum operand").to_local())
    pl = [Shard(out.index(c)) if c is not None else Replicate()
          for c in keep]
    return _wrap(torch.einsum(eq, *local), mesh, pl,
                 [size[c] for c in out])


def matmul(a, b):
    """``a @ b`` for operands of one rank >= 3 (batch dims, then the
    matrices); with a DTensor operand and no autograd, on the local shards
    (see :func:`einsum`)."""
    if not any_dtensor(a, b) or (torch.is_grad_enabled() and (
            a.requires_grad or b.requires_grad)):
        return torch.matmul(a, b)
    if a.dim() != b.dim() or a.dim() < 3 or a.dim() > 24:
        raise ValueError(f"shards.matmul: operands of one rank >= 3, got "
                         f"{a.dim()} and {b.dim()}")
    batch = "abcdefghijklmnopqrstuvw"[:a.dim() - 2]
    return einsum(f"{batch}xy,{batch}yz->{batch}xz", a, b)


def align_heads(q, k, v, *scales):
    """q, k, v with their head dims (2) sharded alike on every mesh dim,
    as a GQA reshape of q needs; where they differ (KV heads that the
    model axis does not divide are replicated by the rules) the heads are
    gathered. With ``scales`` (a decode or verify against a cache: the
    int8 cache's (B, S) scales, or None) the cache's sequence is gathered
    too, as the kernels' path gathers it, so no partial sum over keys is
    rounded before its reduction. Returns (q, k, v, *scales)."""
    from torch.distributed.tensor import Shard
    if not any_dtensor(q, k, v):
        return (q, k, v) + scales
    mesh = next(t for t in (q, k, v) if is_dtensor(t)).device_mesh
    q, k, v = (_as_dtensor(t, mesh) for t in (q, k, v))
    if scales:
        k, v = (replicate_dims(t, [1], "attention keys") for t in (k, v))
        scales = tuple(None if t is None else replicate_dims(
            _as_dtensor(t, mesh), [1], "attention keys") for t in scales)
    heads = [[p == Shard(2) for p in t.placements] for t in (q, k, v)]
    if heads[0] != heads[1] or heads[1] != heads[2]:
        q, k, v = (replicate_dims(t, [2], "attention heads (GQA)")
                   for t in (q, k, v))
    return (q, k, v) + scales


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


def attention_on_shards(run: Callable, q, k, v, *, rows=(), row_seq=()):
    """``run(q, k, v, *rows_local, *row_seq_local)`` on local shards of
    q (B, T, H, D) and k / v (B, S, KV, D): batch rows stay sharded where
    q's are (k, v and the per-row operands follow), query and key heads
    stay sharded where both are sharded alike on a mesh dim, and every
    other dim, the key sequence among them, is gathered. ``rows``: per-row
    tensors (B, ...); ``row_seq``: per-row, per-key tensors (B, S) (int8
    scales). Returns the (B, T, H, D) output as a DTensor."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = next(t for t in (q, k, v) if is_dtensor(t)).device_mesh
    q, k, v = (_as_dtensor(t, mesh) for t in (q, k, v))
    q_pl, kv_pl, row_pl = [], [], []
    for i in range(mesh.ndim):
        qp, kp, vp = q.placements[i], k.placements[i], v.placements[i]
        if isinstance(qp, Shard) and qp.dim == 0:
            q_pl.append(Shard(0))
            kv_pl.append(Shard(0))
            row_pl.append(Shard(0))
        elif (isinstance(qp, Shard) and qp.dim == 2 and kp == Shard(2)
              and vp == Shard(2)):
            q_pl.append(Shard(2))
            kv_pl.append(Shard(2))
            row_pl.append(Replicate())
        else:
            q_pl.append(Replicate())
            kv_pl.append(Replicate())
            row_pl.append(Replicate())
    ql = _redistribute(q, q_pl, "attention q").to_local()
    kl = _redistribute(k, kv_pl, "attention keys").to_local()
    vl = _redistribute(v, kv_pl, "attention values").to_local()
    extra = [_rows_local(t, mesh, row_pl) for t in rows]
    extra += [_rows_local(t, mesh, row_pl) for t in row_seq]
    out = run(ql, kl, vl, *extra)
    return _wrap(out, mesh, q_pl, tuple(q.shape[:3]) + (v.shape[-1],))


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
