"""GPipe-style microbatch pipeline over a ``stage`` mesh dim — port of the
reference's ``distributed/pipeline.py`` on ``torch.distributed``
point-to-point sends.

Each rank of the ``stage`` dim holds one stage's params (stacked on a
leading stage dim: every rank passes the whole stack, or a DTensor sharded
over ``stage``, and keeps its own row). The schedule runs
``n_micro + n_stages - 1`` ticks; at tick t, stage s processes microbatch
``t - s`` (bubble fraction (S-1)/(T+S-1)). Between ticks every stage sends
its output to stage + 1 and receives stage - 1's; the last stage's outputs
are then broadcast, so every rank returns them.

Differentiable: the send-receive is an autograd function whose backward
sends the gradient back to stage - 1 and receives stage + 1's, so a
backward through ``pipeline_apply`` runs the reverse pipeline (GPipe
semantics: every activation kept, no interleaving). The broadcast of the
outputs is a replicated value's: its gradient is taken once, from the last
stage, not summed over the ranks that each hold a copy of the loss.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.treeutil import tree_map

__all__ = ["pipeline_apply"]


def _peers(mesh, axis: str):
    import torch.distributed as dist
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)
    return group, ranks, mesh.get_local_rank(axis)


def _exchange(sends, recvs, group):
    """Post every (tensor, peer) send and receive at once, then wait."""
    import torch.distributed as dist
    ops = [dist.P2POp(dist.isend, t, p, group) for t, p in sends]
    ops += [dist.P2POp(dist.irecv, t, p, group) for t, p in recvs]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


class _Shift(torch.autograd.Function):
    """y to the next stage; the previous stage's y (zeros on stage 0)."""

    @staticmethod
    def forward(ctx, y, group, prev, nxt):
        ctx.group, ctx.prev, ctx.nxt = group, prev, nxt
        y = y.contiguous()
        got = torch.zeros_like(y)
        _exchange([(y, nxt)] if nxt is not None else [],
                  [(got, prev)] if prev is not None else [], group)
        return got

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        gy = torch.zeros_like(g)
        _exchange([(g, ctx.prev)] if ctx.prev is not None else [],
                  [(gy, ctx.nxt)] if ctx.nxt is not None else [], ctx.group)
        return gy, None, None, None


class _FromLast(torch.autograd.Function):
    """The last stage's ``outs`` on every rank. ``tail`` (the rank's last
    received state) only ties the rank's own pipeline into the graph, so
    that a backward from the output runs every rank's reverse pipeline."""

    @staticmethod
    def forward(ctx, outs, tail, group, src, is_src):
        import torch.distributed as dist
        ctx.is_src, ctx.tail = is_src, (tail.shape, tail.dtype, tail.device)
        out = outs.detach().clone().contiguous()
        dist.broadcast(out, src=src, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        # every rank holds the same loss of a replicated output: its
        # gradient is taken once, on the stage that made it
        shape, dtype, device = ctx.tail
        return (g if ctx.is_src else torch.zeros_like(g),
                torch.zeros(shape, dtype=dtype, device=device), None, None,
                None)


def _my_stage(p, s: int):
    from torch.distributed.tensor import DTensor
    if isinstance(p, DTensor):         # sharded over ``stage``: one row here
        return p.to_local()[0]
    return p[s]


def pipeline_apply(stage_fn: Callable, stage_params, x_micro: torch.Tensor,
                   mesh, axis: str = "stage") -> torch.Tensor:
    """Run microbatches through a linear pipeline.

    stage_fn(params_one_stage, x: (B, ...)) -> (B, ...), same in/out shape
    stage_params: tree with leading stage dim == the mesh's ``axis`` size
    x_micro: (n_micro, B, ...) microbatched input, the same on every rank
    Returns (n_micro, B, ...) outputs, the same on every rank.
    """
    group, ranks, s = _peers(mesh, axis)
    n_stages, n_micro = len(ranks), x_micro.shape[0]
    prev = ranks[s - 1] if s > 0 else None
    nxt = ranks[s + 1] if s < n_stages - 1 else None
    params = tree_map(lambda p: _my_stage(p, s), stage_params)
    first = torch.tensor(s == 0, device=x_micro.device)
    state = torch.zeros_like(x_micro[0])
    outs = []
    for t in range(n_micro + n_stages - 1):
        inject = x_micro[min(t, n_micro - 1)]
        y = stage_fn(params, torch.where(first, inject, state))
        if s == n_stages - 1 and t >= n_stages - 1:
            outs.append(y)
        state = _Shift.apply(y, group, prev, nxt)
    if not outs:                       # not the last stage: a placeholder
        outs = [torch.zeros_like(state)] * n_micro
    return _FromLast.apply(torch.stack(outs), state, group, ranks[-1],
                           s == n_stages - 1)
