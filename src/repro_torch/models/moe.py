"""Mixture-of-Experts FFN block (phi3.5-moe 16e/top-2, mixtral-8x22b 8e/top-2)
— port of the reference's ``models/moe.py``.

Capacity-based dense dispatch: tokens are grouped (``GROUP_SIZE`` a group,
one group when the token count is not a multiple of it), routed top-k, and
moved to (expert, capacity) buffers with one-hot products; a token choice
past its expert's capacity is dropped. Choice 0 of every token in a group
outranks choice 1 (choice-major ranking), so capacity couples the rows of
a batch, as in the reference. The Switch auxiliary load-balancing loss is
returned beside the output (serving ignores it).

Weight forms: the expert up / gate / down stacks (E, K, F) carry role
'hidden' and the router (d, E) role 'router' (8-bit under W3A8). Both
exports keep the expert stacks as int8 levels ``{"q": (E, K, F), "delta":
(1, 1, F)}`` (one delta per layer and output channel, shared by the
experts). In 'kernel' mode each expert is one ``qmatmul`` of its (M, K)
buffer against ``q[e]``, a contiguous row-major (K, F) view: the
``n_lanes`` layout (its decode kernel for M <= 16, its GEMM above), the
reference's ``lax.map`` of the Pallas qmatmul. The router's (d, E) levels
with E <= 64 columns take qmatmul's row-major ``k_lanes`` layout, fp32
out. 'dequant' mode is the reference's plain path: one product of the
levels cast to the activation dtype with fp32 accumulation, delta on the
output; it counts as E plain calls of qmatmul. Neither mode materialises
a dequantized expert matrix. The dispatch and combine products stay
library matmuls, as the reference leaves them to XLA.

:func:`trace_routing` records every call's routing (top-k experts, the
router probabilities, the kept mask) for a comparison of two paths.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import quant_dense
from repro_torch.core.precision import QuantPolicy
from repro_torch.distributed import shards
from repro_torch.distributed.context import constrain
from repro_torch.kernels.qmatmul import ops as qmm_ops
from repro_torch.kernels.qmatmul import ref as qmm_ref
from repro_torch.models.layers import act_fn, dget

__all__ = ["moe_init", "moe_apply", "groups", "trace_routing", "GROUP_SIZE"]

GROUP_SIZE = 512  # tokens per routing group (keeps dispatch tensors small)

_trace: Optional[List[Dict[str, torch.Tensor]]] = None


@contextlib.contextmanager
def trace_routing():
    """Within the block, every :func:`moe_apply` call appends its routing
    to the yielded list, in call order (one entry a layer a forward):
    ``top_i`` (ng, g, k) chosen experts, ``probs`` (ng, g, E) the router
    probabilities, ``keep`` (ng, g, k) whether each choice got a capacity
    slot. For eager runs only."""
    global _trace
    prev, _trace = _trace, []
    try:
        yield _trace
    finally:
        _trace = prev


def groups(cfg: ModelConfig, t: int) -> Tuple[int, int, int]:
    """How ``moe_apply`` routes ``t`` tokens: (groups, tokens a group,
    capacity of each expert in a group). Each expert product then has
    groups x capacity rows."""
    g = min(GROUP_SIZE, t)
    ng = t // g if t % g == 0 else 1
    if t % g != 0:                      # a token count off the group size
        g = t
    k, e = cfg.experts_per_token, cfg.num_experts
    return ng, g, max(1, int(cfg.capacity_factor * g * k / e))


def _uniform(gen, shape, scale, dtype, device):
    w = torch.rand(shape, generator=gen, dtype=dtype, device=device)
    return w.mul_(2.0).sub_(1.0).mul_(scale)


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
             device=None) -> Dict[str, Any]:
    """Random float master weights from ``gen`` in the reference's tree:
    router N(0, 0.02^2) (d, E); up / gate U(-1, 1) / sqrt(d) and down
    U(-1, 1) / sqrt(F), stacked over experts."""
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    router = torch.randn((d, e), generator=gen, dtype=dtype, device=device)
    p = {"router": {"w": router.mul_(0.02)},
         "up": {"w": _uniform(gen, (e, d, f), 1.0 / math.sqrt(d), dtype,
                              device)},
         "down": {"w": _uniform(gen, (e, f, d), 1.0 / math.sqrt(f), dtype,
                                device)}}
    if cfg.mlp_act == "silu":
        p["gate"] = {"w": _uniform(gen, (e, d, f), 1.0 / math.sqrt(d), dtype,
                                   device)}
    return p


def _expert_matmul(params, name: str, buf: torch.Tensor, policy: QuantPolicy,
                   mode: str, deltas: Optional[Dict] = None) -> torch.Tensor:
    """buf (ng, E, C, K) x expert stack (E, K, F) -> (ng, E, C, F) in buf's
    dtype, for any weight form."""
    leaf = params[name]
    if "q" in leaf:
        q, delta = leaf["q"], leaf["delta"]          # (E, K, F), (1, 1, F)
        e, f = q.shape[0], q.shape[-1]
        if quant_dense.resolve_matmul_mode(mode, buf.device) == "kernel":
            ng, _, cap, k = buf.shape
            xb = buf.transpose(0, 1).reshape(e, ng * cap, k)
            # delta is per layer (1, 1, F) or per expert (E, 1, F)
            de = delta.expand(e, 1, f)
            y = torch.stack([qmm_ops.qmatmul(xb[i], q[i], de[i].reshape(-1))
                             for i in range(e)])
            return y.reshape(e, ng, cap, f).transpose(0, 1)
        qmm_ref.calls += e
        acc = torch.einsum("necd,edf->necf", buf.to(torch.float32),
                           q.to(torch.float32))
        return (acc * delta[None].to(torch.float32)).to(buf.dtype)
    w = quant_dense.effective_weight(leaf, policy, "hidden",
                                     dget(deltas, name, "w"))
    return torch.einsum("necd,edf->necf", buf, w.to(buf.dtype))


def moe_apply(params: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig, *,
              policy: QuantPolicy, deltas: Optional[Dict] = None,
              matmul_mode: str = "auto"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d) in x's dtype, aux loss fp32 scalar).
    ``deltas``: this layer's frozen step sizes of the float master (None:
    refit in the forward)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    ng, g, cap = groups(cfg, b * s)
    xg = x.reshape(ng, g, d)

    router = params["router"]
    if "q" in router:
        # fp32 logits: rounding them through bf16 activations could flip a
        # near-tie of the top-k against the float-weight branch below
        logits = quant_dense.serve_apply(router, xg, mode=matmul_mode,
                                         out_dtype=torch.float32)
    else:
        wr = quant_dense.effective_weight(router, policy, "router",
                                          dget(deltas, "router", "w"))
        logits = torch.matmul(xg.to(torch.float32),
                              wr.to(x.dtype).to(torch.float32))
    probs = torch.softmax(logits.to(torch.float32), dim=-1)    # (ng, g, E)
    top_p, top_i = torch.topk(probs, k, dim=-1)                # (ng, g, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # aux load-balance loss (Switch): E * sum(frac_tokens * frac_probs)
    density = (top_i[..., 0:1] == torch.arange(e, device=x.device)) \
        .to(torch.float32).mean(dim=1)                         # (ng, E)
    density_p = probs.mean(dim=1)
    aux = (density * density_p).sum(-1).mean() * (e ** 2) / k

    # choice-major flattening: choice 0 of every token outranks choice 1
    # (a DTensor's token dim is gathered first: merging it with the choice
    # dim would make a strided sharding no op after it takes)
    choice = shards.replicate_dims(top_i, [1], "moe routing") \
        .transpose(1, 2).reshape(ng, k * g)                    # (ng, kg)
    sel = (choice[..., None] == torch.arange(e, device=x.device)) \
        .to(torch.int32)                                       # (ng, kg, E)
    pos = torch.cumsum(sel, dim=1, dtype=torch.int32) - 1      # slot in expert
    keep = (pos < cap) & (sel > 0)
    # a dropped or unselected (token, expert) pair matches no slot
    slot = torch.where(keep, pos, torch.full_like(pos, -1))
    disp = (slot[..., None] == torch.arange(cap, device=x.device)) \
        .to(x.dtype)                                           # (ng, kg, E, C)
    disp = constrain(disp, "moe_dispatch")
    wts = shards.replicate_dims(top_p, [1], "moe routing") \
        .transpose(1, 2).reshape(ng, k * g).to(x.dtype)
    comb = disp * wts[..., None, None]
    if _trace is not None:
        kept = keep.any(dim=-1).reshape(ng, k, g).transpose(1, 2)
        _trace.append({"top_i": top_i, "probs": probs, "keep": kept})

    xk = xg.repeat(1, k, 1)                                    # (ng, kg, d)
    buf = torch.bmm(disp.reshape(ng, k * g, e * cap).transpose(1, 2), xk)
    buf = constrain(buf.reshape(ng, e, cap, d), "moe_buffer")

    act = act_fn(cfg.mlp_act)
    h = _expert_matmul(params, "up", buf, policy, matmul_mode, deltas)
    if "gate" in params:
        h = act(_expert_matmul(params, "gate", buf, policy, matmul_mode,
                               deltas)) * h
    else:
        h = act(h)
    out_buf = _expert_matmul(params, "down", h, policy, matmul_mode, deltas)
    out_buf = constrain(out_buf, "moe_buffer")

    yk = torch.bmm(comb.reshape(ng, k * g, e * cap),
                   out_buf.reshape(ng, e * cap, d))            # (ng, kg, d)
    y = yk.reshape(ng, k, g, d).sum(dim=1)
    return y.reshape(b, s, d), aux.to(torch.float32)
