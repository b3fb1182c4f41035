"""Shared model layers: norms, RoPE, MLPs, embeddings — all quantizable.

Port of the reference's ``models/layers.py``. Every weight matmul routes
through ``quant_dense.apply`` so the W3A8 policy applies uniformly; norms
and biases stay fp32. ``deltas`` / ``delta`` (default None) are frozen
step sizes for a float master under a quantizing policy
(``quant_dense.fit_deltas_stacked``, one layer's slice of them here); None
refits each weight's delta in every forward. The logits pass through the
``"logits"`` sharding constraint (``distributed.context.constrain``), a
no-op outside a mesh.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import qat, quant_dense
from repro_torch.core.precision import QuantPolicy
from repro_torch.distributed.context import constrain

__all__ = ["rmsnorm_init", "rmsnorm", "head_rmsnorm", "rope_freqs",
           "apply_rope", "mlp_init", "mlp_apply", "embed_init", "embed_lookup",
           "embed_logits", "logits_readout", "act_fn", "dget"]


# --- norms --------------------------------------------------------------------

def rmsnorm_init(dim: int, device=None) -> Dict[str, Any]:
    return {"scale": torch.ones((dim,), dtype=torch.float32, device=device)}


def rmsnorm(params: Dict[str, Any], x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * params["scale"]
    return y.to(x.dtype)


def head_rmsnorm(scale: torch.Tensor, x: torch.Tensor,
                 eps: float = 1e-5) -> torch.Tensor:
    """qk-norm: RMSNorm over the head_dim of (..., H, D) tensors."""
    return rmsnorm({"scale": scale}, x, eps)


# --- rotary embeddings ----------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim//2,), fp32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    # a fill, not a copy from the host: capturable in a CUDA graph
    return 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
                                      device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor) -> torch.Tensor:
    """Rotate (..., S, H, D). ``positions``: (..., S) int."""
    ang = positions[..., :, None].to(torch.float32) * inv_freq  # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]                          # (..., S, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --- activations ----------------------------------------------------------------

def act_fn(name: str):
    return {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "sigmoid": torch.sigmoid, "relu": F.relu}[name]


# --- MLP ------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, act: str = "silu",
             dtype=torch.float32, device=None) -> Dict[str, Any]:
    p = {"up": quant_dense.init(gen, d_model, d_ff, bias=False, dtype=dtype,
                                device=device),
         "down": quant_dense.init(gen, d_ff, d_model, bias=False, dtype=dtype,
                                  device=device)}
    if act == "silu":  # SwiGLU
        p["gate"] = quant_dense.init(gen, d_model, d_ff, bias=False,
                                     dtype=dtype, device=device)
    return p


def dget(deltas, *names):
    """``deltas[names[0]][names[1]]...``, or None where the path stops."""
    node = deltas
    for n in names:
        if node is None:
            return None
        node = node.get(n)
    return node


def mlp_apply(params: Dict[str, Any], x: torch.Tensor, *, act: str,
              policy: QuantPolicy, deltas: Optional[Dict] = None,
              matmul_mode: str = "auto") -> torch.Tensor:
    fn = act_fn(act)

    def proj(name, h):
        return quant_dense.apply(params[name], h, policy=policy,
                                 role="hidden", delta=dget(deltas, name, "w"),
                                 mode=matmul_mode)
    up = proj("up", x)
    if "gate" in params:
        h = fn(proj("gate", x)) * up
    else:
        h = fn(up)
    if policy.act_bits:
        h = qat.fake_quant_act(h, policy.act_bits)
    return proj("down", h)


# --- embeddings -----------------------------------------------------------------

def embed_init(gen: torch.Generator, vocab: int, d_model: int,
               dtype=torch.float32, device=None) -> Dict[str, Any]:
    w = torch.randn((vocab, d_model), generator=gen, dtype=dtype,
                    device=device)
    return {"w": w.mul_(0.02)}


def embed_lookup(params: Dict[str, Any], tokens: torch.Tensor, *,
                 policy: QuantPolicy, delta=None,
                 dtype=torch.bfloat16) -> torch.Tensor:
    if "q" in params:          # serve form: gather int8 rows, dequantize in fp32
        rows = params["q"][tokens].to(torch.float32) * params["delta"]
        return rows.to(dtype)
    w = quant_dense.effective_weight(params, policy, "embed", delta)
    return _rows(w.to(dtype), tokens)


def _rows(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``. A DTensor lookup on a mesh of more than one
    device goes through ``F.embedding`` instead: torch 2.11's DTensor
    cannot propagate the index's backward there (``index_put`` with a
    sharded, partial gradient fails on an unnormalized ``Shard(-1)``),
    while the embedding op over the gathered table has a sharding
    strategy of its own (DTensor gathers a vocab-sharded table for the
    index too). One device keeps the index, whose gradient bits the
    one-device step has."""
    if type(tokens) is not torch.Tensor:
        from torch.distributed.tensor import DTensor, Replicate
        if isinstance(tokens, DTensor) and tokens.device_mesh.size() > 1:
            mesh = tokens.device_mesh
            table = table.redistribute(mesh, [Replicate()] * mesh.ndim)
            return F.embedding(tokens, table)
    return table[tokens]


def embed_logits(params: Dict[str, Any], h: torch.Tensor, *,
                 policy: QuantPolicy, delta=None,
                 matmul_mode: str = "auto") -> torch.Tensor:
    """Tied-embedding readout h @ E^T (role 'output', 8-bit under W3A8).
    Serve-form tables go through ``quant_dense.tied_logits`` (the int8
    table is never dequantized)."""
    if "q" in params:
        return quant_dense.tied_logits(params, h, mode=matmul_mode)
    w = quant_dense.effective_weight(params, policy, "output", delta)
    return h @ w.to(h.dtype).T


def logits_readout(params: Dict[str, Any], h: torch.Tensor, cfg, *,
                   policy: QuantPolicy, embed_delta=None, head_delta=None,
                   matmul_mode: str = "auto") -> torch.Tensor:
    """Final LM readout: tied embedding or a separate head per
    ``cfg.tie_embeddings``; fp32 logits."""
    if cfg.tie_embeddings:
        out = embed_logits(params["embed"], h, policy=policy,
                           delta=embed_delta, matmul_mode=matmul_mode)
    else:
        out = quant_dense.apply(params["head"], h, policy=policy,
                                role="output", delta=head_delta,
                                mode=matmul_mode)
    return constrain(out.to(torch.float32), "logits")
