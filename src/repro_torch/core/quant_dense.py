"""Quantizable dense layer — port of the reference's ``core/quant_dense.py``.

A weight leaf takes one of three forms:

  {"w": f32}                   master float weights (plain ``torch.matmul``,
                               as the reference leaves it to XLA); under a
                               'fake' policy the STE fake-quant view of
                               them (the paper's retraining step)
  {"q": int8, "delta"}         serve form A: int8 levels at full shape
                               (the ``qmatmul`` kernel's format, 1 B/wt)
  {"qp": int32, "delta"}       serve form B: 3-bit containers packed along
                               K (10 wt/word, the ``qmatvec`` format)

``export_levels`` / ``export_container`` turn a float tree into the serve
forms (per-output-channel deltas; stacked layer dims handled). In the
container export the untied 8-bit head keeps its logical (K, N) levels but
stores them K-contiguous, a ``.T`` view of an (N, K) tensor
(:func:`k_major_head`), as the tied readout's table already is: ``qmatmul``
then reads it in its ``k_lanes`` layout;
``fit_deltas`` / ``export_packed`` / ``packed_apply`` are the paper MLP's
per-tensor quantization step and its packed deployment check;
``fit_deltas_stacked`` is that step applied layer by layer to a stacked LM
tree, the frozen deltas of W3A8 training.

Serve-form matmuls dispatch on ``mode``:

  'kernel'   the hand-written kernels through their ``ops`` wrappers (on a
             CUDA tensor the CUDA kernel; on a CPU tensor its plain version)
  'dequant'  the kernels' plain versions (``ref.py``): levels cast to the
             activation dtype, fp32 accumulate, delta and bias on the
             (M, N) output — the parity oracle
  'auto'     'kernel' for CUDA tensors, 'dequant' elsewhere
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional

import torch

from repro_torch.core import packing, qat
from repro_torch.core import quantizer as qz
from repro_torch.core.precision import QuantPolicy
from repro_torch.core.treeutil import (flatten_with_path, map_with_path,
                                       role_of, unflatten)
from repro_torch.distributed import shards
from repro_torch.kernels.qmatmul import ops as qmm_ops
from repro_torch.kernels.qmatmul.ref import qmatmul_ref
from repro_torch.kernels.qmatvec import ops as qmv_ops
from repro_torch.kernels.qmatvec.ref import qmatvec_ref

__all__ = ["init", "apply", "serve_apply", "tied_logits",
           "resolve_matmul_mode", "MATMUL_MODES", "effective_weight",
           "fit_deltas", "fit_deltas_stacked", "export_levels",
           "export_container", "export_packed", "packed_apply",
           "is_serve_form", "k_major_head"]

MATMUL_MODES = ("auto", "kernel", "dequant")


def init(gen: torch.Generator, in_dim: int, out_dim: int, *, bias: bool = True,
         dtype=torch.float32, device=None,
         scale: Optional[float] = None) -> Dict[str, Any]:
    """Uniform(-1, 1) / sqrt(in_dim) init from ``gen`` (on ``device``).
    Param names: 'w' (in, out), optional 'b' (out,)."""
    if scale is None:
        scale = 1.0 / math.sqrt(in_dim)
    w = torch.rand((in_dim, out_dim), generator=gen, dtype=dtype,
                   device=device)
    p = {"w": w.mul_(2.0).sub_(1.0).mul_(scale)}
    if bias:
        p["b"] = torch.zeros((out_dim,), dtype=dtype, device=device)
    return p


def resolve_matmul_mode(mode: str, device=None) -> str:
    """'auto' -> the kernels for CUDA tensors, the plain dequant path
    elsewhere."""
    if mode == "auto":
        return "kernel" if torch.device(device or "cpu").type == "cuda" \
            else "dequant"
    if mode not in ("kernel", "dequant"):
        raise ValueError(f"matmul mode must be one of {MATMUL_MODES}, "
                         f"got {mode!r}")
    return mode


def effective_weight(params, policy: QuantPolicy, role: str,
                     delta: Optional[torch.Tensor] = None,
                     k: Optional[int] = None,
                     dtype=torch.float32) -> torch.Tensor:
    """The weight the forward pass sees. ``params``: leaf dict or raw tensor.

    For a float master under a quantizing policy this is the STE fake-quant
    view (``delta`` fixed, or refit when None). For the serve forms it
    MATERIALIZES the dequantized matrix at ``dtype`` (the test oracle; the
    serve path goes through :func:`serve_apply`). ``k`` is the logical
    reduction dim, needed for the ``qp`` form."""
    if not isinstance(params, dict):
        params = {"w": params}
    if "qp" in params:
        assert k is not None, "container form needs the logical K"
        q = packing.unpack_matrix(params["qp"], k, 3)
        return q.to(dtype) * params["delta"].to(dtype)
    if "q" in params:
        return params["q"].to(dtype) * params["delta"].to(dtype)
    w = params["w"]
    spec = policy.spec_for(role)
    if spec is None:
        return w
    return qat.fake_quant(w, spec, delta)


def serve_apply(params: Dict[str, Any], x: torch.Tensor, *,
                mode: str = "auto", out_dtype=None) -> torch.Tensor:
    """Dense forward for a 2D serve-form leaf ({"q"} or {"qp"}, + "delta",
    optional "b"). Never materializes a dequantized weight matrix in
    'kernel' mode. fp32 accumulate, fp32 epilogue, one cast to
    ``out_dtype`` (default the activation dtype). A DTensor weight or
    activation runs the same call on each rank's shards
    (``distributed.shards.matmul_on_shards``)."""
    mode = resolve_matmul_mode(mode, x.device)
    packed = "qp" in params
    w = params["qp"] if packed else params["q"]
    delta = params["delta"].reshape(-1)          # (1, N) -> (N,)
    run = functools.partial(_serve_local, mode=mode, packed=packed)
    if shards.any_dtensor(x, w):
        return shards.matmul_on_shards(x, w, run, delta=delta,
                                       bias=params.get("b"), k=x.shape[-1],
                                       packed=packed, out_dtype=out_dtype)
    return run(x, w, delta, params.get("b"), x.shape[-1], out_dtype)


def _serve_local(x, w, delta, bias, k: int, out_dtype, *, mode: str,
                 packed: bool) -> torch.Tensor:
    """x (..., k) against one device's container words (``packed``) or
    int8 levels: the kernel's wrapper ('kernel') or its plain version."""
    if mode == "kernel":
        if packed:
            return qmv_ops.qmatvec(x, w, delta, k=k, bias=bias,
                                   out_dtype=out_dtype)
        return qmm_ops.qmatmul(x, w, delta, bias=bias, out_dtype=out_dtype)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k)
    if packed:
        out = qmatvec_ref(x2, w, delta, k, bias=bias, out_dtype=out_dtype)
    else:
        out = qmatmul_ref(x2, w, delta, bias=bias, out_dtype=out_dtype)
    return out.reshape(*lead, out.shape[-1])


def tied_logits(params: Dict[str, Any], h: torch.Tensor, *,
                mode: str = "auto") -> torch.Tensor:
    """Tied-embedding readout h @ (q * delta)^T for a serve-form table
    {"q": (V, D), "delta": (1, D)} without dequantizing it: delta is per
    reduction dim, so it rescales the activations, (h * delta) @ q^T. The
    kernel reads ``q.T`` as a strided view, never a copy."""
    mode = resolve_matmul_mode(mode, h.device)
    d1 = params["delta"].reshape(-1).to(torch.float32)        # (D,)
    hs = (h.to(torch.float32) * d1).to(h.dtype)
    run = functools.partial(_serve_local, mode=mode, packed=False)
    if shards.any_dtensor(hs, params["q"]):
        return shards.matmul_on_shards(hs, params["q"].T, run, delta=1.0,
                                       bias=None, k=hs.shape[-1],
                                       packed=False, out_dtype=None)
    return run(hs, params["q"].T, 1.0, None, hs.shape[-1], None)


def apply(params: Dict[str, Any], x: torch.Tensor, *, policy: QuantPolicy,
          role: str = "hidden", delta: Optional[torch.Tensor] = None,
          quantize_input: bool = False, mode: str = "auto",
          matmul=None) -> torch.Tensor:
    """Dense forward under any weight form: serve forms go through
    :func:`serve_apply`, float and fake-quant master weights through
    ``torch.matmul`` (as the reference leaves them to XLA), or through
    ``matmul(x, w)`` where given."""
    if not isinstance(params, dict):
        params = {"w": params}
    if quantize_input and policy.act_bits:
        x = qat.fake_quant_act(x, policy.act_bits)
    if "qp" in params or "q" in params:
        return serve_apply(params, x, mode=mode)
    w = effective_weight(params, policy, role, delta, k=x.shape[-1])
    y = (matmul or torch.matmul)(x, w.to(x.dtype))
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


# --- whole-tree operations ----------------------------------------------------

def is_serve_form(params: Any) -> bool:
    """True if the tree already carries serve-form leaves ({"q"} levels or
    {"qp"} packed containers) rather than float master weights."""
    return any(p == n or p.endswith("/" + n)
               for p in flatten_with_path(params) for n in ("q", "qp"))


def k_major_head(params: Any) -> Any:
    """``params`` with the untied 8-bit head of a container export
    ({"head": {"q": (K, N) int8}} beside "qp" leaves) stored K-contiguous:
    the same (K, N) levels as a ``.T`` view of an (N, K) tensor, which
    ``qmatmul`` reads with lanes along K (``k_lanes``; a row-major (K, N)
    head would take the slower ``n_lanes``). Any other tree, the ``q``
    form's among them, comes back as it is."""
    head = params.get("head") if isinstance(params, dict) else None
    if not (isinstance(head, dict) and "q" in head
            and any(p.endswith("qp") for p in flatten_with_path(params))):
        return params
    return {**params, "head": {**head, "q": head["q"].T.contiguous().T}}


def _is_weight(path: str) -> bool:
    return path.endswith("/w") or path == "w"


def _stacked_dims(path: str) -> int:
    """Leading layer-stack dims for stacked params (layers/ =1, groups/ =2)."""
    if path.startswith("groups/") or "/groups/" in path:
        return 2
    if any(path.startswith(p) or f"/{p}/" in path
           for p in ("layers", "tail")):
        return 1
    return 0


def _leaf_spec(path: str, policy: QuantPolicy) -> Optional[qz.QuantSpec]:
    if not _is_weight(path):
        return None
    return policy.spec_for(role_of(path))


def fit_deltas(params: Any, policy: QuantPolicy) -> Any:
    """Step 2 of the paper: the L2-optimal delta of every quantized weight
    (per-tensor, unstacked trees — the MLP); other leaves map to None."""
    def fit(path, leaf):
        spec = _leaf_spec(path, policy)
        if spec is None:
            return None
        return qz.optimal_uniform_delta(leaf, spec)

    with torch.no_grad():
        return map_with_path(fit, params)


def fit_deltas_stacked(params: Any, policy: QuantPolicy) -> Any:
    """Per-layer per-tensor deltas for stacked LM trees: a leaf (L, ..., N)
    gets delta (L,) (or (G, A) for hybrid groups) — one step size per layer
    per tensor, the paper's rule applied layerwise; unstacked leaves get a
    0-d delta, other leaves None. A per-tensor fit runs every layer's rows
    at once."""
    def fit(path, leaf):
        spec = _leaf_spec(path, policy)
        if spec is None:
            return None
        nd = _stacked_dims(path)
        if leaf.is_meta:         # a shape-only template: the fit's shape
            inner = leaf.shape[nd:]
            tail = (() if spec.per_channel is None
                    else (inner[spec.per_channel % len(inner)],))
            return torch.empty(tuple(leaf.shape[:nd]) + tail,
                               dtype=torch.float32, device="meta")
        if nd == 0:
            return qz.optimal_uniform_delta(leaf, spec)
        flat = leaf.reshape((-1,) + tuple(leaf.shape[nd:]))
        if spec.per_channel is None:
            ds = qz._optimal_delta_rows(flat.reshape(flat.shape[0], -1),
                                        spec.levels, spec.iters)
        else:
            ds = torch.stack([qz.optimal_uniform_delta(w, spec)
                              for w in flat])
        return ds.reshape(tuple(leaf.shape[:nd]) + tuple(ds.shape[1:]))

    with torch.no_grad():
        return map_with_path(fit, params)


# the fit runs one stacked index and one block of output columns of at
# most _FIT_BLOCK elements at a time, so its temporaries (a few times the
# block) stay small beside the master on the card (an MoE expert stack is
# many GB; an unstacked leaf, the embedding or an untied head, is one
# stacked index: 3.1 GB in fp32 for qwen3-32b); each column's delta is its
# own, so the levels and deltas are those of fitting the whole leaf at once
_FIT_BLOCK = 1 << 28


def _quantize_leaf(leaf: torch.Tensor, spec: qz.QuantSpec, nd: int):
    """Per-output-channel (last dim) levels + delta of each stacked layer,
    fitted by stacked index and block of output columns. Returns (q int8
    same shape, delta broadcastable against q)."""
    cspec = qz.QuantSpec(bits=spec.bits, per_channel=-1, iters=spec.iters)
    n = leaf.shape[-1]
    if leaf.is_meta:             # a shape-only template: the fit's shapes
        lead = leaf.shape[:nd] if nd else ()
        dshape = tuple(lead) + (1,) * (leaf.dim() - len(lead) - 1) + (n,)
        return (torch.empty(leaf.shape, dtype=torch.int8, device="meta"),
                torch.empty(dshape, dtype=torch.float32, device="meta"))
    flat = leaf.reshape(-1, math.prod(leaf.shape[nd:-1]), n)   # (P, K, N)
    q = torch.empty(flat.shape, dtype=torch.int8, device=leaf.device)
    d = torch.empty((flat.shape[0], 1, n), dtype=torch.float32,
                    device=leaf.device)
    cols = max(1, _FIT_BLOCK // flat.shape[1])
    for i in range(flat.shape[0]):
        for c0 in range(0, n, cols):
            w = flat[i, :, c0:c0 + cols]                       # (K, cols)
            dc = qz._optimal_delta_rows(w.transpose(0, 1).contiguous(),
                                        cspec.levels, cspec.iters)[None, :]
            q[i, :, c0:c0 + cols] = torch.clamp(
                torch.round(w / torch.clamp(dc, min=1e-12)),
                -cspec.levels, cspec.levels).to(torch.int8)
            d[i, :, c0:c0 + cols] = dc
    bshape = leaf.shape[:nd] + (1,) * (leaf.dim() - nd - 1) + (n,)
    return q.reshape(leaf.shape), d.reshape(bshape)


def _base(path: str) -> str:
    return path.rsplit("/", 1)[0] + "/" if "/" in path else ""


def export_levels(params: Any, policy: QuantPolicy) -> Any:
    """Serve form A: every quantizable weight -> {"q": int8, "delta"}."""
    out: Dict[str, Any] = {}
    for path, leaf in flatten_with_path(params).items():
        spec = _leaf_spec(path, policy)
        if spec is None:
            out[path] = leaf
            continue
        q, d = _quantize_leaf(leaf, spec, _stacked_dims(path))
        out[_base(path) + "q"] = q
        out[_base(path) + "delta"] = d
    return unflatten(out)


def export_container(params: Any, policy: QuantPolicy) -> Any:
    """Serve form B: 3-bit roles -> {"qp": int32 containers packed along K,
    "delta" (..., 1, N)}; other quantized roles (8-bit output/embed) stay
    form A."""
    out: Dict[str, Any] = {}
    for path, leaf in flatten_with_path(params).items():
        spec = _leaf_spec(path, policy)
        if spec is None:
            out[path] = leaf
            continue
        nd = _stacked_dims(path)
        q, d = _quantize_leaf(leaf, spec, nd)
        base = _base(path)
        # container form only for logically-2D weights (K, N)
        if spec.bits == 3 and leaf.dim() - nd == 2:
            k = math.prod(leaf.shape[nd:-1])
            q2 = q.reshape(leaf.shape[:nd] + (k, leaf.shape[-1]))
            out[base + "qp"] = packing.pack_matrix(q2, 3)
            out[base + "delta"] = d.reshape(leaf.shape[:nd]
                                            + (1, leaf.shape[-1]))
        else:
            out[base + "q"] = q
            out[base + "delta"] = d
    return k_major_head(unflatten(out))


def export_packed(params: Any, policy: QuantPolicy) -> Any:
    """The MLP's container export: every quantized weight -> {"q": int32
    words packed along K at its own width (10 3-bit or 4 8-bit fields per
    word), per-tensor "delta", "bits", "shape"}."""
    out: Dict[str, Any] = {}
    for path, leaf in flatten_with_path(params).items():
        spec = _leaf_spec(path, policy)
        if spec is None:
            out[path] = leaf
            continue
        q, delta = qz.quantize(leaf, spec)
        q2d = q.reshape(-1, q.shape[-1]) if q.dim() >= 2 else q.reshape(-1, 1)
        dev = leaf.device
        out[path] = {
            "q": packing.pack_matrix(q2d, spec.bits),
            "delta": delta.to(torch.float32),
            "bits": torch.tensor(spec.bits, dtype=torch.int32, device=dev),
            "shape": torch.tensor(leaf.shape, dtype=torch.int32, device=dev),
        }
    return unflatten(out)


def packed_apply(packed: Dict[str, Any], x: torch.Tensor, *,
                 use_kernel: bool = True) -> torch.Tensor:
    """Inference matmul against a packed leaf from :func:`export_packed`.
    A 2-D CUDA input against 3-bit words goes to the ``qmatvec`` kernel
    when ``use_kernel``; everything else unpacks."""
    shape = tuple(packed["shape"].tolist())
    bits = int(packed["bits"])
    k = math.prod(shape[:-1])
    if use_kernel and x.is_cuda and x.dim() == 2 and bits == 3:
        return qmv_ops.qmatvec(x, packed["q"], packed["delta"], k=k)
    q = packing.unpack_matrix(packed["q"], k, bits).reshape(shape)
    w = q.to(torch.float32) * packed["delta"]
    return x @ w.to(x.dtype)
