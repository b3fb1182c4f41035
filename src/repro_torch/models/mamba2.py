"""Mamba2 (SSD — state-space duality, arXiv:2405.21060) backbone — port of
the reference's ``models/mamba2.py``.

Prefill runs the chunked SSD algorithm: within a chunk the recurrence is
an attention-like masked matmul (quadratic in the chunk length only);
across chunks a loop carries the (H, P, N) state. Decode is the pure
recurrence: one state update per token, no KV growth.

Quantization as in the reference: the in/out projections are role
'hidden' (3-bit, through ``quant_dense``, so a ``qp`` export runs them in
``qmatvec``); the SSM dynamics ``a_log`` / ``dt_bias`` / ``ssm_d`` and the
conv stay fp32. The SSD scan, the causal conv and the recurrence are plain
torch ops: the reference has no Pallas kernel for them.

Parameters keep the reference's stacked tree: every leaf under ``layers``
has a leading (L,) axis. The decode state is ``{"layers": {"ssm": (L, B,
H, P, N), "conv": (L, B, W - 1, C)}, "len"}``, both fp32 (a bf16 conv tail
drifts, and would change the dtype of a captured buffer). ``decode_step``,
``insert_prefill*`` and ``free_slots`` write into the state IN PLACE, so a
captured graph reads the same tensors on every replay.

Speculative decoding is refused (``verify_step``, ``spec_state_snapshot``,
``rollback_cache`` raise ``ValueError``, as in the reference): the SSD state
folds every token into one fixed-size state. ``forward`` is the training
pass, each block checkpointed under ``remat``, ``deltas`` threaded to every
projection.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import quant_dense
from repro_torch.core.graphs import index_drop_
from repro_torch.core.precision import QuantPolicy
from repro_torch.distributed import shards
from repro_torch.distributed.context import constrain
from repro_torch.models.layers import (dget, embed_init, embed_lookup,
                                       rmsnorm, rmsnorm_init)
from repro_torch.models.transformer import (_last_hidden, _layer, _logits,
                                            _slot_index, _stack_into,
                                            remat_layer, unstack)

__all__ = ["init", "forward", "init_state", "cache_len_for", "prefill",
           "decode_step", "verify_step", "rollback_cache",
           "spec_state_snapshot", "insert_prefill", "insert_prefill_many",
           "free_slots",
           "block_init", "block_apply", "block_state", "block_decode",
           "DEFAULT_CHUNK"]

DEFAULT_CHUNK = 256


# --- parameter init ---------------------------------------------------------------

def block_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
               device=None) -> Dict[str, Any]:
    """One Mamba2 block's weights from ``gen``: the fused ``in_proj`` (z |
    x | B | C | dt) and one conv, or with ``cfg.ssm_split_proj`` the four
    component projections and two convs."""
    d, di, ns, g, h = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                       cfg.ssm_ngroups, cfg.ssm_heads)
    gn2 = 2 * g * ns
    kw = dict(dtype=dtype, device=device)
    lin = lambda i, o: quant_dense.init(gen, i, o, bias=False, **kw)
    conv = lambda c: torch.randn((cfg.ssm_conv, c), generator=gen,
                                 **kw).mul_(0.1)
    p = {
        "norm": rmsnorm_init(d, device),
        "out_proj": lin(di, d),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, device=device)),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=device),
        "ssm_d": torch.ones((h,), dtype=torch.float32, device=device),
        "gate_norm": rmsnorm_init(di, device),
    }
    if cfg.ssm_split_proj:
        p.update({"wz": lin(d, di), "wx": lin(d, di), "wbc": lin(d, gn2),
                  "wdt": lin(d, h),
                  "conv_x_w": conv(di),
                  "conv_x_b": torch.zeros((di,), **kw),
                  "conv_bc_w": conv(gn2),
                  "conv_bc_b": torch.zeros((gn2,), **kw)})
    else:
        p.update({"in_proj": lin(d, 2 * di + gn2 + h),
                  "conv_w": conv(di + gn2),
                  "conv_b": torch.zeros((di + gn2,), **kw)})
    return p


def init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
         device=None) -> Dict[str, Any]:
    """Random float master weights from ``gen`` on ``device`` in the
    reference's stacked layout, drawn a layer at a time into preallocated
    (L, ...) stacks. The numbers differ from the reference's ``jax.random``
    init; parity tests bridge JAX weights."""
    layers = None
    for i in range(cfg.num_layers):
        layers = _stack_into(layers, block_init(gen, cfg, dtype, device), i,
                             cfg.num_layers)
    params = {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype,
                                  device),
              "layers": layers, "final_norm": rmsnorm_init(cfg.d_model, device)}
    if not cfg.tie_embeddings:
        params["head"] = quant_dense.init(gen, cfg.d_model, cfg.vocab_size,
                                          bias=False, dtype=dtype,
                                          device=device)
    return params


# --- projections ------------------------------------------------------------------

def _proj(lp, name: str, x, policy, mm: str, ld=None):
    return quant_dense.apply(lp[name], x, policy=policy, role="hidden",
                             delta=dget(ld, name, "w"), mode=mm)


def _split_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    di, gn2 = cfg.d_inner, 2 * cfg.ssm_ngroups * cfg.ssm_state
    return torch.split(zxbcdt, [di, di, gn2, cfg.ssm_heads], dim=-1)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d. x (B, L, C), w (W, C). Returns (silu(y + b),
    new_state); ``state`` (B, W - 1, C) is the trailing context decode
    carries."""
    wlen = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, wlen - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    ln = x.shape[1]
    y = xp[:, 0:ln] * w[0]
    for i in range(1, wlen):
        y = y + xp[:, i:i + ln] * w[i]
    new_state = xp[:, -(wlen - 1):] if wlen > 1 else None
    return F.silu(y + b), new_state


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _in_conv(lp, hn, cfg: ModelConfig, policy, mm: str, conv_state=None,
             ld=None):
    """The block's projections and causal conv: (z, x, B, C, dt, xbc_pre,
    new conv state). ``xbc_pre`` is the conv input (x | B | C) before the
    conv, whose trailing window is the decode conv state."""
    di, gn = cfg.d_inner, cfg.ssm_ngroups * cfg.ssm_state
    if cfg.ssm_split_proj:
        z = _proj(lp, "wz", hn, policy, mm, ld)
        x0 = _proj(lp, "wx", hn, policy, mm, ld)
        bc0 = _proj(lp, "wbc", hn, policy, mm, ld)
        dt = _proj(lp, "wdt", hn, policy, mm, ld)
        cs_x = cs_bc = None
        if conv_state is not None:
            cs_x, cs_bc = torch.split(conv_state, [di, 2 * gn], dim=-1)
        x, cx = _causal_conv(x0, lp["conv_x_w"], lp["conv_x_b"], cs_x)
        bc, cbc = _causal_conv(bc0, lp["conv_bc_w"], lp["conv_bc_b"], cs_bc)
        new_conv = torch.cat([cx, cbc], dim=-1)
        b_mat, c_mat = torch.split(bc, [gn, gn], dim=-1)
        xbc_pre = torch.cat([x0, bc0], dim=-1)
    else:
        z, x, bc, dt = _split_proj(_proj(lp, "in_proj", hn, policy, mm, ld),
                                   cfg)
        xbc_pre = torch.cat([x, bc], dim=-1)
        xbc, new_conv = _causal_conv(xbc_pre, lp["conv_w"], lp["conv_b"],
                                     conv_state)
        x, b_mat, c_mat = torch.split(xbc, [di, gn, gn], dim=-1)
    return z, x, b_mat, c_mat, dt, xbc_pre, new_conv


def _gate_out(lp, y, z, h_in, cfg: ModelConfig, policy, mm: str, ld=None):
    """y (B, L, di) in the activation dtype -> h_in + out_proj(gated
    rmsnorm)."""
    y = rmsnorm(lp["gate_norm"], y * F.silu(z), cfg.norm_eps)
    return constrain(h_in + _proj(lp, "out_proj", y, policy, mm, ld), "act")


# --- chunked SSD core ---------------------------------------------------------------

def _ssd_chunked(x, b_mat, c_mat, dt, a_log, chunk: int, bf16: bool = False):
    """SSD over the full sequence.

    x (B, L, H, P) head values; b_mat / c_mat (B, L, G, N) shared per group;
    dt (B, L, H) positive step; a_log (H,), a = -exp(a_log). Returns (y (B,
    L, H, P) fp32, final state (B, H, P, N) fp32). The cumsum, the decay
    and the carried state stay fp32; ``bf16`` rounds the big products'
    operands (x, B, C, the decay matrix) to bf16 and sums them in fp32, as
    the reference's bf16 einsums with an fp32 result do.

    The reference's three-operand intra-chunk einsum
    ``"bhij,bijh,bjhp->bihp"`` is formed as ``scores * decay`` (B, H, q, q)
    first, then one batched matmul with x, so no (B, H, q, q, P) tensor is
    ever made."""
    bsz, ln, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    rep = h // g
    q = min(chunk, ln)
    nchunks = -(-ln // q)
    pad = nchunks * q - ln
    f32 = torch.float32
    rnd = ((lambda t: t.to(torch.bfloat16).to(f32)) if bf16
           else (lambda t: t.to(f32)))
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    a = -torch.exp(a_log.to(f32))                               # (H,)
    dta = dt.to(f32) * a                                        # log decay
    xw = rnd(x.to(f32) * dt.to(f32)[..., None])                 # dt-weighted
    bm, cm = rnd(b_mat), rnd(c_mat)
    causal = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    neg_inf = torch.full((), float("-inf"), dtype=f32, device=x.device)
    state = torch.zeros((bsz, h, p, n), dtype=f32, device=x.device)
    ys = []
    for c in range(nchunks):
        sl = slice(c * q, (c + 1) * q)
        xc, dac = xw[:, sl], dta[:, sl]                         # (B,q,H,P) (B,q,H)
        bh = bm[:, sl].repeat_interleave(rep, dim=2)            # (B,q,H,N)
        ch = cm[:, sl].repeat_interleave(rep, dim=2)
        lcum = torch.cumsum(dac, dim=1)                         # inclusive
        ltot = lcum[:, -1]                                      # (B,H)
        # intra-chunk: att[i, j] = (C_i . B_j) exp(lcum_i - lcum_j), j <= i;
        # the EXPONENT is masked (exp of a future entry overflows)
        scores = shards.einsum("bihn,bjhn->bhij", ch, bh)
        decay = (lcum.transpose(1, 2)[:, :, :, None]
                 - lcum.transpose(1, 2)[:, :, None, :])         # (B,H,i,j)
        w = rnd(torch.exp(torch.where(causal, decay, neg_inf)))
        y_intra = shards.matmul(rnd(scores) * w,
                                xc.transpose(1, 2))             # (B,H,i,P)
        # inter-chunk: the carried state's contribution
        y_inter = (shards.einsum("bihn,bhpn->bhip", ch, state)
                   * torch.exp(lcum).transpose(1, 2)[..., None])
        ys.append((y_intra + y_inter).transpose(1, 2))          # (B,q,H,P)
        # state update
        carry_w = torch.exp(ltot[:, None, :] - lcum)            # (B,q,H)
        state = (state * torch.exp(ltot)[..., None, None]
                 + shards.einsum("bjhp,bjhn->bhpn", xc * carry_w[..., None],
                                 bh))
    y = torch.cat(ys, dim=1) if nchunks > 1 else ys[0]
    return y[:, :ln], state


def block_apply(lp, h_in: torch.Tensor, cfg: ModelConfig, *,
                policy: QuantPolicy, deltas: Optional[Dict] = None,
                chunk: int = DEFAULT_CHUNK, return_state: bool = False,
                lengths: Optional[torch.Tensor] = None,
                matmul_mode: str = "auto"):
    """A whole Mamba2 block over a sequence (pre-norm residual);
    ``deltas`` the block's frozen step sizes or None.

    With ``return_state`` returns (out, {"ssm", "conv"}): the exact decode
    state after the sequence. ``lengths`` (B,) marks right-padded rows: dt
    is zeroed at padded positions, which makes the recurrence an identity
    there (decay exp(0) = 1, input dt x = 0), so the carried SSM state is
    the state after each row's last real token; the conv state is gathered
    from each row's true trailing window, zeros before position 0."""
    bsz, ln, _ = h_in.shape
    hn = rmsnorm(lp["norm"], h_in, cfg.norm_eps)
    z, x, b_mat, c_mat, dt, xbc_pre, _ = _in_conv(lp, hn, cfg, policy,
                                                  matmul_mode, ld=deltas)
    hh, hp = cfg.ssm_heads, cfg.ssm_headdim
    x = x.reshape(bsz, ln, hh, hp)
    b_mat = b_mat.reshape(bsz, ln, cfg.ssm_ngroups, cfg.ssm_state)
    c_mat = c_mat.reshape(bsz, ln, cfg.ssm_ngroups, cfg.ssm_state)
    dt = _softplus(dt.to(torch.float32) + lp["dt_bias"])
    if lengths is not None:
        lengths = torch.as_tensor(lengths, device=h_in.device)
        valid = (torch.arange(ln, device=h_in.device)[None, :]
                 < lengths[:, None])
        dt = dt * valid[..., None]
    y, s_final = _ssd_chunked(x, b_mat, c_mat, dt, lp["a_log"], chunk,
                              bf16=cfg.ssm_bf16)
    y = y + x.to(torch.float32) * lp["ssm_d"][:, None]           # D skip
    y = y.reshape(bsz, ln, cfg.d_inner).to(h_in.dtype)
    out = _gate_out(lp, y, z, h_in, cfg, policy, matmul_mode, deltas)
    if not return_state:
        return out
    wlen = cfg.ssm_conv
    xf = xbc_pre.to(torch.float32)
    if lengths is not None:
        # each row's window [len - (W - 1), len); positions < 0 are the
        # initial zero state (short prompts)
        idx = (lengths.long()[:, None] - (wlen - 1)
               + torch.arange(wlen - 1, device=h_in.device)[None])
        tail = torch.gather(xf, 1, idx.clamp(min=0)[:, :, None].expand(
            -1, -1, xf.shape[-1]))
        tail = torch.where((idx >= 0)[:, :, None], tail, 0.0)
    else:
        tail = F.pad(xf[:, -(wlen - 1):], (0, 0, max(wlen - 1 - ln, 0), 0))
    return out, {"ssm": s_final, "conv": tail}


# --- decode (pure recurrence) ---------------------------------------------------------

def block_state(cfg: ModelConfig, batch: int, device=None):
    conv_ch = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    f32 = dict(dtype=torch.float32, device=device)
    return {"ssm": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_headdim,
                                cfg.ssm_state), **f32),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch), **f32)}


def block_decode(lp, h_in: torch.Tensor, state: Dict, cfg: ModelConfig, *,
                 policy: QuantPolicy, matmul_mode: str = "auto"):
    """One token. h_in (B, 1, d), ``state`` {"ssm", "conv"} of this layer.
    Returns (h_out, new state); the new state's tensors are fresh (the
    caller writes them in place), the conv tail kept fp32."""
    bsz = h_in.shape[0]
    hn = rmsnorm(lp["norm"], h_in, cfg.norm_eps)
    z, x, b_mat, c_mat, dt, _, conv_state = _in_conv(
        lp, hn, cfg, policy, matmul_mode, state["conv"])
    hh, hp, n, g = (cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state,
                    cfg.ssm_ngroups)
    f32 = torch.float32
    x = x.reshape(bsz, hh, hp).to(f32)
    rep = hh // g
    b1 = b_mat.reshape(bsz, g, n).repeat_interleave(rep, dim=1).to(f32)
    c1 = c_mat.reshape(bsz, g, n).repeat_interleave(rep, dim=1).to(f32)
    dt1 = _softplus(dt.reshape(bsz, hh).to(f32) + lp["dt_bias"])
    decay = torch.exp(dt1 * -torch.exp(lp["a_log"].to(f32)))      # (B, H)
    # S <- decay S + dt x B^T ;  y = S C + D x
    s_new = (state["ssm"] * decay[..., None, None]
             + (dt1[..., None] * x)[..., None] * b1[:, :, None, :])
    y = shards.matmul(s_new, c1[..., None])[..., 0] + lp["ssm_d"][:, None] * x
    y = y.reshape(bsz, 1, cfg.d_inner).to(h_in.dtype)
    out = _gate_out(lp, y, z, h_in, cfg, policy, matmul_mode)
    return out, {"ssm": s_new, "conv": conv_state.to(state["conv"].dtype)}


# --- whole-model wrappers ---------------------------------------------------------------

def forward(params, batch, cfg: ModelConfig, *, policy: QuantPolicy,
            deltas: Optional[Dict] = None, dtype=torch.bfloat16,
            remat: str = "layer", attn_chunk: int = 0,
            chunk: int = DEFAULT_CHUNK, matmul_mode: str = "auto"):
    """Training / eval forward: (logits (B, S, V) fp32, aux 0 fp32 — no
    MoE here). Each block is checkpointed unless ``remat`` is 'none';
    ``attn_chunk`` is unused (no attention)."""
    h = embed_lookup(params["embed"], batch["tokens"], policy=policy,
                     delta=dget(deltas, "embed", "w"), dtype=dtype)
    h = constrain(h, "act")

    def body(lp, ld, hh):
        return block_apply(lp, hh, cfg, policy=policy, deltas=ld, chunk=chunk,
                           matmul_mode=matmul_mode)

    body = remat_layer(body, remat)
    n = cfg.num_layers
    for lp, ld in zip(unstack(params["layers"], n),
                      unstack(dget(deltas, "layers"), n)):
        h = body(lp, ld, h)
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return (_logits(params, h, cfg, policy, matmul_mode, deltas),
            torch.zeros((), dtype=torch.float32, device=h.device))


def cache_len_for(cfg: ModelConfig, max_len: int) -> int:
    """The state holds no positions: every prompt up to ``max_len`` fits."""
    return max_len


def init_state(cfg: ModelConfig, batch: int, max_len: int = 0,
               dtype=torch.bfloat16, device=None):
    """Decode state for all layers, stacked; ``max_len`` and ``dtype`` are
    unused (O(1) fp32 state)."""
    one = block_state(cfg, batch, device)
    return {"layers": {k: v.new_zeros((cfg.num_layers,) + tuple(v.shape))
                       for k, v in one.items()},
            "len": torch.zeros((), dtype=torch.int32, device=device)}


def prefill(params, batch, cfg: ModelConfig, *, policy: QuantPolicy,
            dtype=torch.bfloat16, attn_chunk: int = 0,
            max_len: Optional[int] = None, chunk: int = DEFAULT_CHUNK,
            lengths: Optional[torch.Tensor] = None,
            matmul_mode: str = "auto"):
    """Prompt pass: (last logits (B, 1, V) fp32, the exact decode-ready
    state). ``lengths`` (B,) enables right-padded multi-request prefill:
    each row's state stops at its true length, its logits come from its
    last real token, and ``len`` is per-row. ``attn_chunk`` and
    ``max_len`` are unused (no attention, no positions held)."""
    tokens = batch["tokens"]
    h = embed_lookup(params["embed"], tokens, policy=policy, dtype=dtype)
    s = tokens.shape[1]
    if lengths is not None:
        lengths = torch.as_tensor(lengths, device=h.device).to(torch.int32)
    states = {"ssm": [], "conv": []}
    for i in range(cfg.num_layers):
        h, st = block_apply(_layer(params["layers"], i), h, cfg,
                            policy=policy, chunk=chunk, return_state=True,
                            lengths=lengths, matmul_mode=matmul_mode)
        for k in states:
            states[k].append(st[k])
    h = rmsnorm(params["final_norm"], _last_hidden(h, lengths), cfg.norm_eps)
    logits = _logits(params, h, cfg, policy, matmul_mode)
    clen = (torch.full((), s, dtype=torch.int32, device=h.device)
            if lengths is None else lengths)
    return logits, {"layers": {k: torch.stack(v) for k, v in states.items()},
                    "len": clen}


def decode_step(params, state, tokens: torch.Tensor, cfg: ModelConfig, *,
                policy: QuantPolicy, dtype=torch.bfloat16,
                matmul_mode: str = "auto"):
    """One token for the whole batch: every layer's state advanced IN
    PLACE. Returns (logits (B, 1, V) fp32, state with ``len + 1``)."""
    h = embed_lookup(params["embed"], tokens, policy=policy, dtype=dtype)
    st = state["layers"]
    for i in range(cfg.num_layers):
        h, new = block_decode(_layer(params["layers"], i), h,
                              {k: v[i] for k, v in st.items()}, cfg,
                              policy=policy, matmul_mode=matmul_mode)
        for k, v in new.items():
            st[k][i].copy_(v)
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    logits = _logits(params, h, cfg, policy, matmul_mode)
    out = dict(state)
    out["len"] = state["len"] + 1
    return logits, out


_NO_SPEC = ("family 'ssm' does not support speculative decoding: the SSD "
            "recurrence folds every token into one fixed-size state, so a "
            "rejected draft suffix cannot be rewound (no KV length to "
            "rewind, and snapshotting every per-layer state per draft "
            "token would defeat the O(1)-state point of the family)")


def verify_step(params, state, tokens, cfg, **kw):
    """Speculative verify is structurally unavailable for the pure-SSM
    family: refused loudly instead of corrupting the state."""
    raise ValueError(_NO_SPEC)


def spec_state_snapshot(state):
    raise ValueError(_NO_SPEC)


def rollback_cache(state, slots, new_lens, trajectory=None):
    raise ValueError(_NO_SPEC)


def free_slots(state, slots):
    """Zero rows ``slots`` (N,) of a slot-major state (conv and SSM states)
    in place and reset their ``len``: the running fold's fresh state.
    Entries ``>= batch`` are dropped on the device."""
    idx = _slot_index(slots, state["len"].device)
    for leaf in state["layers"].values():         # (L, slots, ...)
        index_drop_(leaf, idx, 0, dim=1)
    index_drop_(state["len"], idx, 0)
    return state


def insert_prefill(state, slot: int, src):
    """Copy a single-request prefill state (batch 1) into row ``slot`` of a
    slot-major state whose ``len`` is per-slot, in place."""
    for k, leaf in state["layers"].items():
        leaf[:, slot] = src["layers"][k][:, 0].to(leaf.dtype)
    state["len"][slot] = torch.as_tensor(src["len"]).reshape(()).to(
        state["len"].dtype)
    return state


def insert_prefill_many(state, slot_map, src):
    """Scatter an N-row batched prefill state into rows ``slot_map`` (N,)
    of a slot-major state (per-slot ``len``), in place; entries
    ``slot_map[i] >= slots`` are dropped on the device."""
    idx = _slot_index(slot_map, state["len"].device)
    for k, leaf in state["layers"].items():
        index_drop_(leaf, idx, src["layers"][k], dim=1)
    n = idx.shape[0]
    lens = torch.as_tensor(src["len"], device=state["len"].device)
    index_drop_(state["len"], idx, lens.reshape(-1).expand(n))
    return state
