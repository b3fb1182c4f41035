"""Batched continuous-batching serving engine — port of the reference's
``serving/engine.py`` with speculative decoding and the NaN quarantine,
without the rest of overload hardening or durability.

  * ONE shared slot-major cache — ``(slots, ...)`` rows with per-slot
    length counters — allocated once at construction. The reference
    donates it to every jitted tick and admission; here the same effect is
    had by updating that one cache in place (``decode_step``,
    ``insert_prefill_many``), so no call ever copies it. The per-slot
    device state (pending token, active, emitted, budget), the ``poison``
    input and the record a call leaves are fixed buffers too, updated in
    place, so a captured graph reads and writes the same tensors on every
    replay.
  * Admission is LENGTH-BUCKETED and batched: queued prompts are right-
    padded to power-of-two buckets (floor ``_MIN_BUCKET``, capped at the
    cache length) and every same-bucket request is prefilled in ONE call
    and inserted with ONE multi-slot scatter. The prefill batch is pinned
    to ``slots``: dummy rows have length 1 and an out-of-range slot, which
    the scatter drops on the device. ``prefill_calls`` counts these calls.
  * ONE ``decode_step`` per tick advances every slot at once. Sampling and
    termination (budget / EOS) are computed on the device as masks;
    inactive slots are frozen there (token and length held), so a tick
    never asks the host which slots are live. ``decode_calls`` counts
    ticks.
  * COMPILED: on a CUDA device the tick is one CUDA graph, captured once
    per engine, and each admission bucket one graph, captured at its first
    use (``core.graphs``; ``captures`` counts them) — the reference's
    ``jax.jit`` boundaries. ``capture=False`` runs the same work eagerly,
    the counterpart of ``jax.disable_jit``; a CPU engine always does.
  * HEALTH CHECK: ``poison`` (slots,) fp32, all zeros unless a
    ``FaultPlan`` schedules NaN logits, is added to the logits before the
    check; an active row whose logits are not all finite is flagged
    ``bad``, frozen like an inactive row and deactivated. At the next sync
    its request finishes ``"poisoned"``, ``poisoned_count`` rises and the
    slot's cache rows are zeroed (``free_slots``) before it is reused.
  * Tokens cross to the host only in bulk at ``drain()`` — no per-token
    sync. With ``eos_id=None`` and no speculation lifetimes are
    host-predictable and admission needs no sync at all.
  * Speculative decoding (``spec_k >= 1``): a DRAFTER (by default the
    packed 3-bit ``api.draft_of`` export of the target's own weights)
    keeps a second slot-major cache, admitted in the same bucketed rounds;
    each tick it proposes ``spec_k`` tokens, the target verifies them in
    one multi-token pass and every slot commits 1..spec_k+1 tokens
    (``serving.spec.spec_decode_tick``). Same output distribution as plain
    decoding, token-identical at T = 0. ``submit`` reserves ``spec_k``
    positions of verify headroom; ``spec_drafted`` / ``spec_accepted`` /
    ``spec_accept_rate`` and each request's ``ticks`` and ``accept_hist``
    are folded in at drain.

A tick that fails raises: the reference's degradation ladder, preemption
and deadlines are not ported.
At T > 0 the sampled streams differ from the reference's (``torch``
generator vs ``jax.random``); at T = 0 both are greedy.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.graphs import Graphs, index_drop_, masked
from repro_torch.core.precision import QuantPolicy
from repro_torch.core.quant_dense import MATMUL_MODES
from repro_torch.models import api as model_api
from repro_torch.models import get_model
from repro_torch.models.attention import ATTN_MODES
from repro_torch.serving.resilience import (FaultPlan, SubmitOutcome,
                                            SubmitRejected)
from repro_torch.serving.spec import (categorical, emit_counts,
                                      spec_decode_tick)

__all__ = ["generate", "Request", "ServingEngine", "SubmitOutcome",
           "SubmitRejected", "FaultPlan"]

# smallest admission bucket: prompts of length 1..8 share one shape
_MIN_BUCKET = 8


def _sample(gen: torch.Generator, logits: torch.Tensor,
            temperature: float) -> torch.Tensor:
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
    return categorical(probs, gen)


def _serve_kwargs(matmul_mode: str, attn_mode: str,
                  kv_bits: Optional[int]) -> Dict[str, Dict[str, Any]]:
    """Validated per-call kwargs for the serving knobs: ``attn_mode`` goes
    to prefill and decode, ``kv_bits=8`` becomes
    ``prefill(quantize_cache=True)``."""
    if matmul_mode not in MATMUL_MODES:
        raise ValueError(f"matmul_mode must be one of {MATMUL_MODES}, "
                         f"got {matmul_mode!r}")
    if attn_mode not in ATTN_MODES:
        raise ValueError(f"attn_mode must be one of {ATTN_MODES}, "
                         f"got {attn_mode!r}")
    if kv_bits not in (None, 8):
        raise ValueError(f"kv_bits must be None or 8, got {kv_bits!r}")
    common = {"matmul_mode": matmul_mode, "attn_mode": attn_mode}
    return {"prefill": dict(common, quantize_cache=kv_bits == 8),
            "decode": common}


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


@torch.no_grad()
def generate(params, prompts, cfg: ModelConfig, *, policy: QuantPolicy,
             max_new_tokens: int = 32, temperature: float = 0.0,
             seed: int = 0, dtype=torch.bfloat16, matmul_mode: str = "auto",
             attn_mode: str = "auto", kv_bits: Optional[int] = None,
             spec_k: int = 0, draft_params=None,
             draft_cfg: Optional[ModelConfig] = None,
             device="cuda") -> torch.Tensor:
    """prompts (B, P) int -> (B, P + max_new_tokens) on ``device``: one
    prefill, then one decode step per token.

    ``spec_k >= 1`` decodes speculatively: ``draft_params`` (default: the
    packed 3-bit ``api.draft_of`` export of ``params``) proposes spec_k
    tokens a step and the target verifies them in one multi-token pass —
    the same output distribution, token-identical at T = 0."""
    if spec_k:
        return _spec_generate(params, prompts, cfg, policy=policy,
                              max_new_tokens=max_new_tokens,
                              temperature=temperature, seed=seed,
                              dtype=dtype, matmul_mode=matmul_mode,
                              attn_mode=attn_mode, kv_bits=kv_bits,
                              spec_k=spec_k, draft_params=draft_params,
                              draft_cfg=draft_cfg, device=device)
    mod = get_model(cfg)
    params = _to_device(params, device)
    prompts = torch.as_tensor(prompts).to(device=device, dtype=torch.int32)
    b, p = prompts.shape
    kw = _serve_kwargs(matmul_mode, attn_mode, kv_bits)
    gen = torch.Generator(device=prompts.device).manual_seed(seed)
    logits, cache = mod.prefill(params, {"tokens": prompts}, cfg,
                                policy=policy, dtype=dtype,
                                max_len=p + max_new_tokens, **kw["prefill"])
    tok = _sample(gen, logits[:, 0], temperature).to(torch.int32)[:, None]
    out = [prompts, tok]
    for _ in range(max_new_tokens - 1):
        logits, cache = mod.decode_step(params, cache, tok, cfg,
                                        policy=policy, dtype=dtype,
                                        **kw["decode"])
        tok = _sample(gen, logits[:, 0], temperature).to(torch.int32)[:, None]
        out.append(tok)
    return torch.cat(out, dim=1)


def _spec_models(params, cfg: ModelConfig, draft_params,
                 draft_cfg: Optional[ModelConfig]):
    """The drafter for ``params``: derived from the target checkpoint
    (``api.draft_of``) when none is given."""
    if draft_params is None:
        draft_cfg, draft_params = model_api.draft_of(cfg, params)
    else:
        draft_cfg = draft_cfg or cfg
    if draft_cfg.vocab_size != cfg.vocab_size:
        raise ValueError(f"draft vocab {draft_cfg.vocab_size} != target "
                         f"vocab {cfg.vocab_size}")
    return draft_params, draft_cfg


def _spec_generate(params, prompts, cfg: ModelConfig, *, policy: QuantPolicy,
                   max_new_tokens: int, temperature: float, seed: int, dtype,
                   matmul_mode: str, attn_mode: str, kv_bits: Optional[int],
                   spec_k: int, draft_params, draft_cfg: Optional[ModelConfig],
                   device) -> torch.Tensor:
    """Speculative ``generate``: an eager loop over the shared
    ``spec_decode_tick``; each tick commits 1..spec_k+1 tokens per row into
    a fixed output buffer. The loop reads one flag a tick from the device
    to know when every row is done."""
    draft_params, draft_cfg = _spec_models(params, cfg, draft_params,
                                           draft_cfg)
    mod, dmod = get_model(cfg), get_model(draft_cfg)
    params = _to_device(params, device)
    draft_params = _to_device(draft_params, device)
    prompts = torch.as_tensor(prompts).to(device=device, dtype=torch.int32)
    b, p = prompts.shape
    # verify writes up to spec_k positions past the committed stream
    max_len = p + max_new_tokens + spec_k
    kw = _serve_kwargs(matmul_mode, attn_mode, kv_bits)
    mkw = dict(policy=policy, dtype=dtype)
    gen = torch.Generator(device=prompts.device).manual_seed(seed)
    logits, cache = mod.prefill(params, {"tokens": prompts}, cfg,
                                max_len=max_len, **mkw, **kw["prefill"])
    _, dcache = dmod.prefill(draft_params, {"tokens": prompts}, draft_cfg,
                             max_len=max_len, **mkw, **kw["prefill"])
    tok0 = _sample(gen, logits[:, 0], temperature).to(torch.int32)[:, None]
    if max_new_tokens == 1:
        return torch.cat([prompts, tok0], dim=1)
    # rollback writes per-row lengths
    for c in (cache, dcache):
        c["len"] = c["len"].to(torch.int32).reshape(-1).expand(b).clone()
    # one spare column takes the writes of rows past their window
    buf = torch.zeros((b, max_new_tokens + 1), dtype=torch.int32,
                      device=prompts.device)
    buf[:, 0] = tok0[:, 0]
    budget = torch.full((b,), max_new_tokens, dtype=torch.int32,
                        device=prompts.device)
    emitted = torch.ones((b,), dtype=torch.int32, device=prompts.device)
    rows = torch.arange(b, device=prompts.device)
    pending = tok0
    while bool((emitted < max_new_tokens).any()):
        active = emitted < max_new_tokens
        cache, dcache, a, out, pending, _ = spec_decode_tick(
            mod, dmod, params, draft_params, cfg, draft_cfg, cache, dcache,
            pending, active, spec_k=spec_k, temperature=temperature,
            generator=gen, mkw=mkw, dmkw=mkw, attn_kw=kw["decode"],
            dattn_kw=kw["decode"])
        n, _ = emit_counts(out, a, active=active, emitted=emitted,
                           budget=budget, eos_id=-1)
        for j in range(spec_k + 1):
            idx = torch.where(j < n, emitted + j, max_new_tokens)
            buf[rows, idx.long()] = out[:, j]
        emitted = emitted + n
    return torch.cat([prompts, buf[:, :max_new_tokens]], dim=1)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # filled at drain: decode ticks this request took part in, and the
    # histogram {tokens emitted in a tick: ticks} ({1: n} without
    # speculation; the accept-length distribution with it)
    ticks: int = 0
    accept_hist: Dict[int, int] = dataclasses.field(default_factory=dict)
    # terminal outcome, one of resilience.STATUS: "ok", or "poisoned" when
    # its slot's logits went non-finite (its tokens up to then are kept)
    status: str = "ok"

    @property
    def admit_prompt(self) -> List[int]:
        """What admission prefills: the prompt plus every committed token."""
        return self.prompt + self.out

    @property
    def remaining(self) -> int:
        """Tokens still owed."""
        return self.max_new - len(self.out)


class ServingEngine:
    """Slot-based continuous batching: one decode call per tick, all slots.

    ``step()`` = admit + one batched tick (asynchronous — tokens stay on the
    device); ``drain()`` = bulk host transfer of everything emitted since
    the last drain; ``run_all()`` = drive until queue and slots are empty.
    Admission is FIFO by bucket: each round serves the oldest queued
    request's bucket, and other same-bucket requests ride along. With
    ``spec_k >= 1`` a tick is one speculative tick (draft, verify, accept,
    rollback of both caches) and emits 1..spec_k+1 tokens per slot.

    ``capture`` (default: on for a CUDA device) replays the tick and each
    admission bucket as CUDA graphs; ``captures`` reports them.
    ``fault_plan`` injects the ``FaultPlan``'s NaN logits.
    """

    def __init__(self, params, cfg: ModelConfig, *, policy: QuantPolicy,
                 slots: int = 8, max_len: int = 512, dtype=torch.bfloat16,
                 temperature: float = 0.0, eos_id: Optional[int] = None,
                 seed: int = 0, drain_every: int = 4,
                 matmul_mode: str = "auto", attn_mode: str = "auto",
                 kv_bits: Optional[int] = None, attn_chunk: int = 1024,
                 spec_k: int = 0, draft_params=None,
                 draft_cfg: Optional[ModelConfig] = None,
                 fault_plan: Optional[FaultPlan] = None,
                 capture: Optional[bool] = None, device="cuda"):
        self._kw = _serve_kwargs(matmul_mode, attn_mode, kv_bits)
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if fault_plan is not None and fault_plan.unported:
            raise NotImplementedError(
                f"FaultPlan {', '.join(fault_plan.unported)}: the port's "
                f"engine injects nan_logits only (no degradation ladder, "
                f"queue aging or durability yet)")
        self.device = torch.device(device)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.graphs = Graphs(self.device, capture=capture,
                             generator=self._gen)
        self.params = _to_device(params, self.device)
        self.cfg, self.policy, self.dtype = cfg, policy, dtype
        self.mod = get_model(cfg)
        self.slots, self.max_len = slots, max_len
        self.temperature = temperature
        self.eos_id = eos_id
        self.drain_every = max(1, drain_every)
        self.matmul_mode, self.attn_mode, self.kv_bits = (matmul_mode,
                                                          attn_mode, kv_bits)
        self.attn_chunk = attn_chunk
        self.fault_plan = fault_plan
        # shared slot-major cache, allocated ONCE and updated in place
        self.cache = model_api.init_cache(cfg, slots, max_len, dtype,
                                          per_slot_len=True, kv_bits=kv_bits,
                                          device=self.device)
        # speculative decoding: a second slot-major cache for the DRAFTER,
        # served with the engine's knobs
        self.spec_k = int(spec_k)
        self.spec_drafted = 0                 # draft proposals scored
        self.spec_accepted = 0                # proposals the target kept
        if self.spec_k:
            draft_params, self.draft_cfg = _spec_models(
                params, cfg, draft_params, draft_cfg)
            self.draft_params = _to_device(draft_params, self.device)
            self.dmod = get_model(self.draft_cfg)
            self.draft_cache = model_api.init_cache(
                self.draft_cfg, slots, max_len, dtype, per_slot_len=True,
                kv_bits=kv_bits, device=self.device)
        # per-slot device state, fixed buffers updated in place (a captured
        # graph reads and writes these very tensors on every replay)
        dev = self.device
        self._tokens = torch.zeros((slots, 1), dtype=torch.int32, device=dev)
        self._active = torch.zeros((slots,), dtype=torch.bool, device=dev)
        self._emitted = torch.zeros((slots,), dtype=torch.int32, device=dev)
        self._budget = torch.zeros((slots,), dtype=torch.int32, device=dev)
        # the logit bias of the health check: zeros unless a fault is due
        self._poison = torch.zeros((slots,), dtype=torch.float32, device=dev)
        self._poisoned = False
        # the record of the last tick or admission, (slots, w + 4) int32:
        # tokens right-padded to w = spec_k + 1, counts, done, accepted
        # drafts, non-finite flag; cloned into _pending after each call
        self._rec = torch.zeros((slots, self.spec_k + 5), dtype=torch.int32,
                                device=dev)
        # admission inputs, filled from the host before each round: lengths,
        # the (slots,) slot map (padding rows point at `slots`, dropped),
        # budgets, and the right-padded tokens of each bucket
        self._in_lens = torch.ones((slots,), dtype=torch.int32, device=dev)
        self._in_map = torch.full((slots,), slots, dtype=torch.int64,
                                  device=dev)
        self._in_budget = torch.ones((slots,), dtype=torch.int32, device=dev)
        self._in_toks: Dict[int, torch.Tensor] = {}
        # host-side bookkeeping
        self.queue: List[Request] = []
        self._slot_req: List[Optional[Request]] = [None] * slots
        self._ticks_left = [0] * slots        # deterministic lifetime bound
        # pending records, one per admission and per tick: (record clone,
        # owners, kind)
        self._pending: List[Tuple[torch.Tensor, Tuple, str]] = []
        self._finished: List[Request] = []    # synced but not yet returned
        self._uid = 0
        self.decode_calls = 0                 # ticks == decode_step calls
        self.prefill_calls = 0                # batched prefill invocations
        self.poisoned_count = 0               # slots quarantined (non-finite)
        self._bucket_cap = self.mod.cache_len_for(cfg, max_len)

    @property
    def captures(self) -> Dict[str, Any]:
        """CUDA graphs captured: ``{"tick": n, "admit": {bucket: n}}`` —
        at most one tick and one graph per admission bucket (the
        reference's compile count); zeros when the engine runs eagerly."""
        c = self.graphs.captures
        return {"tick": c.get("tick", 0),
                "admit": {k[1]: v for k, v in sorted(
                    (k, v) for k, v in c.items() if k != "tick")}}

    # --- device work (each a graph body: fixed tensors in and out) ----------

    def _eos(self) -> int:
        return -1 if self.eos_id is None else int(self.eos_id)  # -1 never hits

    def _prefill(self, toks: torch.Tensor, lengths: torch.Tensor):
        return self.mod.prefill(self.params, {"tokens": toks}, self.cfg,
                                policy=self.policy, dtype=self.dtype,
                                max_len=self.max_len, lengths=lengths,
                                attn_chunk=self.attn_chunk,
                                **self._kw["prefill"])

    def _record(self, toks, counts, done, accepted=None, bad=None):
        """Write this call's record into the fixed ``_rec`` buffer."""
        w, t = self.spec_k + 1, toks.shape[1]
        self._rec[:, :t].copy_(toks)
        if t < w:
            self._rec[:, t:w].zero_()
        for j, col in enumerate((counts, done, accepted, bad)):
            if col is None:
                self._rec[:, w + j].zero_()
            else:
                self._rec[:, w + j].copy_(col)

    def _spec_tick(self):
        """Advance every active slot by 1..spec_k+1 tokens: the shared
        ``spec_decode_tick`` core plus the budget / EOS cut of each window.
        Inactive and non-finite rows are frozen on the device (their writes
        fully rewound, token and length held)."""
        active = self._active
        mkw = dict(policy=self.policy, dtype=self.dtype)
        cache, dcache, a, out, nxt, row_ok = spec_decode_tick(
            self.mod, self.dmod, self.params, self.draft_params, self.cfg,
            self.draft_cfg, self.cache, self.draft_cache, self._tokens,
            active, spec_k=self.spec_k, temperature=self.temperature,
            generator=self._gen, mkw=mkw, dmkw=mkw,
            attn_kw=self._kw["decode"], dattn_kw=self._kw["decode"],
            logit_bias=self._poison)
        bad = active & ~row_ok
        eff = active & row_ok
        n, done = emit_counts(out, a, active=eff, emitted=self._emitted,
                              budget=self._budget, eos_id=self._eos())
        self.cache["len"].copy_(cache["len"])
        self.draft_cache["len"].copy_(dcache["len"])
        self._record(out, n, done, torch.where(eff, a, torch.zeros_like(a)),
                     bad)
        self._tokens.copy_(nxt)
        self._active.copy_(eff & ~done)
        self._emitted.add_(n)

    def _tick(self):
        """Advance every active slot one token; masks computed on-device.
        K/V of inactive rows are written at their held position and
        overwritten later, as in the reference; their length is held. A row
        whose logits (plus ``poison``) are not all finite is frozen the
        same way and deactivated; its record flags it."""
        tokens, active = self._tokens, self._active
        logits, new_cache = self.mod.decode_step(
            self.params, self.cache, tokens, self.cfg, policy=self.policy,
            dtype=self.dtype, **self._kw["decode"])
        logits = logits + self._poison[:, None, None]
        bad = active & ~torch.isfinite(logits).all(dim=2).all(dim=1)
        ok = active & ~bad
        nxt = _sample(self._gen, logits[:, 0], self.temperature).to(torch.int32)
        nxt = torch.where(ok, nxt, tokens[:, 0])     # freeze inactive + bad
        emitted = self._emitted + ok.to(torch.int32)
        done = ok & ((emitted >= self._budget) | (nxt == self._eos()))
        self.cache["len"].copy_(torch.where(ok, new_cache["len"],
                                            self.cache["len"]))
        # counts: the slots active before the tick (a bad one's tokens are
        # skipped at sync, as in the reference)
        self._record(nxt[:, None], active, done, None, bad)
        self._tokens.copy_(nxt[:, None])
        self._active.copy_(ok & ~done)
        self._emitted.copy_(emitted)

    def _admit(self, toks: torch.Tensor):
        """Prefill the admission buffers' rows (``toks``, one bucket), insert
        them into slots ``_in_map`` and sample each row's first token; rows
        whose slot is ``>= slots`` are batch padding, dropped on the device.
        With speculation the drafter's prefill rides the same round."""
        lens, slot_map, bud = self._in_lens, self._in_map, self._in_budget
        logits0, src = self._prefill(toks, lens)
        self.mod.insert_prefill_many(self.cache, slot_map, src)
        t0 = _sample(self._gen, logits0[:, 0], self.temperature).to(torch.int32)
        # the prefill sample already counts: a max_new == 1 request (or an
        # immediate EOS) never becomes active
        act0 = (bud > 1) & (t0 != self._eos())
        index_drop_(self._tokens, slot_map, t0[:, None])
        index_drop_(self._active, slot_map, act0)
        index_drop_(self._emitted, slot_map, torch.ones_like(t0))
        index_drop_(self._budget, slot_map, bud)
        if self.spec_k:
            # the drafter needs the prompt in ITS cache too (its logits are
            # unused: the target samples every committed token)
            _, dsrc = self.dmod.prefill(
                self.draft_params, {"tokens": toks}, self.draft_cfg,
                policy=self.policy, dtype=self.dtype, max_len=self.max_len,
                lengths=lens, attn_chunk=self.attn_chunk,
                **self._kw["prefill"])
            self.dmod.insert_prefill_many(self.draft_cache, slot_map, dsrc)
        admitted = index_drop_(torch.zeros_like(self._active), slot_map, True)
        self._record(self._tokens, admitted, admitted & ~self._active)

    # --- public API ---------------------------------------------------------

    def submit(self, prompt: List[int], max_new: int = 16) -> SubmitOutcome:
        """Enqueue a request. Malformed requests raise ``SubmitRejected``
        with a machine-readable ``reason``; accepted ones return a
        ``SubmitOutcome`` whose int value is the uid."""
        if len(prompt) == 0:
            raise SubmitRejected("empty_prompt",
                                 "prompt must contain at least one token")
        if max_new < 1:
            raise SubmitRejected("bad_max_new",
                                 f"max_new must be >= 1, got {max_new}")
        if len(prompt) + max_new + self.spec_k > self.max_len:
            # speculative verify writes up to spec_k positions past the
            # last committed token: reserve that headroom in the cache
            total = len(prompt) + max_new + self.spec_k
            label = (f"prompt+max_new+spec_k ({len(prompt)}+{max_new}"
                     f"+{self.spec_k}={total})" if self.spec_k
                     else f"prompt+max_new ({total})")
            raise SubmitRejected(
                "too_long", f"{label} exceeds engine max_len {self.max_len}")
        self._uid += 1
        self.queue.append(Request(self._uid, list(prompt), max_new))
        return SubmitOutcome(self._uid, accepted=True)

    @property
    def spec_accept_rate(self) -> float:
        """Share of draft proposals the target accepted (drain-synced)."""
        return (self.spec_accepted / self.spec_drafted if self.spec_drafted
                else 0.0)

    def _bucket_len(self, plen: int) -> int:
        """Admission bucket: next power of two >= plen (floor _MIN_BUCKET),
        capped at the cache length."""
        return min(max(_MIN_BUCKET, 1 << (plen - 1).bit_length()),
                   self._bucket_cap)

    def _free_slots(self) -> List[int]:
        return [s for s in range(self.slots) if self._slot_req[s] is None]

    def _occupied(self) -> bool:
        return any(r is not None for r in self._slot_req)

    def _spin_up(self):
        """Admit queued requests into free slots, one length bucket at a
        time: every same-bucket queued request enters through ONE batched
        prefill + ONE multi-slot insert."""
        if not self.queue:
            return
        free = self._free_slots()
        if not free and (self.eos_id is not None or self.spec_k):
            # an EOS — or, with speculation, a multi-token burst through
            # the budget — may have freed a slot we haven't observed yet
            self._sync()
            free = self._free_slots()
        while self.queue and free:
            bucket = self._bucket_len(len(self.queue[0].admit_prompt))
            batch: List[Request] = []
            rest: List[Request] = []
            for r in self.queue:
                if (len(batch) < len(free)
                        and self._bucket_len(len(r.admit_prompt)) == bucket):
                    batch.append(r)
                else:
                    rest.append(r)
            self.queue = rest
            slot_ids = [free.pop(0) for _ in batch]
            self._admit_batch(slot_ids, batch, bucket)

    def _admit_batch(self, slot_ids: List[int], reqs: List[Request],
                     bucket: int):
        """Prefill ``reqs`` (one length bucket) right-padded to ``bucket`` in
        a single call, then scatter them into ``slot_ids``. The batch is
        pinned to ``slots`` rows: dummy rows have length 1 and an
        out-of-range slot. The host fills the admission buffers; the work
        is the bucket's graph."""
        n = self.slots
        toks = np.zeros((n, bucket), np.int32)
        lens = np.ones((n,), np.int32)            # dummy rows: valid length 1
        slot_map = np.full((n,), self.slots, np.int64)   # OOB -> dropped
        budgets = np.ones((n,), np.int32)
        for i, (s, r) in enumerate(zip(slot_ids, reqs)):
            ap = r.admit_prompt
            toks[i, :len(ap)] = ap
            lens[i], slot_map[i], budgets[i] = len(ap), s, r.remaining
        buf = self._in_toks.get(bucket)
        if buf is None:
            buf = self._in_toks[bucket] = torch.zeros(
                (n, bucket), dtype=torch.int32, device=self.device)
        for dst, src in ((buf, toks), (self._in_lens, lens),
                         (self._in_map, slot_map),
                         (self._in_budget, budgets)):
            dst.copy_(torch.from_numpy(src))
        # warm-ups run with every row dropped, so they change no slot
        self.graphs.run(("admit", bucket), lambda: self._admit(buf),
                        idle=lambda: masked(self._in_map, self.slots))
        self.prefill_calls += 1
        for s, r in zip(slot_ids, reqs):
            self._slot_req[s] = r
            self._ticks_left[s] = r.remaining - 1
        self._pending.append((self._rec.clone(), tuple(self._slot_req),
                              "admit"))
        for s in slot_ids:
            if self._ticks_left[s] <= 0:
                self._slot_req[s] = None

    def _load_poison(self):
        """The tick's ``poison``: NaN at the slots the fault plan poisons at
        this tick, else zeros (written only when it changes)."""
        fp = self.fault_plan
        bad = [] if fp is None else [s for s in fp.nan_slots_at(
            self.decode_calls) if s < self.slots]
        if bad or self._poisoned:
            v = np.zeros((self.slots,), np.float32)
            v[bad] = np.nan
            self._poison.copy_(torch.from_numpy(v))
            self._poisoned = bool(bad)

    @torch.no_grad()
    def step(self):
        """Admit, then advance ALL active slots with ONE decode call.
        Asynchronous: emitted tokens stay on device until ``drain()``."""
        self._spin_up()
        if not self._occupied():
            return
        owners = tuple(self._slot_req)
        self._load_poison()
        # warm-ups run with every slot inactive, so they change no slot
        self.graphs.run("tick", self._spec_tick if self.spec_k else self._tick,
                        idle=lambda: masked(self._active, False))
        self._pending.append((self._rec.clone(), owners, "tick"))
        self.decode_calls += 1
        for s in range(self.slots):
            if self._slot_req[s] is not None:
                # with speculation an upper bound: a tick emits >= 1 token
                self._ticks_left[s] -= 1
                if self._ticks_left[s] <= 0:
                    self._slot_req[s] = None     # budget exhausted this tick

    def _finish(self, req: Request, status: str):
        req.status = status
        req.done = True
        self._finished.append(req)

    def _release(self, s: int):
        self._slot_req[s] = None
        self._ticks_left[s] = 0

    def _sync(self):
        """Bulk-sync everything recorded since the last sync (ONE device to
        host copy) and attribute tokens to requests via the per-record owner
        snapshots; a record carries 1..spec_k+1 tokens per slot. Per-request
        ``ticks`` / ``accept_hist`` and the engine's ``spec_drafted`` /
        ``spec_accepted`` are folded in here. A row flagged non-finite
        contributes no token; its request finishes ``"poisoned"``, and a
        slot it still holds is released with its cache rows zeroed.
        Finished requests wait in ``_finished`` for ``drain()``."""
        if not self._pending:
            return
        moved = torch.stack([rec for rec, _, _ in self._pending]).cpu().numpy()
        w = self.spec_k + 1
        quarantined: List[int] = []
        for rec, (_, owners, kind) in zip(moved, self._pending):
            toks, counts, dn = rec[:, :w], rec[:, w], rec[:, w + 1]
            bad = rec[:, w + 3]
            for s in np.nonzero(counts)[0]:
                req = owners[s]
                if req is not None and not bad[s]:
                    n = int(counts[s])
                    req.out.extend(int(x) for x in toks[s, :n])
                    if kind == "tick":
                        req.ticks += 1
                        req.accept_hist[n] = req.accept_hist.get(n, 0) + 1
            if kind == "tick" and self.spec_k:
                live = counts > 0
                self.spec_drafted += int(self.spec_k * live.sum())
                self.spec_accepted += int(rec[live, w + 2].sum())
            for s in np.nonzero(dn)[0]:
                req = owners[s]
                if req is not None and not req.done:
                    self._finish(req, "ok")
                    if self._slot_req[s] is req:   # early EOS: free the slot
                        self._release(s)
            for s in np.nonzero(bad)[0]:
                req = owners[s]
                if req is not None and not req.done:
                    self.poisoned_count += 1
                    self._finish(req, "poisoned")
                    if self._slot_req[s] is req:
                        self._release(s)
                        quarantined.append(s)
        self._pending.clear()
        if quarantined:
            # the tick already deactivated the rows; zeroing them keeps the
            # contaminated state from the slot's next tenant
            self.mod.free_slots(self.cache, quarantined)
            if self.spec_k:
                self.dmod.free_slots(self.draft_cache, quarantined)

    def drain(self) -> List[Request]:
        """Sync pending emissions and return every request that finished
        since the last ``drain()`` call."""
        self._sync()
        out, self._finished = self._finished, []
        return out

    def run_all(self) -> List[Request]:
        """Drive until queue and slots are empty; drains every
        ``drain_every`` ticks."""
        done: List[Request] = []
        while self.queue or self._occupied():
            self.step()
            if self.decode_calls % self.drain_every == 0:
                done.extend(self.drain())
        done.extend(self.drain())
        return done
