"""Batched continuous-batching serving engine — port of the reference's
``serving/engine.py`` without speculative decoding, overload hardening or
durability.

  * ONE shared slot-major cache — ``(slots, ...)`` rows with per-slot
    length counters — allocated once at construction. The reference
    donates it to every jitted tick and admission; here the same effect is
    had by updating that one cache in place (``decode_step``,
    ``insert_prefill_many``), so no call ever copies it.
  * Admission is LENGTH-BUCKETED and batched: queued prompts are right-
    padded to power-of-two buckets (floor ``_MIN_BUCKET``, capped at the
    cache length) and every same-bucket request is prefilled in ONE call
    and inserted with ONE multi-slot scatter. The prefill batch is pinned
    to ``slots``: dummy rows have length 1 and an out-of-range slot, so
    the scatter drops them. ``prefill_calls`` counts these calls.
  * ONE eager ``decode_step`` per tick advances every slot at once.
    Sampling and termination (budget / EOS) are computed on the device as
    masks; inactive slots are frozen there (token and length held), so a
    tick never asks the host which slots are live. ``decode_calls`` counts
    ticks.
  * Tokens cross to the host only in bulk at ``drain()`` — no per-token
    sync. With ``eos_id=None`` lifetimes are host-predictable and
    admission needs no sync at all.

A tick that fails raises: the reference's degradation ladder is not ported.
At T > 0 the sampled streams differ from the reference's (``torch``
generator vs ``jax.random``); at T = 0 both are greedy.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.precision import QuantPolicy
from repro_torch.core.quant_dense import MATMUL_MODES
from repro_torch.models import api as model_api
from repro_torch.models import get_model
from repro_torch.models.attention import ATTN_MODES
from repro_torch.serving.resilience import SubmitOutcome, SubmitRejected

__all__ = ["generate", "Request", "ServingEngine", "SubmitOutcome",
           "SubmitRejected"]

# smallest admission bucket: prompts of length 1..8 share one shape
_MIN_BUCKET = 8


def _sample(gen: torch.Generator, logits: torch.Tensor,
            temperature: float) -> torch.Tensor:
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0]


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
             device="cuda") -> torch.Tensor:
    """prompts (B, P) int -> (B, P + max_new_tokens) on ``device``: one
    prefill, then one decode step per token."""
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


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False

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
    request's bucket, and other same-bucket requests ride along.
    """

    def __init__(self, params, cfg: ModelConfig, *, policy: QuantPolicy,
                 slots: int = 8, max_len: int = 512, dtype=torch.bfloat16,
                 temperature: float = 0.0, eos_id: Optional[int] = None,
                 seed: int = 0, drain_every: int = 4,
                 matmul_mode: str = "auto", attn_mode: str = "auto",
                 kv_bits: Optional[int] = None, attn_chunk: int = 1024,
                 device="cuda"):
        self._kw = _serve_kwargs(matmul_mode, attn_mode, kv_bits)
        self.device = torch.device(device)
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
        # shared slot-major cache, allocated ONCE and updated in place
        self.cache = model_api.init_cache(cfg, slots, max_len, dtype,
                                          per_slot_len=True, kv_bits=kv_bits,
                                          device=self.device)
        # per-slot device state (replaced, never mutated: pending records
        # keep references to earlier tensors)
        dev = self.device
        self._tokens = torch.zeros((slots, 1), dtype=torch.int32, device=dev)
        self._active = torch.zeros((slots,), dtype=torch.bool, device=dev)
        self._emitted = torch.zeros((slots,), dtype=torch.int32, device=dev)
        self._budget = torch.zeros((slots,), dtype=torch.int32, device=dev)
        self._gen = torch.Generator(device=dev).manual_seed(seed)
        # host-side bookkeeping
        self.queue: List[Request] = []
        self._slot_req: List[Optional[Request]] = [None] * slots
        self._ticks_left = [0] * slots        # deterministic lifetime bound
        # pending records: (tokens (slots, 1), emitted mask, done mask,
        # owners) — one per admission and per tick
        self._pending: List[Tuple] = []
        self._finished: List[Request] = []    # synced but not yet returned
        self._uid = 0
        self.decode_calls = 0                 # ticks == decode_step calls
        self.prefill_calls = 0                # batched prefill invocations
        self._bucket_cap = self.mod.cache_len_for(cfg, max_len)

    # --- device work --------------------------------------------------------

    def _eos(self) -> int:
        return -1 if self.eos_id is None else int(self.eos_id)  # -1 never hits

    def _prefill(self, toks: torch.Tensor, lengths: torch.Tensor):
        return self.mod.prefill(self.params, {"tokens": toks}, self.cfg,
                                policy=self.policy, dtype=self.dtype,
                                max_len=self.max_len, lengths=lengths,
                                attn_chunk=self.attn_chunk,
                                **self._kw["prefill"])

    def _tick(self):
        """Advance every active slot one token; masks computed on-device.
        K/V of inactive rows are written at their held position and
        overwritten later, as in the reference; their length is held."""
        tokens, active = self._tokens, self._active
        old_len = self.cache["len"]
        logits, new_cache = self.mod.decode_step(
            self.params, self.cache, tokens, self.cfg, policy=self.policy,
            dtype=self.dtype, **self._kw["decode"])
        nxt = _sample(self._gen, logits[:, 0], self.temperature).to(torch.int32)
        nxt = torch.where(active, nxt, tokens[:, 0])      # freeze inactive
        emitted = self._emitted + active.to(torch.int32)
        done = active & ((emitted >= self._budget) | (nxt == self._eos()))
        new_cache["len"] = torch.where(active, new_cache["len"], old_len)
        self.cache = new_cache
        self._tokens, self._active = nxt[:, None], active & ~done
        self._emitted = emitted
        return done

    def _admit_many(self, slot_map: np.ndarray, src, logits0,
                    req_budget: np.ndarray):
        """Insert an N-row batched prefill into slots ``slot_map`` and sample
        every row's first token. Rows with ``slot_map[i] >= slots`` are
        batch padding and are dropped; the filter runs on the host."""
        self.cache = self.mod.insert_prefill_many(self.cache, slot_map, src)
        dev = self.device
        t0 = _sample(self._gen, logits0[:, 0], self.temperature).to(torch.int32)
        rows_np = np.nonzero(slot_map < self.slots)[0]
        rows = torch.as_tensor(rows_np, device=dev)
        dst = torch.as_tensor(slot_map[rows_np], device=dev).long()
        bud = torch.as_tensor(req_budget[rows_np], device=dev)
        t0 = t0[rows]
        # the prefill sample already counts: a max_new == 1 request (or an
        # immediate EOS) never becomes active
        act0 = (bud > 1) & (t0 != self._eos())
        self._tokens = self._tokens.index_put((dst,), t0[:, None])
        self._active = self._active.index_put((dst,), act0)
        self._emitted = self._emitted.index_put((dst,), torch.ones_like(t0))
        self._budget = self._budget.index_put((dst,), bud.to(torch.int32))

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
        if len(prompt) + max_new > self.max_len:
            raise SubmitRejected(
                "too_long", f"prompt+max_new ({len(prompt) + max_new}) "
                            f"exceeds engine max_len {self.max_len}")
        self._uid += 1
        self.queue.append(Request(self._uid, list(prompt), max_new))
        return SubmitOutcome(self._uid, accepted=True)

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
        if not free and self.eos_id is not None:
            # an EOS may have freed a slot we haven't observed yet
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
        out-of-range slot."""
        n = self.slots
        toks = np.zeros((n, bucket), np.int32)
        lens = np.ones((n,), np.int32)            # dummy rows: valid length 1
        slot_map = np.full((n,), self.slots, np.int64)   # OOB -> dropped
        budgets = np.ones((n,), np.int32)
        for i, (s, r) in enumerate(zip(slot_ids, reqs)):
            ap = r.admit_prompt
            toks[i, :len(ap)] = ap
            lens[i], slot_map[i], budgets[i] = len(ap), s, r.remaining
        logits0, src = self._prefill(torch.as_tensor(toks, device=self.device),
                                     torch.as_tensor(lens, device=self.device))
        self.prefill_calls += 1
        self._admit_many(slot_map, src, logits0, budgets)
        mask_np = np.zeros((self.slots,), bool)
        for s, r in zip(slot_ids, reqs):
            self._slot_req[s] = r
            self._ticks_left[s] = r.remaining - 1
            mask_np[s] = True
        mask = torch.as_tensor(mask_np, device=self.device)
        self._pending.append((self._tokens, mask, mask & ~self._active,
                              tuple(self._slot_req)))
        for s in slot_ids:
            if self._ticks_left[s] <= 0:
                self._slot_req[s] = None

    @torch.no_grad()
    def step(self):
        """Admit, then advance ALL active slots with ONE decode call.
        Asynchronous: emitted tokens stay on device until ``drain()``."""
        self._spin_up()
        if not self._occupied():
            return
        emitted_mask = self._active                  # who emits this tick
        owners = tuple(self._slot_req)
        done = self._tick()
        self._pending.append((self._tokens, emitted_mask, done, owners))
        self.decode_calls += 1
        for s in range(self.slots):
            if self._slot_req[s] is not None:
                self._ticks_left[s] -= 1
                if self._ticks_left[s] <= 0:
                    self._slot_req[s] = None     # budget exhausted this tick

    def _sync(self):
        """Bulk-sync everything emitted since the last sync (ONE device to
        host copy) and attribute tokens to requests via the per-record owner
        snapshots. Finished requests wait in ``_finished`` for ``drain()``."""
        if not self._pending:
            return
        moved = torch.stack([torch.stack([toks[:, 0], em.to(torch.int32),
                                          dn.to(torch.int32)])
                             for toks, em, dn, _ in self._pending]).cpu()
        moved = moved.numpy()
        for (toks, em, dn), (_, _, _, owners) in zip(moved, self._pending):
            for s in np.nonzero(em)[0]:
                req = owners[s]
                if req is not None:
                    req.out.append(int(toks[s]))
            for s in np.nonzero(dn)[0]:
                req = owners[s]
                if req is not None and not req.done:
                    req.done = True
                    self._finished.append(req)
                    if self._slot_req[s] is req:   # early EOS: free the slot
                        self._slot_req[s] = None
                        self._ticks_left[s] = 0
        self._pending.clear()

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
