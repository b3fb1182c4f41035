"""Batched continuous-batching serving engine — port of the reference's
``serving/engine.py``: speculative decoding, the NaN quarantine, overload
hardening and durability.

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
    A prompt longer than the bucket cap (past a sliding-window ring) is
    admitted alone at its exact length, eagerly (the reference traces one
    prefill per such length); the ring roll in ``prefill`` places it.
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

Overload hardening (``serving.resilience``): admission is BOUNDED
(``queue_limit``, ``shed_policy`` "reject" / "drop_oldest", ``shed_count``,
``queue_peak``); per-request DEADLINES (``submit(deadline_ticks=)``,
``default_deadline``) cancel a request in the queue or mid-stream
(``status == "deadline"``, partial output kept); PREEMPTION
(``preempt_after``) frees a slot held that long while the queue has
waiters and requeues its request through bucketed admission with its
committed tokens. A slot released outside the tick is deactivated and its
cache rows zeroed by fixed-length, in-place device writes between calls
(``index_drop_``, ``free_slots``), never inside a graph. A failed tick
walks the DEGRADATION LADDER (spec -> plain tick, kernels -> their plain
versions); each step drops the captured graphs, which the next call
captures again in the new mode (``captures`` counts both), and is recorded
in ``fallback_events`` and logged. On a CUDA device only an injected
``FaultPlan`` failure walks it: any other failure raises.
``run_all(max_ticks=)`` is a WATCHDOG raising ``WatchdogExpired`` with a
diagnostic dump.

Durability (``serving.durability``, ``checkpoint.integrity``): SNAPSHOTS
(``snapshot_dir`` / ``snapshot_every`` or ``snapshot()``) persist the
device state — caches, per-slot vectors, the sampling generator's state —
and all host bookkeeping; ``restore()`` writes them back IN PLACE, into
the tensors the captured graphs read. A WRITE-AHEAD JOURNAL (``journal=``)
logs submit / admit / commit / finish / shed events, so ``recover()`` on a
fresh engine restores the latest snapshot and resubmits the journal tail.
The WEIGHT-INTEGRITY probe (``integrity_every``, optional ``golden_dir``)
fingerprints the protected leaves every N ticks (a graph of its own on the
card); a mismatch reloads the corrupt leaf from its golden copy IN PLACE
and rewinds the requests that could have read it. ``FaultPlan``'s
``flip_bits`` also write in place, into the engine's own copy of each leaf
the plan names, so an injected flip reaches the captured tick, the heal
repairs what it reads, and the caller's tensors stay clean.

Token parity across preemption, crash recovery and spec -> plain holds in
fp32 without activation quantization, as in the reference; in bf16
prefill and decode round in different orders. At T > 0 the sampled
streams differ from the reference's (``torch`` generator vs
``jax.random``); at T = 0 both are greedy.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.graphs import Graphs, index_drop_, kept, masked
from repro_torch.core.precision import QuantPolicy
from repro_torch.core.quant_dense import MATMUL_MODES
from repro_torch.core.treeutil import (flatten_with_path, tree_get,
                                      tree_set, tree_write_, unflatten)
from repro_torch.models import api as model_api
from repro_torch.models import get_model
from repro_torch.models.attention import ATTN_MODES
from repro_torch.serving import resilience
from repro_torch.serving.resilience import (FaultPlan, SubmitOutcome,
                                            SubmitRejected, WatchdogExpired)
from repro_torch.serving.spec import (categorical, emit_counts,
                                      spec_decode_tick)

__all__ = ["generate", "check_family", "Request", "ServingEngine",
           "FaultPlan", "SubmitOutcome", "SubmitRejected", "WatchdogExpired"]

# smallest admission bucket: prompts of length 1..8 share one shape
_MIN_BUCKET = 8
# the cache subtrees that hold a recurrent (non-KV) state: ssm's layers,
# hybrid's mamba groups and tail
_RECURRENT = ("layers", "groups", "tail")

_log = logging.getLogger(__name__)


def _sample(gen: torch.Generator, logits: torch.Tensor,
            temperature: float) -> torch.Tensor:
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
    return categorical(probs, gen)


def _generator(device: torch.device, seed: int) -> torch.Generator:
    """The sampling generator on ``device``. A build of torch without CUDA
    has no CUDA generator: there a ``"cuda"`` engine can only hold fake
    tensors (``repro_torch.analysis`` traces its graphs under
    ``FakeTensorMode``, and its sampling draws nothing), and it gets a CPU
    generator of the same seed in its place. An engine on a real card
    always draws from a CUDA generator."""
    if device.type == "cuda" and not torch.cuda.is_available():
        return torch.Generator().manual_seed(seed)
    return torch.Generator(device=device).manual_seed(seed)


def check_family(cfg: ModelConfig, *, kv_bits: Optional[int] = None,
                 spec_k: int = 0):
    """Refuse the knobs ``cfg``'s family cannot take, with the engine's
    errors: ``ssm`` has no KV cache to quantize, and its state folds every
    token irreversibly, so rejected drafts cannot be rewound."""
    if cfg.family != "ssm":
        return
    if kv_bits:
        raise ValueError("kv_bits=8 is meaningless for family 'ssm': it "
                         "has no KV cache to quantize")
    if spec_k:
        raise ValueError("speculative decoding is unavailable for family "
                         "'ssm': the SSD state folds every token "
                         "irreversibly, so rejected drafts can't be rewound")


def _serve_kwargs(cfg: ModelConfig, matmul_mode: str, attn_mode: str,
                  kv_bits: Optional[int]) -> Dict[str, Dict[str, Any]]:
    """Validated per-call kwargs for the serving knobs: ``attn_mode`` goes
    to prefill and decode, ``kv_bits=8`` becomes
    ``prefill(quantize_cache=True)`` — for the attention-bearing families;
    ``ssm`` takes neither (no attention, no KV cache), and asking it to
    quantize one is a config error, not a silent no-op."""
    if matmul_mode not in MATMUL_MODES:
        raise ValueError(f"matmul_mode must be one of {MATMUL_MODES}, "
                         f"got {matmul_mode!r}")
    if attn_mode not in ATTN_MODES:
        raise ValueError(f"attn_mode must be one of {ATTN_MODES}, "
                         f"got {attn_mode!r}")
    if kv_bits not in (None, 8):
        raise ValueError(f"kv_bits must be None or 8, got {kv_bits!r}")
    check_family(cfg, kv_bits=kv_bits)
    if cfg.family == "ssm":
        mm = {"matmul_mode": matmul_mode}
        return {"prefill": mm, "decode": mm}
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
    kw = _serve_kwargs(cfg, matmul_mode, attn_mode, kv_bits)
    gen = _generator(prompts.device, seed)
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


def _no_ring_wrap(mod, cfg: ModelConfig, max_len: int):
    """Speculative rollback is a length rewind: a sliding-window ring that
    wraps during the verify window would have overwritten live entries no
    rewind can restore. Forbid the configuration instead of corrupting."""
    if mod.cache_len_for(cfg, max_len) < max_len:
        raise ValueError(
            f"speculative decoding needs max_len <= sliding_window "
            f"({cfg.sliding_window}) for {cfg.name}: a wrapped KV ring "
            f"cannot be rolled back (got max_len {max_len})")


def _spec_models(params, cfg: ModelConfig, draft_params,
                 draft_cfg: Optional[ModelConfig]):
    """The drafter for ``params``: derived from the target checkpoint
    (``api.draft_of``) when none is given. Neither may be ``ssm``: its
    state cannot be rewound past rejected drafts."""
    check_family(cfg, spec_k=1)
    if draft_params is None:
        draft_cfg, draft_params = model_api.draft_of(cfg, params)
    else:
        draft_cfg = draft_cfg or cfg
    if draft_cfg.family == "ssm":
        raise ValueError("the speculative DRAFTER can't be family 'ssm': "
                         "its state can't be rewound past rejected drafts")
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
    _no_ring_wrap(mod, cfg, max_len)
    _no_ring_wrap(dmod, draft_cfg, max_len)
    kw = _serve_kwargs(cfg, matmul_mode, attn_mode, kv_bits)
    mkw = dict(policy=policy, dtype=dtype)
    gen = _generator(prompts.device, seed)
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
    # terminal outcome, one of resilience.STATUS ("ok" unless cancelled,
    # shed or quarantined), absolute expiry in decode ticks (None: no
    # deadline), times preempted, host clock stamps of submit and finish
    status: str = "ok"
    deadline_at: Optional[int] = None
    preemptions: int = 0
    submit_time: float = 0.0
    finish_time: float = 0.0

    @property
    def admit_prompt(self) -> List[int]:
        """What admission prefills: the prompt plus every committed token
        (a preempted or healed request re-enters with its progress)."""
        return self.prompt + self.out

    @property
    def remaining(self) -> int:
        """Tokens still owed."""
        return self.max_new - len(self.out)


class ServingEngine:
    """Slot-based continuous batching: one decode call per tick, all slots.

    ``step()`` = durability hooks + deadlines + admit + one batched tick
    (asynchronous — tokens stay on the device); ``drain()`` = bulk host
    transfer of everything emitted since the last drain; ``run_all()`` =
    drive until queue and slots are empty. Admission is FIFO by bucket:
    each round serves the oldest queued request's bucket, and other
    same-bucket requests ride along. With ``spec_k >= 1`` a tick is one
    speculative tick (draft, verify, accept, rollback of both caches) and
    emits 1..spec_k+1 tokens per slot.

    ``capture`` (default: on for a CUDA device) replays the tick, each
    admission bucket and the integrity probe as CUDA graphs; ``captures``
    reports them. ``fault_plan`` injects a ``resilience.FaultPlan``. The
    overload and durability knobs are the reference's: ``queue_limit`` /
    ``shed_policy``, ``default_deadline``, ``preempt_after``,
    ``max_ticks``, ``degrade``, ``snapshot_dir`` / ``snapshot_every``,
    ``journal``, ``integrity_every`` / ``golden_dir``.
    """

    def __init__(self, params, cfg: ModelConfig, *, policy: QuantPolicy,
                 slots: int = 8, max_len: int = 512, dtype=torch.bfloat16,
                 temperature: float = 0.0, eos_id: Optional[int] = None,
                 seed: int = 0, drain_every: int = 4,
                 matmul_mode: str = "auto", attn_mode: str = "auto",
                 kv_bits: Optional[int] = None, attn_chunk: int = 1024,
                 spec_k: int = 0, draft_params=None,
                 draft_cfg: Optional[ModelConfig] = None,
                 queue_limit: Optional[int] = None,
                 shed_policy: str = "reject",
                 default_deadline: Optional[int] = None,
                 preempt_after: Optional[int] = None,
                 max_ticks: Optional[int] = None, degrade: bool = True,
                 fault_plan: Optional[FaultPlan] = None,
                 snapshot_dir: Optional[str] = None,
                 snapshot_every: Optional[int] = None,
                 journal=None,
                 integrity_every: Optional[int] = None,
                 golden_dir: Optional[str] = None,
                 capture: Optional[bool] = None, device="cuda"):
        self._kw = _serve_kwargs(cfg, matmul_mode, attn_mode, kv_bits)
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if shed_policy not in resilience.SHED_POLICIES:
            raise ValueError(f"shed_policy must be one of "
                             f"{resilience.SHED_POLICIES}, got {shed_policy!r}")
        for name, val in (("queue_limit", queue_limit),
                          ("default_deadline", default_deadline),
                          ("preempt_after", preempt_after),
                          ("max_ticks", max_ticks),
                          ("snapshot_every", snapshot_every),
                          ("integrity_every", integrity_every)):
            if val is not None and val < 1:
                raise ValueError(f"{name} must be >= 1 or None, got {val}")
        self.device = torch.device(device)
        self._gen = _generator(self.device, seed)
        self.graphs = Graphs(self.device, capture=capture,
                             generator=self._gen)
        self.params = _to_device(params, self.device)
        if fault_plan is not None:
            # a flip (and its heal) writes in place: into the engine's own
            # copy of each leaf the plan names, never the caller's tensor. A
            # path that names no leaf raises at its tick, as in the reference
            for path in sorted({p for _, p, _ in fault_plan.flip_bits}):
                try:
                    leaf = tree_get(self.params, path)
                except KeyError:
                    continue
                self.params = tree_set(self.params, path, leaf.clone())
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
        self._was_spec = False                # degraded out of spec mode
        self.draft_cache = None
        if self.spec_k:
            draft_params, self.draft_cfg = _spec_models(
                params, cfg, draft_params, draft_cfg)
            self.draft_params = _to_device(draft_params, self.device)
            self.dmod = get_model(self.draft_cfg)
            _no_ring_wrap(self.mod, cfg, max_len)
            _no_ring_wrap(self.dmod, self.draft_cfg, max_len)
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
        # the record of the last tick or admission (see _new_rec), cloned
        # into _pending after each call
        self._rec = self._new_rec()
        # admission inputs, filled from the host before each round: lengths,
        # the (slots,) slot map (padding rows point at `slots`, dropped),
        # budgets, and the right-padded tokens of each bucket
        self._in_lens = torch.ones((slots,), dtype=torch.int32, device=dev)
        self._in_map = torch.full((slots,), slots, dtype=torch.int64,
                                  device=dev)
        self._in_budget = torch.ones((slots,), dtype=torch.int32, device=dev)
        self._in_toks: Dict[int, torch.Tensor] = {}
        # the slots a release deactivates and zeroes, padded with `slots`
        self._free_idx = torch.full((slots,), slots, dtype=torch.int64,
                                    device=dev)
        # host-side bookkeeping
        self.queue: List[Request] = []
        self._slot_req: List[Optional[Request]] = [None] * slots
        self._ticks_left = [0] * slots        # deterministic lifetime bound
        self._slot_ticks = [0] * slots        # ticks the current owner held
        # pending records, one per admission and per tick: (record clone,
        # owners, kind)
        self._pending: List[Tuple[torch.Tensor, Tuple, str]] = []
        self._finished: List[Request] = []    # synced but not yet returned
        self._uid = 0
        self.decode_calls = 0                 # ticks == decode_step calls
        self.prefill_calls = 0                # batched prefill invocations
        # resilience knobs and counters
        self.queue_limit = queue_limit
        self.shed_policy = shed_policy
        self.default_deadline = default_deadline
        self.preempt_after = preempt_after
        self.max_ticks = max_ticks
        self.degrade = degrade
        self._failed_ticks: set = set()       # one-shot fail_ticks consumed
        self.shed_count = 0                   # requests refused or evicted
        self.deadline_miss_count = 0          # requests expired past deadline
        self.preempt_count = 0                # slot evictions (requeued)
        self.poisoned_count = 0               # slots quarantined (non-finite)
        self.fallback_events: List[Tuple[int, str]] = []  # (tick, step)
        self.queue_peak = 0                   # high-water queue depth
        # durability: snapshots, the write-ahead journal
        # (serving.durability), the weight-integrity probe and self-heal
        # (checkpoint.integrity)
        self.snapshot_dir = snapshot_dir
        self.snapshot_every = snapshot_every
        self.integrity_every = integrity_every
        self.golden_dir = golden_dir
        self.snapshots_written = 0            # snapshot() completions
        self.journal_events = 0               # events appended to the journal
        self.replayed_events = 0              # journal events replayed in
        self.integrity_probes = 0             # canary passes run
        self.heal_count = 0                   # leaves reloaded from golden
        self._last_snapshot_tick = -1         # don't re-snapshot a tick
        self._crashed_ticks: set = set()      # one-shot crash_at_tick consumed
        self._flipped_ticks: set = set()      # one-shot flip_bits consumed
        if journal is not None and not hasattr(journal, "append"):
            from repro_torch.serving.durability import Journal
            journal = Journal(journal)
        self._journal = journal
        self._probe_paths: Optional[List[str]] = None
        if integrity_every is not None:
            self._init_integrity()
        self._bucket_cap = self.mod.cache_len_for(cfg, max_len)

    def _new_rec(self) -> torch.Tensor:
        """The record buffer, (slots, w + 4) int32 with w = spec_k + 1:
        tokens right-padded to w, counts, done, accepted drafts, non-finite
        flag. Its width changes with spec_k (the ladder's spec -> plain);
        each pending record is read at the width it was written with."""
        return torch.zeros((self.slots, self.spec_k + 5), dtype=torch.int32,
                           device=self.device)

    @property
    def captures(self) -> Dict[str, Any]:
        """CUDA graphs captured: ``{"tick": n, "admit": {bucket: n}}`` (and
        ``"probe": n`` with the integrity probe on) — one tick, one graph
        per admission bucket, again after each ladder step; zeros when the
        engine runs eagerly."""
        c = self.graphs.captures
        out = {"tick": c.get("tick", 0),
               "admit": {k[1]: v for k, v in sorted(
                   (k, v) for k, v in c.items() if isinstance(k, tuple))}}
        if self._probe_paths is not None:
            out["probe"] = c.get("probe", 0)
        return out

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
        lens = self._in_lens
        logits0, src = self._prefill(toks, lens)
        dsrc = None
        if self.spec_k:
            # the drafter needs the prompt in ITS cache too (its logits are
            # unused: the target samples every committed token)
            _, dsrc = self.dmod.prefill(
                self.draft_params, {"tokens": toks}, self.draft_cfg,
                policy=self.policy, dtype=self.dtype, max_len=self.max_len,
                lengths=lens, attn_chunk=self.attn_chunk,
                **self._kw["prefill"])
        self._admit_many(logits0, src, dsrc)

    def _admit_many(self, logits0: torch.Tensor, src, dsrc=None):
        """The reference's ``admit_many``: insert prefilled rows ``src`` (and
        the drafter's ``dsrc``) into slots ``_in_map`` with one multi-slot
        scatter each, then seat them on their first tokens."""
        slot_map = self._in_map
        self.mod.insert_prefill_many(self.cache, slot_map, src)
        if dsrc is not None:
            self.dmod.insert_prefill_many(self.draft_cache, slot_map, dsrc)
        self._seat(logits0, slot_map, self._in_budget)

    def _seat(self, logits0: torch.Tensor, slot_map: torch.Tensor,
              bud: torch.Tensor):
        """Sample each admitted row's first token from its prefill logits
        ``logits0`` and start slot ``slot_map[i]`` on it with budget
        ``bud[i]``; rows whose slot is ``>= slots`` are dropped on the
        device."""
        t0 = _sample(self._gen, logits0[:, 0], self.temperature).to(torch.int32)
        # the prefill sample already counts: a max_new == 1 request (or an
        # immediate EOS) never becomes active
        act0 = (bud > 1) & (t0 != self._eos())
        index_drop_(self._tokens, slot_map, t0[:, None])
        index_drop_(self._active, slot_map, act0)
        index_drop_(self._emitted, slot_map, torch.ones_like(t0))
        index_drop_(self._budget, slot_map, bud)
        admitted = index_drop_(torch.zeros_like(self._active), slot_map, True)
        self._record(self._tokens, admitted, admitted & ~self._active)

    def _probe_work(self):
        """One canary pass over the protected weight leaves into the fixed
        ``_probe_out`` (a graph of its own on the card)."""
        self._probe_out.copy_(self._probe_fn(self.params))

    # --- the graphs, described for the contract linter -----------------------

    def contract_points(self, bucket: Optional[int] = None
                        ) -> List[Dict[str, Any]]:
        """The engine's graph bodies, described for ``repro_torch.analysis``
        (the reference's ``contract_points``). Build the engine on fake
        tensors (``capture=False``) and call this under the same
        ``FakeTensorMode``: the admission point's inputs come from one
        abstract prefill, and nothing executes.

        Each point: ``name``; ``fn``, a call with no arguments (the bodies
        read and write the engine's fixed tensors); ``inputs``, the tensors
        it reads; ``carry``, getters of the tensors that must leave it with
        their shape, dtype and storage (the carry pass); ``donate``, the
        names among them the reference donates (written in place here);
        ``score_dims``, the (T, S) a quadratic score tensor would trail
        with, or None. ``bucket`` is the admission bucket to describe
        prefill at (default: the largest)."""
        bucket = bucket or self._bucket_cap
        toks = torch.zeros((self.slots, bucket), dtype=torch.int32,
                           device=self.device)
        state = {"cache": lambda: self.cache, "tokens": lambda: self._tokens,
                 "active": lambda: self._active,
                 "emitted": lambda: self._emitted}
        inputs = {"params": self.params, "cache": self.cache,
                  "tokens": self._tokens, "active": self._active,
                  "emitted": self._emitted, "budget": self._budget,
                  "poison": self._poison, "record": self._rec}
        points: List[Dict[str, Any]] = []
        if self.spec_k:
            points.append(dict(
                name="spec_tick", fn=self._spec_tick,
                inputs=dict(inputs, draft_params=self.draft_params,
                            draft_cache=self.draft_cache),
                carry=dict(state, draft_cache=lambda: self.draft_cache),
                donate=("cache", "draft_cache"),
                score_dims=(self.spec_k + 1, self._bucket_cap)))
        else:
            points.append(dict(name="decode_tick", fn=self._tick,
                               inputs=inputs, carry=state, donate=("cache",),
                               score_dims=None))
        lens = self._in_lens
        points.append(dict(
            name="prefill_bucketed", fn=lambda: self._prefill(toks, lens),
            inputs={"params": self.params, "tokens": toks, "lengths": lens},
            carry={}, donate=(), score_dims=(bucket, bucket)))
        logits0, src = self._prefill(toks, lens)
        points.append(dict(
            name="admit_many", fn=lambda: self._admit_many(logits0, src),
            inputs=dict(inputs, src=src, logits0=logits0,
                        slot_map=self._in_map),
            carry=dict(state, budget=lambda: self._budget),
            donate=("cache",), score_dims=None))
        return points

    # --- degradation ladder (called through resilience.degrade_step) -------

    def _disable_spec(self):
        """Ladder step 1, spec -> plain: abandon the drafter and its cache
        and drop the graphs; the next tick captures the plain tick. The
        target stream is unaffected (spec is exact): ``_tokens`` holds the
        last committed, not yet fed token in both modes. ``_ticks_left``
        stays an upper bound, and ``_was_spec`` keeps ``_spin_up`` syncing
        so early finishes still free slots. Records still pending keep the
        width they were written with."""
        self.spec_k = 0
        self._was_spec = True
        self.draft_cache = None
        self._rec = self._new_rec()
        self.graphs.reset()

    def _fallback_modes(self):
        """Ladder step 2, kernels -> plain versions: every quantized matmul
        through the dequant path, every attention through the reference
        path — the oracles the kernels are held against."""
        self._set_modes("dequant", "ref")

    def _set_modes(self, matmul_mode: str, attn_mode: str):
        """Serve with these modes from now on: the graphs captured with the
        old ones are dropped."""
        self._kw = _serve_kwargs(self.cfg, matmul_mode, attn_mode,
                                 self.kv_bits)
        self.matmul_mode, self.attn_mode = matmul_mode, attn_mode
        self.graphs.reset()

    # --- durability: snapshots, write-ahead journal, weight integrity -------

    def _log_event(self, event: Dict[str, Any]):
        """Append one event to the write-ahead journal (no-op without
        one). Every event carries the current tick."""
        if self._journal is not None:
            self._journal.append(dict(event, tick=self.decode_calls))
            self.journal_events += 1

    def snapshot(self, snapshot_dir: Optional[str] = None) -> str:
        """Persist the complete engine state (device tensors and host
        bookkeeping) as an atomic restore point; see
        ``serving.durability``."""
        from repro_torch.serving import durability
        d = snapshot_dir or self.snapshot_dir
        if d is None:
            raise ValueError("no snapshot_dir: pass one here or at "
                             "construction")
        return durability.snapshot_engine(self, d)

    def restore(self, snapshot_dir: Optional[str] = None,
                step: Optional[int] = None) -> Dict[str, Any]:
        """Load a snapshot into this engine, written in place into the
        tensors its graphs read, and resume where it was taken —
        token-identical at T = 0, the same stream at T > 0."""
        from repro_torch.serving import durability
        d = snapshot_dir or self.snapshot_dir
        if d is None:
            raise ValueError("no snapshot_dir: pass one here or at "
                             "construction")
        return durability.restore_engine(self, d, step)

    def recover(self, snapshot_dir: Optional[str] = None,
                journal: Optional[str] = None) -> Dict[str, Any]:
        """Crash recovery: the latest snapshot (if any) plus the journal
        tail. Defaults to the construction-time snapshot dir and journal."""
        from repro_torch.serving import durability
        jpath = journal or (self._journal.path if self._journal is not None
                            else None)
        return durability.recover(
            self, snapshot_dir=snapshot_dir or self.snapshot_dir,
            journal=jpath)

    def _init_integrity(self):
        """The weight-integrity machinery: the protected paths (``qp`` /
        ``q`` / ``delta`` of a serve form, every leaf of a float master),
        the canary probe and its fixed output, the golden fingerprints, a
        host golden copy and CRC manifest to heal from; ``golden_dir`` also
        persists the golden store (``checkpoint.integrity.save_golden``)."""
        from repro_torch.checkpoint import integrity
        paths = integrity.protected_paths(self.params)
        self._probe_paths, self._probe_fn = integrity.make_probe(self.params,
                                                                 paths)
        self._probe_out = torch.zeros((len(paths),), dtype=torch.int64,
                                      device=self.device)
        self._golden = {p: tree_get(self.params, p).detach().to(
            "cpu", copy=True) for p in paths}
        # the manifest from the host copy: one device-to-host pass
        self._manifest = integrity.build_manifest(unflatten(self._golden),
                                                  paths)
        self._golden_fp = self._run_probe()
        if self.golden_dir is not None:
            integrity.save_golden(self.golden_dir, self.params, paths)
        self._next_probe = 0

    @torch.no_grad()
    def _run_probe(self) -> np.ndarray:
        """The (P,) fingerprints of the resident store, on the host."""
        self.graphs.run("probe", self._probe_work)
        return self._probe_out.cpu().numpy().copy()

    def _flip_bit(self, path: str, bit: int):
        """Fault injection: one bit of the params leaf at ``path`` flipped
        in place (``checkpoint.integrity.flip_bit_``) — a soft error in the
        resident store that the captured tick then reads."""
        from repro_torch.checkpoint import integrity
        integrity.flip_bit_(self.params, path, bit)

    def _integrity_probe(self):
        """One canary pass: fingerprints against golden. A mismatch names
        the corrupt leaves and triggers the self-heal."""
        self.integrity_probes += 1
        fps = self._run_probe()
        bad = [self._probe_paths[i]
               for i in np.nonzero(fps != self._golden_fp)[0]]
        if bad:
            self._heal(bad)

    def _heal(self, bad_paths: List[str]):
        """Reload each corrupt leaf from the golden copy, in place, confirm
        the probe matches golden again, then REWIND every request whose
        tokens could have been computed against the corrupt store: resident
        unfinished requests and ok-finished but undrained ones go back to
        their prompt and are requeued through normal admission. Requests
        drained between the last clean probe and detection are the
        caller-visible at-risk window."""
        self._sync()
        for p in bad_paths:
            tree_write_(self.params, p, self._golden[p])
            self.heal_count += 1
            self.fallback_events.append((self.decode_calls, f"heal:{p}"))
        if not np.array_equal(self._run_probe(), self._golden_fp):
            raise RuntimeError(
                f"integrity heal failed: {bad_paths} still mismatch the "
                f"golden fingerprints after reload — golden copy corrupt?")
        self._log_event({"e": "heal", "paths": list(bad_paths)})
        victims = [s for s in range(self.slots)
                   if (r := self._slot_req[s]) is not None and not r.done]
        resurrect = [r for r in self._finished if r.status == "ok"]
        self._finished = [r for r in self._finished if r.status != "ok"]
        requeue = [self._slot_req[s] for s in victims] + resurrect
        for s in victims:
            self._release_slot(s)
        for r in sorted(requeue, key=lambda r: r.uid):
            r.out.clear()
            r.done = False
            r.status = "ok"
            r.ticks = 0
            r.accept_hist = {}
            r.finish_time = 0.0
            self.queue.append(r)
        if victims:
            self._deactivate(victims)
            self._free_rows(victims)

    # --- public API ---------------------------------------------------------

    def submit(self, prompt: List[int], max_new: int = 16,
               deadline_ticks: Optional[int] = None) -> SubmitOutcome:
        """Enqueue a request. Malformed requests raise ``SubmitRejected``
        with a machine-readable ``reason``; well-formed ones return a
        ``SubmitOutcome``: the uid when accepted, falsy with
        ``reason='queue_full'`` when bounded admission sheds it.
        ``deadline_ticks`` (or ``default_deadline``) sets the absolute
        expiry ``decode_calls + deadline_ticks``."""
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
        if deadline_ticks is not None and deadline_ticks < 1:
            raise SubmitRejected(
                "bad_deadline",
                f"deadline_ticks must be >= 1, got {deadline_ticks}")
        shed: Tuple[int, ...] = ()
        if self.queue_limit is not None and len(self.queue) >= self.queue_limit:
            self.shed_count += 1
            if self.shed_policy == "reject":
                self._log_event({"e": "shed", "uid": None,
                                 "reason": "queue_full"})
                return SubmitOutcome(0, accepted=False, reason="queue_full")
            victim = self.queue.pop(0)               # drop_oldest
            self._log_event({"e": "shed", "uid": victim.uid,
                             "reason": "queue_full"})
            self._finish(victim, "shed")
            shed = (victim.uid,)
        self._uid += 1
        dl = deadline_ticks if deadline_ticks is not None \
            else self.default_deadline
        req = Request(self._uid, list(prompt), max_new,
                      deadline_at=(self.decode_calls + dl) if dl else None,
                      submit_time=time.perf_counter())
        # write-ahead: the acceptance is durable before the queue sees it
        self._log_event({"e": "submit", "uid": req.uid, "prompt": req.prompt,
                         "max_new": max_new, "deadline_at": req.deadline_at})
        self.queue.append(req)
        self.queue_peak = max(self.queue_peak, len(self.queue))
        return SubmitOutcome(self._uid, accepted=True, shed=shed)

    @property
    def queue_depth(self) -> int:
        return len(self.queue)

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
        prefill + ONE multi-slot insert. When the queue has waiters and no
        slot is free, ``preempt_after`` lets a slot held that many ticks be
        preempted (its request requeued at the back, re-entering here with
        its committed tokens folded into the prompt)."""
        fp = self.fault_plan
        if fp is not None and fp.delays_admission_at(self.decode_calls):
            return                            # injected admission stall
        if not self.queue:
            return
        free = self._free_slots()
        if not free and (self.eos_id is not None or self.spec_k
                         or self._was_spec):
            # an EOS — or, with speculation, a multi-token burst through
            # the budget — may have freed a slot we haven't observed yet
            self._sync()
            free = self._free_slots()
        if not free and self.preempt_after is not None:
            victims = [s for s in range(self.slots)
                       if self._slot_req[s] is not None
                       and self._slot_ticks[s] >= self.preempt_after]
            if victims:
                # never preempt more slots than there are waiters
                self._preempt(victims[:len(self.queue)])
                free = self._free_slots()
        while self.queue and free:
            if len(self.queue[0].admit_prompt) > self._bucket_cap:
                # past a sliding-window ring a padded row's ring alignment
                # is undefined: this prompt takes the exact solo path
                self._admit_solo(free.pop(0), self.queue.pop(0))
                continue
            bucket = self._bucket_len(len(self.queue[0].admit_prompt))
            batch: List[Request] = []
            rest: List[Request] = []
            for r in self.queue:
                if (len(batch) < len(free)
                        and len(r.admit_prompt) <= self._bucket_cap
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
        self._record_admitted(slot_ids, reqs)

    def _admit_solo(self, slot: int, req: Request):
        """Exact-length single-request admission of a prompt longer than the
        bucket cap (past a sliding-window ring): one eager prefill of its
        own length, inserted into ``slot``; the first token is sampled as
        in a bucketed round. The tick stays captured. A speculative engine
        never gets here: ``_no_ring_wrap`` keeps its cache at ``max_len``,
        which no admitted prompt exceeds."""
        assert not self.spec_k
        toks = torch.tensor([req.admit_prompt], dtype=torch.int32)
        logits0, src = self._prefill(toks.to(self.device), None)
        self.mod.insert_prefill(self.cache, slot, src)
        self._seat(logits0, torch.tensor([slot]).to(self.device),
                   torch.tensor([req.remaining], dtype=torch.int32).to(
                       self.device))
        self._record_admitted([slot], [req])

    def _record_admitted(self, slot_ids: List[int], reqs: List[Request]):
        """Bookkeeping after an admission (batched or solo): the round is
        counted and logged, the slots owned, the record kept, and slots
        whose lifetime is already over released."""
        self.prefill_calls += 1
        self._log_event({"e": "admit", "uids": [r.uid for r in reqs],
                         "slots": list(slot_ids)})
        for s, r in zip(slot_ids, reqs):
            self._slot_req[s] = r
            self._ticks_left[s] = r.remaining - 1
            self._slot_ticks[s] = 0
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
        """Durability hooks, deadlines, admission, then ONE tick for every
        active slot; a failed tick walks the degradation ladder (spec ->
        plain, kernels -> plain versions) before the failure propagates.
        Asynchronous: emitted tokens stay on the device until ``drain()``.

        An injected ``crash_at_tick`` raises ``InjectedCrash`` first (a
        killed process does nothing else); injected ``flip_bits`` then
        corrupt the resident weights in place, the integrity probe gets its
        chance to detect and heal, and a completed tick lands a periodic
        snapshot (``snapshot_every``)."""
        fp = self.fault_plan
        tick = self.decode_calls
        if (fp is not None and fp.crashes_at(tick)
                and tick not in self._crashed_ticks):
            self._crashed_ticks.add(tick)
            raise resilience.InjectedCrash(
                f"injected process kill at decode tick {tick}")
        if fp is not None and tick not in self._flipped_ticks:
            flips = fp.flips_at(tick)
            if flips:
                self._flipped_ticks.add(tick)
                for path, bit in flips:
                    self._flip_bit(path, bit)
        if self._probe_paths is not None and tick >= self._next_probe:
            self._next_probe = tick + self.integrity_every
            self._integrity_probe()
        self._expire_deadlines()
        self._spin_up()
        if not self._occupied():
            return
        owners = tuple(self._slot_req)
        self._load_poison()
        self._dispatch_tick()
        self._pending.append((self._rec.clone(), owners, "tick"))
        self.decode_calls += 1
        for s in range(self.slots):
            if self._slot_req[s] is not None:
                self._slot_ticks[s] += 1
                # with speculation an upper bound: a tick emits >= 1 token
                self._ticks_left[s] -= 1
                if self._ticks_left[s] <= 0:
                    self._release_slot(s)    # budget exhausted this tick
        if (self.snapshot_dir is not None and self.snapshot_every is not None
                and self.decode_calls % self.snapshot_every == 0
                and self.decode_calls != self._last_snapshot_tick):
            self.snapshot()

    def _call_tick(self):
        """One tick on the CURRENT graph (spec or plain). The fault plan's
        injected failure is raised in place of the call, before it touches
        a fixed buffer; each fires once."""
        fp = self.fault_plan
        if (fp is not None and fp.fails_at(self.decode_calls)
                and self.decode_calls not in self._failed_ticks):
            self._failed_ticks.add(self.decode_calls)
            raise resilience.InjectedFault(
                f"injected tick failure at decode tick {self.decode_calls}")
        self.graphs.run("tick", self._spec_tick if self.spec_k else self._tick,
                        idle=self._tick_idle)

    @contextlib.contextmanager
    def _tick_idle(self):
        """The context of the tick's warm-ups: every slot inactive, so
        they change no slot's tokens or length. A recurrent state (ssm,
        hybrid) advances for inactive rows too, as in the reference (a
        plain tick's K/V write at a held position is rewritten by the next
        tick, a folded state is not), so it is kept and put back."""
        state = [v for p, v in flatten_with_path(self.cache).items()
                 if p.split("/", 1)[0] in _RECURRENT]
        with masked(self._active, False), kept(*state):
            yield

    def _dispatch_tick(self):
        """Run one tick, walking the degradation ladder on failure, as the
        reference does: each retry first applies
        ``resilience.degrade_step``; with the ladder exhausted an injected
        (transient) fault earns a same-graph retry, and anything else
        propagates. Every step is appended to ``fallback_events`` and
        logged, a real failure with its traceback. On a CUDA device only
        an injected fault walks the ladder; any other failure raises at
        once, so a kernel that fails to build or launch is never hidden
        behind its plain version (the reference catches every
        exception)."""
        attempts = 0
        while True:
            try:
                self._call_tick()
                return
            except Exception as e:
                injected = isinstance(e, resilience.InjectedFault)
                if not injected and self.device.type == "cuda":
                    # on the card only an injected fault walks the ladder: a
                    # kernel that fails raises, never served by a plain version
                    raise
                attempts += 1
                label = resilience.degrade_step(self) if self.degrade \
                    else None
                if label is None and attempts < 3 and injected:
                    label = "retry"
                if label is None or attempts >= 4:
                    raise
                self.fallback_events.append((self.decode_calls, label))
                # an injected fault is expected: its message is enough
                _log.warning("tick %d failed (%s); degradation ladder: %s",
                             self.decode_calls, e, label,
                             exc_info=None if injected else e)

    # --- slot release and resilience helpers --------------------------------

    def _finish(self, req: Request, status: str):
        """Terminal bookkeeping shared by every way a request ends."""
        req.status = status
        req.done = True
        req.finish_time = time.perf_counter()
        self._log_event({"e": "finish", "uid": req.uid, "status": status,
                         "n_out": len(req.out)})
        self._finished.append(req)

    def _release_slot(self, s: int):
        self._slot_req[s] = None
        self._ticks_left[s] = 0
        self._slot_ticks[s] = 0

    def _load_free_idx(self, slot_list: List[int]):
        """``_free_idx`` := ``slot_list`` padded with ``slots`` (dropped):
        one fixed-length index, whatever the number of slots released."""
        idx = np.full((self.slots,), self.slots, np.int64)
        idx[:len(slot_list)] = slot_list
        self._free_idx.copy_(torch.from_numpy(idx))

    def _deactivate(self, slot_list: List[int]):
        """Deactivate rows outside the tick, in place on the device."""
        self._load_free_idx(slot_list)
        index_drop_(self._active, self._free_idx, False)

    def _free_rows(self, slot_list: List[int]):
        """Zero the cache rows of released slots (and the drafter's), in
        place, so stale or NaN state never reaches the slot's next tenant."""
        self._load_free_idx(slot_list)
        self.mod.free_slots(self.cache, self._free_idx)
        if self.spec_k:
            self.dmod.free_slots(self.draft_cache, self._free_idx)

    def _preempt(self, victims: List[int]):
        """Preempt ``victims``: sync so every committed token is attributed,
        requeue each request at the BACK of the queue (waiters at the front
        get the freed slots), and deactivate and zero the rows. The request
        re-enters through bucketed admission with its committed tokens
        folded into the prompt — token-identical at T = 0 in fp32 without
        activation quantization."""
        self._sync()
        live: List[int] = []
        for s in victims:
            req = self._slot_req[s]
            if req is None or req.done:       # sync finished it already
                continue
            live.append(s)
            req.preemptions += 1
            self.preempt_count += 1
            self._release_slot(s)
            self.queue.append(req)
        if live:
            self._deactivate(live)
            self._free_rows(live)

    def _expire_deadlines(self):
        """Cancel every request past its deadline: queued ones before they
        ever hold a slot; resident ones after a sync (their partial output
        is attributed and returned), mid-stream — row deactivated and
        zeroed."""
        now = self.decode_calls
        q_exp = [r for r in self.queue
                 if r.deadline_at is not None and now >= r.deadline_at]
        s_exp = [s for s in range(self.slots)
                 if (r := self._slot_req[s]) is not None
                 and r.deadline_at is not None and now >= r.deadline_at]
        if not q_exp and not s_exp:
            return
        self._sync()          # attribute partial output before cancelling
        for r in q_exp:
            self.queue.remove(r)
            self.deadline_miss_count += 1
            self._finish(r, "deadline")
        cancelled: List[int] = []
        for s in s_exp:
            r = self._slot_req[s]
            if r is None or r.done:           # sync finished or freed it
                continue
            cancelled.append(s)
            self.deadline_miss_count += 1
            self._finish(r, "deadline")
            self._release_slot(s)
        if cancelled:
            self._deactivate(cancelled)
            self._free_rows(cancelled)

    def _diagnostics(self) -> Dict[str, Any]:
        """The watchdog's dump: what is queued, who holds which slot and
        for how much longer, and every resilience counter."""
        return {
            "queue_depth": len(self.queue),
            "queued_uids": [r.uid for r in self.queue],
            "active_slots": [s for s in range(self.slots)
                             if self._slot_req[s] is not None],
            "slots": [{"slot": s, "uid": r.uid,
                       "ticks_left": self._ticks_left[s],
                       "held_ticks": self._slot_ticks[s]}
                      for s in range(self.slots)
                      if (r := self._slot_req[s]) is not None],
            "decode_calls": self.decode_calls,
            "prefill_calls": self.prefill_calls,
            "shed_count": self.shed_count,
            "deadline_miss_count": self.deadline_miss_count,
            "preempt_count": self.preempt_count,
            "poisoned_count": self.poisoned_count,
            "fallback_events": list(self.fallback_events),
            "snapshots_written": self.snapshots_written,
            "journal_events": self.journal_events,
            "replayed_events": self.replayed_events,
            "integrity_probes": self.integrity_probes,
            "heal_count": self.heal_count,
        }

    def _sync(self):
        """Bulk-sync everything recorded since the last sync (ONE device to
        host copy) and attribute tokens to requests via the per-record owner
        snapshots; a record carries 1..w tokens per slot, w its own width
        (records written before a spec -> plain step are wider). Per-request
        ``ticks`` / ``accept_hist`` and the engine's ``spec_drafted`` /
        ``spec_accepted`` are folded in here, and a ``commit`` journal event
        per request. A row flagged non-finite contributes no token; its
        request finishes ``"poisoned"``, and a slot it still holds is
        released with its cache rows zeroed. Finished requests wait in
        ``_finished`` for ``drain()``."""
        if not self._pending:
            return
        flat = torch.cat([rec.reshape(-1) for rec, _, _ in self._pending])
        flat = flat.cpu().numpy()
        quarantined: List[int] = []
        committed: Dict[int, int] = {}        # uid -> tokens attributed now
        at = 0
        for rec_t, owners, kind in self._pending:
            rec = flat[at:at + rec_t.numel()].reshape(rec_t.shape)
            at += rec_t.numel()
            w = rec.shape[1] - 4
            toks, counts, dn = rec[:, :w], rec[:, w], rec[:, w + 1]
            bad = rec[:, w + 3]
            for s in np.nonzero(counts)[0]:
                req = owners[s]
                if req is not None and not bad[s]:
                    n = int(counts[s])
                    req.out.extend(int(x) for x in toks[s, :n])
                    committed[req.uid] = committed.get(req.uid, 0) + n
                    if kind == "tick":
                        req.ticks += 1
                        req.accept_hist[n] = req.accept_hist.get(n, 0) + 1
            if kind == "tick" and w > 1:              # a speculative tick
                live = counts > 0
                self.spec_drafted += int((w - 1) * live.sum())
                self.spec_accepted += int(rec[live, w + 2].sum())
            for s in np.nonzero(dn)[0]:
                req = owners[s]
                if req is not None and not req.done:
                    self._finish(req, "ok")
                    if self._slot_req[s] is req:   # early EOS: free the slot
                        self._release_slot(s)
            for s in np.nonzero(bad)[0]:
                req = owners[s]
                if req is not None and not req.done:
                    self.poisoned_count += 1
                    self._finish(req, "poisoned")
                    if self._slot_req[s] is req:
                        self._release_slot(s)
                        quarantined.append(s)
        self._pending.clear()
        if self._journal is not None:
            for uid in sorted(committed):
                self._log_event({"e": "commit", "uid": uid,
                                 "n": committed[uid]})
        if quarantined:
            # the tick already deactivated the rows; zeroing them keeps the
            # contaminated state from the slot's next tenant
            self._free_rows(sorted(set(quarantined)))

    def drain(self) -> List[Request]:
        """Sync pending emissions and return every request that finished
        since the last ``drain()`` call."""
        self._sync()
        out, self._finished = self._finished, []
        return out

    def run_all(self, max_ticks: Optional[int] = None) -> List[Request]:
        """Drive until queue and slots are empty; drains every
        ``drain_every`` ticks. ``max_ticks`` (default: the engine's; None =
        no watchdog) bounds the number of ``step()`` calls: a wedged engine
        raises ``WatchdogExpired`` with a diagnostic dump instead of
        spinning forever. Requests already finished stay drainable after
        the raise."""
        if max_ticks is None:
            max_ticks = self.max_ticks
        done: List[Request] = []
        iters = 0
        while self.queue or self._occupied():
            if max_ticks is not None and iters >= max_ticks:
                self._sync()
                # hand the already-finished work back through drain()
                self._finished = done + self._finished
                diag = self._diagnostics()
                raise WatchdogExpired(
                    f"run_all exceeded max_ticks={max_ticks} with work "
                    f"still pending: queue depth {diag['queue_depth']}, "
                    f"active slots {diag['active_slots']}, per-slot state "
                    f"{diag['slots']}", diag)
            self.step()
            iters += 1
            if self.decode_calls % self.drain_every == 0:
                done.extend(self.drain())
        done.extend(self.drain())
        return done
