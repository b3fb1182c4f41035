"""The train step and the Trainer loop — port of the reference's
``training/loop.py``.

``make_train_step`` returns ``(train_step, init_state)``;
``train_step(state, batch) -> (state, metrics)`` implements:

  * the forward under the active QuantPolicy (float / fake W3A8 with deltas
    refitted each step / frozen ``state["deltas"]``), bf16 compute over
    fp32 masters by default;
  * the MoE aux loss mixed in at ``AUX_WEIGHT``;
  * microbatched gradient accumulation into fp32 gradients (a loop inside
    the step in place of the reference's ``lax.scan``: memory scales with
    one microbatch);
  * ``grad_transform``, global-norm clipping, the LR schedule and the
    optimizer update.

The reference's jit boundary is a CUDA graph here, under the port's graph
rule (``core/graphs.py``): on a CUDA device the step is captured once per
batch shape and replayed for every batch. The parameters, gradients,
optimizer state, step counter, deltas, batch and metrics are fixed tensors
updated in place: the state handed to the first call becomes the step's
own (the counterpart of the reference's donated state) and is returned by
every call; a call with another state dict of the same structure copies it
into those tensors first (a restore). Each batch is copied into the step's
input tensors on the compute stream before the replay. The graph's warm-ups
run inside ``kept`` of every tensor the step writes, so they leave the
state as it was. ``capture=False`` is the eager twin, and a CPU run is
always eager. The lr is a device tensor computed from the device step
counter inside the step, so every replay trains at its own step's lr.

``Trainer`` adds the systems side: a wall time per step, logging, async
checkpoints every ``ckpt_every`` steps (``Checkpointer.save_async`` copies
the state to the host before it returns, so the next step's in-place
update cannot race the write) and a straggler monitor (per-step wall-time
EMA; steps slower than ``straggler_factor`` x EMA are counted).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import optim as optim_lib
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.graphs import Graphs, kept
from repro_torch.core.precision import QuantPolicy
from repro_torch.core.treeutil import flatten_with_path, unflatten
from repro_torch.distributed import shards
from repro_torch.models.api import get_model
from repro_torch.training.losses import IGNORE, accuracy, softmax_xent

__all__ = ["TrainState", "make_loss_fn", "make_train_step",
           "StragglerMonitor", "Trainer", "AUX_WEIGHT"]

AUX_WEIGHT = 0.01
METRICS = ("loss", "aux", "acc", "gnorm", "lr")


def _device_of(tree) -> torch.device:
    return next(iter(flatten_with_path(tree).values())).device


def TrainState(params, opt_state, step=0, extra=None) -> Dict[str, Any]:
    st = {"params": params, "opt": opt_state,
          "step": torch.full((), step, dtype=torch.int32,
                             device=_device_of(params))}
    if extra:
        st.update(extra)
    return st


def make_loss_fn(cfg: ModelConfig, policy: QuantPolicy,
                 dtype=torch.bfloat16, remat: str = "layer",
                 model_kwargs: Optional[Dict] = None):
    """``loss_fn(params, batch, deltas=None) -> (loss + AUX_WEIGHT * aux,
    {"loss", "aux", "acc"})``; ``deltas`` None refits the policy's step
    sizes from the weights; with a frontend the labels are padded with
    IGNORE over its prefix. ``model_kwargs`` go to the model's
    ``forward`` (``attn_chunk``, an SSD ``chunk``)."""
    mod = get_model(cfg)
    mkw = dict(model_kwargs or {})

    def loss_fn(params, batch, deltas=None):
        logits, aux = mod.forward(params, batch, cfg, policy=policy,
                                  deltas=deltas, dtype=dtype, remat=remat,
                                  **mkw)
        # a vocab-sharded DTensor is gathered: DTensor's gather of the
        # label logits (a masked partial) fails on the indexing after it
        logits = shards.replicate_dims(logits, [-1], "loss over the vocab")
        labels = batch["labels"]
        if cfg.frontend is not None:
            pad = torch.full(tuple(labels.shape[:1]) + (cfg.frontend_tokens,),
                             IGNORE, dtype=labels.dtype, device=labels.device)
            labels = torch.cat([pad, labels], dim=1)
        loss = softmax_xent(logits, labels)
        metrics = {"loss": loss, "aux": aux, "acc": accuracy(logits, labels)}
        return loss + AUX_WEIGHT * aux, metrics

    return loss_fn


class _TrainStep:
    """The step's fixed tensors and its graphs; see the module docstring."""

    def __init__(self, loss_fn, opt, sched, tcfg: TrainConfig,
                 grad_transform: Optional[Callable], capture: Optional[bool]):
        self.loss_fn, self.opt, self.sched = loss_fn, opt, sched
        self.tcfg, self.grad_transform = tcfg, grad_transform
        self.capture = capture
        self.state: Optional[Dict[str, Any]] = None
        self.graphs: Optional[Graphs] = None
        self._inputs: Dict[Any, Dict[str, torch.Tensor]] = {}

    @property
    def captures(self) -> Dict:
        return {} if self.graphs is None else dict(self.graphs.captures)

    def _bind(self, state):
        self.state = state
        self.device = _device_of(state["params"])
        self.graphs = Graphs(self.device, capture=self.capture)
        self._params = flatten_with_path(state["params"])
        self.grads = {p: torch.zeros_like(t, dtype=torch.float32)
                      for p, t in self._params.items()}
        self.metrics = {k: torch.zeros((), dtype=torch.float32,
                                       device=self.device) for k in METRICS}
        # what a step writes, and so what its graph's warm-ups must keep:
        # every leaf but the frozen deltas (params, optimizer state, step,
        # a grad_transform's state such as the compressor's "ef")
        self._written = [t for p, t in flatten_with_path(state).items()
                         if not p.startswith("deltas/")]

    def _load(self, state):
        """Copy ``state`` (a restore) into the step's own tensors."""
        mine, theirs = flatten_with_path(self.state), flatten_with_path(state)
        if sorted(mine) != sorted(theirs):
            raise ValueError(f"train state structure differs from the one "
                             f"this step holds: {sorted(theirs)} vs "
                             f"{sorted(mine)}")
        with torch.no_grad():
            for path, t in mine.items():
                t.copy_(theirs[path])

    def _stage(self, batch):
        """(the batch's key: its leaves' names, shapes and dtypes; the fixed
        input tensors of that key with the batch copied in, on the compute
        stream)."""
        key = ("step",) + tuple((k, tuple(v.shape), v.dtype) for k, v in
                                sorted(batch.items()))
        if key not in self._inputs:
            # empty_like keeps a DTensor batch's mesh and placements
            self._inputs[key] = {k: torch.empty_like(v, device=self.device)
                                 for k, v in batch.items()}
        bufs = self._inputs[key]
        for k, v in batch.items():
            bufs[k].copy_(v, non_blocking=True)
        return key, bufs

    @contextlib.contextmanager
    def _idle(self):
        """The warm-ups' context: the state comes back after them, and on
        the card their memory is given back before the capture allocates
        the graph's own."""
        with kept(*self._written):
            yield
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _work(self, batch: Dict[str, torch.Tensor]):
        state, n = self.state, self.tcfg.microbatches
        dlt = state.get("deltas")
        rows = next(iter(batch.values())).shape[0] // n
        # the microbatches' sums: fp32 gradients and the loss metrics
        sums = list(self.grads.values()) + [self.metrics[k] for k in
                                            ("loss", "aux", "acc")]
        for i in range(n):
            mb = batch if n == 1 else {k: v[i * rows:(i + 1) * rows]
                                       for k, v in batch.items()}
            leaves = {p: t.detach().requires_grad_(True)
                      for p, t in self._params.items()}
            with torch.enable_grad():
                total, m = self.loss_fn(unflatten(leaves), mb, dlt)
                gs = torch.autograd.grad(total, list(leaves.values()),
                                         allow_unused=True,
                                         materialize_grads=True)
            # a sharded step's metrics are plain tensors: their whole values
            parts = list(gs) + [shards.whole(m[k]).detach().to(torch.float32)
                                for k in ("loss", "aux", "acc")]
            for acc, part in zip(sums, parts):
                if i == 0:
                    acc.copy_(part)
                else:
                    acc.add_(part)
        if n > 1:
            for acc in sums:
                acc.div_(n)
        g_tree = unflatten(dict(self.grads))
        if self.grad_transform is not None:
            g_tree, st = self.grad_transform(g_tree, state)
            if st is not state:
                self._load(st)
        gnorm = optim_lib.clip_by_global_norm_(g_tree, self.tcfg.grad_clip)
        lr = self.sched(state["step"])
        self.opt.update_(g_tree, state["opt"], state["params"], lr)
        state["step"].add_(1)
        self.metrics["gnorm"].copy_(shards.whole(gnorm))
        self.metrics["lr"].copy_(shards.whole(lr))

    def __call__(self, state, batch):
        if self.state is None:
            self._bind(state)
        elif state is not self.state:
            self._load(state)
        key, bufs = self._stage(batch)
        with torch.no_grad():
            self.graphs.run(key, lambda: self._work(bufs), idle=self._idle)
        return self.state, {k: v.clone() for k, v in self.metrics.items()}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, policy: QuantPolicy,
                    *, dtype=torch.bfloat16,
                    grad_transform: Optional[Callable] = None,
                    capture: Optional[bool] = None,
                    model_kwargs: Optional[Dict] = None):
    """Returns (train_step, init_state). ``init_state(params, extra=None)``
    builds the state around ``params`` (no copy: the step updates them in
    place); ``extra={"deltas": fit_deltas_stacked(...)}`` trains with
    frozen step sizes, which is the only way in for them: without
    ``state["deltas"]`` the policy's deltas are refitted each step.
    ``capture``: None captures on a CUDA device; False is the eager twin.
    ``grad_transform(grads, state) -> (grads, state)`` runs before
    clipping; any state it keeps must be written in place (a captured step
    reads fixed tensors). ``model_kwargs`` go to the model's forward."""
    opt = optim_lib.make(tcfg.optimizer, momentum=tcfg.momentum,
                         weight_decay=tcfg.weight_decay)
    sched = optim_lib.warmup_cosine(tcfg.learning_rate, tcfg.warmup_steps,
                                    tcfg.total_steps)
    loss_fn = make_loss_fn(cfg, policy, dtype, tcfg.remat, model_kwargs)

    def init_state(params, extra=None):
        return TrainState(params, opt.init(params), extra=extra)

    return _TrainStep(loss_fn, opt, sched, tcfg, grad_transform,
                      capture), init_state


@dataclasses.dataclass
class StragglerMonitor:
    """Wall-time EMA; counts steps slower than factor x EMA."""
    factor: float = 2.0
    ema: float = 0.0
    beta: float = 0.9
    slow_steps: int = 0
    total_steps: int = 0

    def record(self, dt: float) -> bool:
        self.total_steps += 1
        slow = self.ema > 0 and dt > self.factor * self.ema
        if slow:
            self.slow_steps += 1
            # don't pollute the EMA with the straggler itself
        else:
            self.ema = dt if self.ema == 0 else \
                self.beta * self.ema + (1 - self.beta) * dt
        return slow


class Trainer:
    """Drives train_step over a loader with checkpoint/restart."""

    def __init__(self, train_step, state, *, checkpointer=None,
                 ckpt_every: int = 0, log_every: int = 10,
                 straggler_factor: float = 2.0):
        self.train_step = train_step
        self.state = state
        self.checkpointer = checkpointer
        self.ckpt_every = ckpt_every
        self.log_every = log_every
        self.monitor = StragglerMonitor(factor=straggler_factor)
        self.history = []

    def run(self, loader, num_steps: int, *, on_log=None):
        it = iter(loader)
        try:
            for i in range(num_steps):
                batch = next(it)
                t0 = time.perf_counter()
                self.state, metrics = self.train_step(self.state, batch)
                if metrics["loss"].is_cuda:
                    torch.cuda.synchronize(metrics["loss"].device)
                dt = time.perf_counter() - t0
                self.monitor.record(dt)
                step = int(self.state["step"])
                if self.log_every and (i % self.log_every == 0
                                       or i == num_steps - 1):
                    row = {k: float(v) for k, v in metrics.items()}
                    row.update(step=step, dt=dt)
                    self.history.append(row)
                    if on_log:
                        on_log(row)
                if self.checkpointer and self.ckpt_every \
                        and step % self.ckpt_every == 0:
                    self.checkpointer.save_async(step, self.state)
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()
        if self.checkpointer:
            self.checkpointer.wait()
        return self.state
