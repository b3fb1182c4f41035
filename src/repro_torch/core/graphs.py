"""CUDA graphs — the port's counterpart of the reference's ``jax.jit``
boundaries: the serving engine's tick and admissions
(``serving/engine.py::_build_jits``), the paper pipeline's training step
and evaluation forward (``paper/pipeline.py``).

A :class:`Graphs` owns the graphs of one engine or training run, keyed by
the work and its shape (``"tick"``, ``("admit", bucket)``, ``("step",
batch shape)``). The first call of a key warms the
work up eagerly, ``WARMUPS`` times on a side stream (the kernels build,
their launch plans fill, their once-only ``cudaFuncSetAttribute`` calls
run), inside the caller's ``idle`` context, in which the work changes no
live state; then it captures the work once. Every call replays. The work
reads and writes only fixed tensors, buffers the caller owns and fills
before :meth:`Graphs.run`, and returns nothing: what it allocates lives in
the graphs' shared pool and is overwritten by the next replay.

Launch counters: while a work is recorded, the kernel wrappers count the
launches it would make, by kernel and by variant; the capture keeps those
counts (``_Graph.launches``) and takes them back, since recording launches
nothing. Every replay adds them, so the counters read after a replayed call
what they read after an eager one. ``Graphs.captures`` counts captures by
key, the counterpart of the reference's ``_cache_size()``.

``Graphs.warmup_launches`` holds what the warm-ups launched (they do run
the kernels), so a captured run's counters less it equal an eager run's.

``capture=False`` runs every work eagerly (the counterpart of
``jax.disable_jit``). A capture or replay that fails raises; nothing falls
back to eager. :meth:`Graphs.reset` drops every graph (the engine's
degradation ladder changes what the work launches, as the reference
re-jits); the next call of each key captures it again, and ``captures``
keeps counting.

:func:`index_drop_` is the reference's ``.at[idx].set(mode="drop")`` without
a host sync, so a fixed-length index whose padding points past the end
keeps one shape in a graph.
"""
from __future__ import annotations

import contextlib
import importlib
import sys
from typing import Callable, ContextManager, Dict, Hashable, Optional, Tuple

import torch

__all__ = ["Graphs", "WARMUPS", "read_counters", "kept", "masked",
           "index_drop_"]

WARMUPS = 2
_KERNELS = ("qmatvec", "qmatmul", "attn_decode", "attn_prefill", "sigmoid_pw")

Counters = Dict[Tuple[str, str], object]


def _counter_modules():
    return [importlib.import_module(f"repro_torch.kernels.{k}.{m}")
            for k in _KERNELS for m in ("kernel", "ref")]


def read_counters() -> Counters:
    """Every launch and plain-call counter of the kernels, by (module,
    name): an int, or a dict by variant or layout (copied)."""
    out: Counters = {}
    for mod in _counter_modules():
        for name, v in vars(mod).items():
            if name in ("launches", "bwd_launches", "calls") \
                    or name.startswith("launches_by_"):
                out[(mod.__name__, name)] = dict(v) if isinstance(v, dict) \
                    else v
    return out


def _restore(values: Counters) -> None:
    for (mod, name), v in values.items():
        if isinstance(v, dict):
            getattr(sys.modules[mod], name).update(v)
        else:
            setattr(sys.modules[mod], name, v)


def _add(delta: Counters) -> None:
    for (mod, name), v in delta.items():
        m = sys.modules[mod]
        if isinstance(v, dict):
            split = getattr(m, name)
            for key, n in v.items():
                split[key] += n
        else:
            setattr(m, name, getattr(m, name) + v)


def _diff(after: Counters, before: Counters) -> Counters:
    """The counters that moved from ``before`` to ``after``."""
    out: Counters = {}
    for key, v in after.items():
        if isinstance(v, dict):
            d = {k: n - before[key][k] for k, n in v.items()
                 if n != before[key][k]}
        else:
            d = v - before[key]
        if d:
            out[key] = d
    return out


def _merge(into: Counters, delta: Counters) -> None:
    """Add the counters ``delta`` to ``into``, in place."""
    for key, v in delta.items():
        if isinstance(v, dict):
            split = into.setdefault(key, {})
            for k, n in v.items():
                split[k] = split.get(k, 0) + n
        else:
            into[key] = into.get(key, 0) + v


class _Graph:
    """One captured CUDA graph and the launches its capture recorded."""

    def __init__(self, fn: Callable[[], None], pool,
                 generator: Optional[torch.Generator]):
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            self.graph.register_generator_state(generator)
        before = read_counters()
        try:
            with torch.cuda.graph(self.graph, pool=pool):
                fn()
            self.launches = _diff(read_counters(), before)
        finally:
            _restore(before)

    def replay(self) -> None:
        self.graph.replay()
        _add(self.launches)


@contextlib.contextmanager
def kept(*tensors: torch.Tensor):
    """The tensors' contents come back after the block (in stream order),
    so warm-ups run inside it leave no trace in them."""
    saved = [t.detach().clone() for t in tensors]
    try:
        yield
    finally:
        with torch.no_grad():
            for t, s in zip(tensors, saved):
                t.copy_(s)


@contextlib.contextmanager
def masked(buf: torch.Tensor, value):
    """Hold ``buf`` at ``value`` inside the block; its contents come back
    after it."""
    with kept(buf):
        buf.fill_(value)
        yield


class Graphs:
    """Capture-once, replay-always CUDA graphs of one engine or training
    run, by key."""

    def __init__(self, device, *, capture: Optional[bool] = None,
                 generator: Optional[torch.Generator] = None):
        self.device = torch.device(device)
        if capture and self.device.type != "cuda":
            raise ValueError(f"capture=True needs a CUDA device, got "
                             f"{self.device}: CUDA graphs have no CPU mode")
        # default: capture on the card, eager elsewhere
        self.capture = self.device.type == "cuda" if capture is None \
            else capture
        self.generator = generator       # drawn from by the work: registered
        self.captures: Dict[Hashable, int] = {}
        self.warmup_launches: Counters = {}
        self._graphs: Dict[Hashable, _Graph] = {}
        self._pool = None

    def reset(self) -> None:
        """Drop every captured graph and its memory pool; each key is
        captured again at its next call. On the card the stream drains
        first, so no replay still running reads memory the pool gives
        back."""
        if self._graphs and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._graphs.clear()
        self._pool = None

    def run(self, key: Hashable, fn: Callable[[], None],
            idle: Callable[[], ContextManager] = contextlib.nullcontext
            ) -> None:
        """Run ``fn``: eagerly, or by replaying ``key``'s graph, captured
        at its first call after warm-ups inside ``idle()``."""
        if not self.capture:
            fn()
            return
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._capture(key, fn, idle)
        graph.replay()

    def _capture(self, key, fn, idle) -> _Graph:
        gen = self.generator
        before = read_counters()
        with idle():
            rng = None if gen is None else gen.get_state()
            if self.device.type == "cuda":
                main = torch.cuda.current_stream(self.device)
                side = torch.cuda.Stream(self.device)
                side.wait_stream(main)
                with torch.cuda.stream(side):
                    for _ in range(WARMUPS):
                        fn()
                main.wait_stream(side)
            else:
                for _ in range(WARMUPS):
                    fn()
            if rng is not None:          # warm-ups draw nothing for real
                gen.set_state(rng)
        _merge(self.warmup_launches, _diff(read_counters(), before))
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = self._graphs[key] = _Graph(fn, self._pool, gen)
        self.captures[key] = self.captures.get(key, 0) + 1
        return graph


def index_drop_(dst: torch.Tensor, idx: torch.Tensor, src, dim: int = 0
                ) -> torch.Tensor:
    """``dst``'s entry ``idx[i]`` along ``dim`` becomes ``src``'s entry
    ``i`` (or the scalar ``src``) for every ``idx[i] < dst.shape[dim]``;
    rows past the end are dropped, in place, with no host sync. Dropped rows
    are written onto the last entry with the value it ends with (its own,
    or that of the in-range row that targets it), so duplicate writes agree.
    Duplicate in-range indices leave one of their rows."""
    nb, n = dst.shape[dim], idx.shape[0]
    idx = idx.long()
    # owner[s]: the row of idx that writes entry s, -1 for none; rows past
    # the end land on a spare last entry, which is cut off
    owner = torch.full((nb + 1,), -1, dtype=torch.long, device=idx.device)
    owner[idx.clamp(max=nb)] = torch.arange(n, device=idx.device)
    tgt = idx.clamp(max=nb - 1)
    row = owner[tgt]
    shape = [1] * dst.dim()
    shape[dim] = n
    keep = (row >= 0).view(shape)
    if isinstance(src, torch.Tensor):
        src = src.index_select(dim, row.clamp(min=0)).to(dst.dtype)
    new = torch.where(keep, src, dst.narrow(dim, nb - 1, 1))
    return dst.index_copy_(dim, tgt, new)
