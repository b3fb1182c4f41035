"""Input pipeline — port of the reference's ``data/pipeline.py``: a
background prefetch queue (depth 2 is the paper's BRAM0/BRAM1 ping-pong,
§3: while the card consumes batch i, batch i + 1 is made and moved), a
step-indexed restartable loader, and the placement of a host batch.

On one card ``shard_batch`` puts each leaf on the target device, from
pinned memory without blocking the host when that device is a CUDA card.
Made on the prefetch thread, the copy runs on that thread's current
stream, which is the device's default stream; a captured training step
copies the batch into its own fixed input tensors on the compute stream
before each replay (``training/loop.py``), so it never reads a tensor made
on another stream unsynchronised. The sharded placement over a mesh waits
for the distributed port.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator, Optional

import torch

__all__ = ["prefetch", "shard_batch", "HostLoader"]


def prefetch(it: Iterator[Any], size: int = 2) -> Iterator[Any]:
    """Background-thread prefetch queue of depth ``size`` (2 = ping-pong).
    An exception in ``it`` is raised in the consumer after the items made
    before it; closing the consumer stops the thread."""
    q: "queue.Queue" = queue.Queue(maxsize=size)
    sentinel = object()
    err: list = []
    stop = threading.Event()

    def put(x) -> bool:
        while not stop.is_set():
            try:
                q.put(x, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def worker():
        try:
            for x in it:
                if not put(x):
                    return
        except Exception as e:        # propagate into the consumer
            err.append(e)
        put(sentinel)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            x = q.get()
            if x is sentinel:
                if err:
                    raise err[0]
                return
            yield x
    finally:
        stop.set()
        t.join(timeout=5.0)


def shard_batch(batch, device=None) -> Any:
    """Place a host batch (a dict of tensors) on ``device`` (None: leave it
    where it is)."""
    if device is None:
        return batch
    device = torch.device(device)

    def put(x: torch.Tensor) -> torch.Tensor:
        if device.type == "cuda":
            return x.pin_memory().to(device, non_blocking=True)
        return x.to(device)

    return {k: put(v) for k, v in batch.items()}


class HostLoader:
    """Deterministic step-indexed loader: batch = ``batch_fn(seed, step)``,
    placed on ``device``.

    Restart: nothing to checkpoint but the step counter — any host can
    regenerate any batch (``start_step`` is the first one made)."""

    def __init__(self, batch_fn: Callable[[int, int], Any], *, seed: int = 0,
                 start_step: int = 0, device: Optional[Any] = None,
                 prefetch_depth: int = 2):
        self.batch_fn = batch_fn
        self.seed = seed
        self.step = start_step
        self.device = device
        self.prefetch_depth = prefetch_depth

    def __iter__(self):
        def gen():
            step = self.step
            while True:
                yield shard_batch(self.batch_fn(self.seed, step), self.device)
                step += 1

        return prefetch(gen(), self.prefetch_depth)
