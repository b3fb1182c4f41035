"""Where the paper MLP's time goes on the card: the digit net at full width
(784-1022-1022-1022-10, batch 100) deployed as W3A8 containers, the same
net as a float forward, and its float and STE training steps, each under
``torch.profiler``.

    PYTHONPATH=src python -m repro_torch.launch.profile_mlp

The weights are a seeded init (the time does not depend on training). For
each forward form it times ``FORWARDS`` forwards with the host clock (after
a synchronize) and then again under the profiler. ``w3a8_kernels`` is the
deployed forward run eagerly, ``w3a8_kernels_captured`` the same forward
replayed from one CUDA graph (``core.graphs.Graphs``, as
``paper.pipeline.evaluate`` runs it: the batch staged in a fixed buffer,
the logits copied into one; its bits are checked against the eager
forward's). For each training form
one epoch of ``STEPS`` SGD steps (``paper.pipeline.train_mlp`` on a
``STEPS * 100``-example digit task), its step replayed as a CUDA graph
(the epoch's time includes the step's two warm-ups and its capture) and,
``_eager``, with ``capture=False``. Prints one JSON line: per form the ms
per forward or step, images per second, device time summed by kernel (the
port's kernels by name, everything else as ``other``), device busy ms, the
device operations (kernels, copies, sets) a call and the device's idle
share of the profiled wall time. Run by path with ``PYTHONPATH`` at
another tree's ``src`` it measures that tree's forward with this harness
(an A/B of two trees in one call). Device times are the
self times of the profiler's CUDA-type rows, as in ``profile_engine.py``.
"""
from __future__ import annotations

import dataclasses
import json
import time

import torch

from repro_torch.core import quant_dense
from repro_torch.core.graphs import Graphs
from repro_torch.core.precision import FLOAT, W3A8
from repro_torch.data.synthetic import digit_task
from repro_torch.launch.profile_engine import (_cuda_rows, card_line,
                                               device_ms_by_kernel)
from repro_torch.models import dnn
from repro_torch.paper.pipeline import train_mlp

KERNELS = ("qmatvec", "qmatmul", "sigmoid_pw")
FORWARDS = 200
STEPS = 20
BATCH = 100


def _profiled(fn, count: int):
    """Host-clock ms per call, then the profiled breakdown per call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(count):
        fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / count * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(count):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kernel = {k: v / count
                 for k, v in device_ms_by_kernel(prof, KERNELS).items()}
    busy = sum(by_kernel.values())
    return {"ms": ms, "profiled_ms": wall / count * 1e3,
            "device_ms_by_kernel": by_kernel, "device_busy_ms": busy,
            "device_ops": sum(1 for _ in _cuda_rows(prof)) / count,
            "idle_share": 1.0 - busy / (wall / count * 1e3)}


def _captured(fn, x):
    """``fn(x)`` as one CUDA graph replay: returns the call that replays it
    and its logits buffer, which each replay rewrites."""
    graphs, xb = Graphs(x.device), x.clone()
    out = torch.empty_like(fn(x))

    def work():
        out.copy_(fn(xb))

    def replay():
        graphs.run("forward", work)
    replay()
    return replay, out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_mlp needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    master = dnn.init(gen, 784, (1022, 1022, 1022), 10, device=dev)
    served = quant_dense.export_container(master, W3A8)
    task = digit_task(seed=0, n_train=STEPS * BATCH, n_test=BATCH)
    x = torch.from_numpy(task.test[0]).to(dev)
    out = {"card": card_line(), "net": "784-1022-1022-1022-10",
           "batch": BATCH}

    def w3a8(v):
        return dnn.forward(served, v, policy=W3A8, sigmoid_mode="pw")

    with torch.no_grad():
        replay, logits = _captured(w3a8, x)
        torch.cuda.synchronize()
        if not torch.equal(logits, w3a8(x)):
            raise SystemExit("profile_mlp: the captured forward's logits "
                             "differ from the eager forward's")
        forwards = {
            "w3a8_kernels": lambda: w3a8(x),
            "w3a8_kernels_captured": replay,
            "w3a8_kernels_no_a8": lambda: dnn.forward(
                served, x, policy=dataclasses.replace(W3A8, act_bits=None),
                sigmoid_mode="pw"),
            "float": lambda: dnn.forward(master, x, policy=FLOAT),
        }
        for name, fn in forwards.items():
            r = _profiled(fn, FORWARDS)
            r["images_per_s"] = BATCH / (r["ms"] / 1e3)
            out[f"forward_{name}"] = r
    kw = dict(epochs=1, batch=BATCH, lr=0.1, momentum=0.9)
    for name, policy in (("float", FLOAT), ("ste_w3a8", W3A8)):
        for tag, capture in (("", True), ("_eager", False)):
            r = _profiled(lambda: train_mlp(master, task, policy=policy,
                                            capture=capture, **kw), 1)
            for k in ("ms", "profiled_ms", "device_busy_ms"):
                r[k] /= STEPS
            r["device_ms_by_kernel"] = {k: v / STEPS for k, v in
                                        r["device_ms_by_kernel"].items()}
            out[f"train_step_{name}{tag}"] = r
    print(json.dumps(out))


if __name__ == "__main__":
    main()
