"""Where a training step's time goes on the card: qwen2-1.5b at full size
under W3A8 with frozen ``fit_deltas_stacked`` deltas, AdamW, remat layer,
bf16 compute, batch 8 x 256 from ``lm_batch``, the step captured as a CUDA
graph.

    PYTHONPATH=src python -m repro_torch.launch.profile_train

Prints one JSON line: the host ms of a step (STEPS replays timed on the
host clock, synchronised), the device ms of a step from torch.profiler
over PROFILED more replays, the idle share (1 - device / host), and the
device ms by op group:

- ``matmuls``: kernels named as GEMMs (cuBLAS / CUTLASS), from the
  profiled W3A8 steps;
- ``fake_quant``: the W3A8 step's device ms less the same step's under
  FLOAT (profiled the same way) — the weights' and the 8-bit signals'
  fake-quant, forward, remat recompute and backward;
- ``adam``: the AdamW update (``update_``) of the step's own tensors,
  timed alone with CUDA events;
- ``loss``: ``softmax_xent`` forward and backward on fp32 logits of the
  step's shape, timed alone with CUDA events;
- ``other``: the rest (norms, RoPE, attention, residuals, the clip, the
  embedding).

The bound beside them is 6 x parameters x tokens at the bf16 tensor
cores' 989 TFLOP/s; the bound with remat's second forward (+ 2 x
parameters x tokens, a choice of this implementation, not work the step
must do) is printed beside it. Needs a CUDA card.
"""
from __future__ import annotations

import json
import statistics
import time

import torch

from repro_torch import optim as optim_lib
from repro_torch.configs import TrainConfig, get_config
from repro_torch.core import quant_dense
from repro_torch.core.precision import FLOAT, W3A8
from repro_torch.core.treeutil import flatten_with_path, unflatten
from repro_torch.data.pipeline import shard_batch
from repro_torch.data.synthetic import lm_batch
from repro_torch.launch.profile_engine import _cuda_rows, card_line
from repro_torch.models import get_model
from repro_torch.training.loop import make_train_step
from repro_torch.training.losses import softmax_xent

GEMM_NAMES = ("gemm", "cutlass", "nvjet", "xmma", "cublas")
BF16_PEAK = 989e12
BATCH, SEQ = 8, 256
STEPS, PROFILED = 8, 4


def _events_ms(fn, reps: int) -> float:
    """Median CUDA-event ms of one ``fn()`` (after one untimed call)."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    return statistics.median(ts)


def _profile(step, state, batches, profiled: int):
    """(host ms a step unprofiled, device ms a step, matmul device ms a
    step) over replays of ``step``."""
    for b in batches[:2]:                  # capture, and one replay
        state, _ = step(state, b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[2:]:
        state, _ = step(state, b)
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3 / len(batches[2:])
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for b in batches[2:2 + profiled]:
            state, _ = step(state, b)
        torch.cuda.synchronize()
    rows = list(_cuda_rows(prof))
    device = sum(ms for _, ms in rows) / profiled
    mm = sum(ms for k, ms in rows
             if any(n in k.lower() for n in GEMM_NAMES)) / profiled
    return state, host, device, mm


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA card")
    dev = torch.device("cuda")
    cfg = get_config("qwen2-1.5b")
    n = 2 + max(STEPS, PROFILED)
    batches = [shard_batch(lm_batch(0, i, batch=BATCH, seq=SEQ,
                                    vocab=cfg.vocab_size), dev)
               for i in range(n)]
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=2, total_steps=n,
                       grad_clip=1.0)
    out = {"card": card_line(), "arch": cfg.name, "layers": cfg.num_layers,
           "batch": [BATCH, SEQ], "captured": True,
           "policy": "W3A8, frozen fit_deltas_stacked deltas",
           "compute": "bf16 over fp32 masters", "remat": "layer"}
    res = {}
    for name, policy in (("float", FLOAT), ("w3a8", W3A8)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = get_model(cfg).init(
            torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
        extra = ({"deltas": quant_dense.fit_deltas_stacked(params, policy)}
                 if name == "w3a8" else None)
        step, init = make_train_step(cfg, tcfg, policy)
        state = init(params, extra)
        state, host, device, mm = _profile(step, state, batches, PROFILED)
        res[name] = {"host_ms": host, "device_ms": device, "matmul_ms": mm,
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        if name == "w3a8":
            opt = optim_lib.make("adamw")
            grads = unflatten(step.grads)
            lr = torch.full((), 1e-6, device=dev)
            adam = _events_ms(lambda: opt.update_(
                grads, state["opt"], state["params"], lr), 5)
            nparams = sum(t.numel() for t in
                          flatten_with_path(state["params"]).values())
        del step, state, params, extra
    torch.cuda.empty_cache()
    logits = torch.randn((BATCH, SEQ, cfg.vocab_size), device=dev,
                         requires_grad=True)
    labels = batches[0]["labels"]

    def loss_fb():
        (g,) = torch.autograd.grad(softmax_xent(logits, labels), [logits])
        return g
    loss = _events_ms(loss_fb, 5)
    del logits
    w = res["w3a8"]
    fq = w["device_ms"] - res["float"]["device_ms"]
    tokens = BATCH * SEQ
    bound = 6 * nparams * tokens / BF16_PEAK * 1e3     # remat's + 2 N aside
    out.update({
        "params": nparams, "host_ms": round(w["host_ms"], 3),
        "device_ms": round(w["device_ms"], 3),
        "idle_share": round(1 - w["device_ms"] / w["host_ms"], 4),
        "by_group_ms": {"matmuls": round(w["matmul_ms"], 3),
                        "fake_quant": round(fq, 3), "adam": round(adam, 3),
                        "loss": round(loss, 3),
                        "other": round(w["device_ms"] - w["matmul_ms"] - fq
                                       - adam - loss, 3)},
        "float_step": {k: round(v, 3) for k, v in res["float"].items()},
        "peak_gb": round(w["peak_gb"], 2),
        "tokens_per_s": round(tokens / w["host_ms"] * 1e3, 1),
        "bound_ms": round(bound, 3),
        "share_of_bound": round(bound / w["host_ms"], 4),
        "bound_with_remat_ms": round(bound * 8 / 6, 3),
        "share_of_bound_with_remat": round(bound * 8 / 6 / w["host_ms"],
                                           4)})
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
