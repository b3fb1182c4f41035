"""Serve a quantized LM through ``repro_torch`` alone (the reference's
``examples/serve_quantized.py``): the paper's deployed form, container-
packed 3-bit weights read through the on-chip dequantization path.

    PYTHONPATH=src python -m repro_torch.launch.serve_quantized           # the card
    PYTHONPATH=src python -m repro_torch.launch.serve_quantized --device cpu

On the card: qwen2-1.5b at full size, made from seed 0 there one layer
at a time, each layer exported to W3A8 ``qp`` containers as it is drawn;
on the CPU the reference example's ``reduced`` size (4 layers, d_model
128, vocab 512). Then
``generate`` (its decode step a CUDA graph on the card) on a batch of 4
prompts, and continuous batching of 6 mixed-length requests through
``ServingEngine``: one decode step a tick for every active slot, so the
3-bit weight stream is shared by the whole batch (the paper's Fig. 4
argument). The run fails if a row or a request comes back short or with
a token outside the vocabulary.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.precision import W3A8
from repro_torch.launch.serve import export_qp
from repro_torch.models import get_model
from repro_torch.models.api import init_export
from repro_torch.serving.engine import ServingEngine, generate

MAX_NEW = 16                    # generate's new tokens a row
REQUESTS = [list(range(1, 4 + (i % 3) * 4)) for i in range(6)]  # mixed
REQUEST_NEW = 8


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def serve(serve_params, cfg, prompts: torch.Tensor, device,
          dtype=torch.bfloat16) -> dict:
    """``generate`` on ``prompts`` (B, P), then REQUESTS through a 4-slot
    ``ServingEngine``, both in ``dtype`` under W3A8 on ``serve_params``:
    the generated rows, each request's tokens by uid, and the engine's
    calls."""
    out = generate(serve_params, prompts, cfg, policy=W3A8,
                   max_new_tokens=MAX_NEW, dtype=dtype, device=device)
    print("batch generate:", tuple(out.shape))

    # continuous batching over a request stream: requests enter slots of
    # ONE shared cache through length-bucketed batched prefill; tokens are
    # drained in bulk, never synced per token
    eng = ServingEngine(serve_params, cfg, policy=W3A8, slots=4, max_len=64,
                        dtype=dtype, device=device)
    for p in REQUESTS:
        eng.submit(p, max_new=REQUEST_NEW)
    done = sorted(eng.run_all(), key=lambda r: r.uid)
    for r in done:
        print(f"req {r.uid}: {r.out}")
    return {"generate": out, "outs": [list(r.out) for r in done],
            "ticks": eng.decode_calls, "prefill_calls": eng.prefill_calls}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = torch.device(ap.parse_args(argv).device)
    cfg = get_config("qwen2-1.5b")
    if dev.type == "cpu":
        cfg = reduced(cfg, layers=4, d_model=128, vocab=512)
    gen = torch.Generator(device=dev).manual_seed(0)

    # deploy: quantize + pack (the paper's "download to the accelerator"),
    # one layer at a time as it is drawn: the fp32 master is never whole
    float_bytes = _nbytes(get_model(cfg).init(torch.Generator(), cfg,
                                              device="meta"))
    serve_params = init_export(gen, cfg, export_qp, device=dev)
    print(f"deployed weights: {float_bytes / 2**20:.1f} MB fp32 -> "
          f"{_nbytes(serve_params) / 2**20:.2f} MB packed")

    prompts = torch.randint(0, cfg.vocab_size, (4, 8), generator=gen,
                            device=dev, dtype=torch.int32)
    res = serve(serve_params, cfg, prompts, dev)
    out, outs = res["generate"], res["outs"]
    tokens = sum(len(o) for o in outs)
    print(f"{tokens} tokens in {res['ticks']} batched decode ticks / "
          f"{res['prefill_calls']} bucketed prefill calls on "
          f"{torch.cuda.get_device_name(dev) if dev.type == 'cuda' else dev}")
    vocab_ok = bool(((out >= 0) & (out < cfg.vocab_size)).all()) and all(
        0 <= t < cfg.vocab_size for o in outs for t in o)
    if (tuple(out.shape) != (4, 8 + MAX_NEW)
            or not torch.equal(out[:, :8], prompts)
            or len(outs) != len(REQUESTS)
            or tokens != len(REQUESTS) * REQUEST_NEW or not vocab_ok):
        raise SystemExit(f"serve_quantized: generate {tuple(out.shape)}, "
                         f"{len(outs)} requests, {tokens} tokens, vocab "
                         f"{'ok' if vocab_ok else 'broken'}")
    return dict(res, generate=out.cpu(), requests=len(outs), tokens=tokens)


if __name__ == "__main__":
    main()
