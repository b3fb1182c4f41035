"""Train a ~100M-parameter decoder LM with the paper's W3A8 QAT for a few
hundred steps — the counterpart of the reference's
``examples/train_lm_100m.py``: quantized training loss should track the
float baseline closely.

    PYTHONPATH=src python -m repro_torch.launch.train_lm_100m --steps 300
    PYTHONPATH=src python -m repro_torch.launch.train_lm_100m --quant float

The reference's flags plus ``--device`` (default ``cuda``; without a card
it raises). ``--ckpt-dir`` (default: none) saves every 100 steps. The step
is captured as a CUDA graph on the card; W3A8 refits each weight's step
size in every forward, as the reference does.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch import checkpoint as ckpt_lib
from repro_torch.configs import TrainConfig, get_config
from repro_torch.core.precision import FLOAT, W3A8
from repro_torch.data.pipeline import HostLoader
from repro_torch.data.synthetic import lm_batch
from repro_torch.launch.train import resolve_device
from repro_torch.models import get_model
from repro_torch.training.loop import Trainer, make_train_step


def make_100m_cfg():
    """qwen2-style ~100M: 12L x d768 x ff2048, vocab 8192 (tied)."""
    return dataclasses.replace(
        get_config("qwen2-1.5b"), name="qwen2-100m", num_layers=12,
        d_model=768, num_heads=12, num_kv_heads=4, head_dim=64, d_ff=2048,
        vocab_size=8192, tie_embeddings=True)


def train_config(steps: int) -> TrainConfig:
    return TrainConfig(learning_rate=3e-4, total_steps=steps,
                       warmup_steps=20, optimizer="adamw", remat="layer")


def main(argv=None):
    """Returns the trainer (its ``history`` holds the logged rows)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--quant", default="w3a8", choices=["float", "w3a8"])
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = make_100m_cfg()
    print(f"model: {cfg.param_count() / 1e6:.0f}M params")
    policy = W3A8 if args.quant == "w3a8" else FLOAT
    gen = torch.Generator(device=device).manual_seed(0)
    params = get_model(cfg).init(gen, cfg, device=device)
    step_fn, init_state = make_train_step(cfg, train_config(args.steps),
                                          policy)
    loader = HostLoader(lambda seed, s: lm_batch(
        seed, s, batch=args.batch, seq=args.seq, vocab=cfg.vocab_size),
        device=device)
    ck = ckpt_lib.Checkpointer(args.ckpt_dir, keep=2) if args.ckpt_dir \
        else None
    trainer = Trainer(step_fn, init_state(params), checkpointer=ck,
                      ckpt_every=100, log_every=20)
    trainer.run(loader, args.steps,
                on_log=lambda r: print(
                    f"step {r['step']:4d} loss {r['loss']:.4f} "
                    f"acc {r['acc']:.3f} {r['dt'] * 1e3:.0f}ms", flush=True))
    print(f"straggler stats: {trainer.monitor.slow_steps}/"
          f"{trainer.monitor.total_steps} slow steps")
    return trainer


if __name__ == "__main__":
    main()
