"""Training launcher: any assigned arch on a mesh — port of the
reference's ``launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --quant w3a8 --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --reduced --steps 50 --quant w3a8 --ckpt-dir ck --device cpu

The reference's flags plus ``--device`` (default ``cuda``; without a card
it raises). ``--mesh host`` is ``launch.mesh.make_host_mesh`` over the
process group (one process unless the environment names a group, as
``torchrun`` does: then ``env://``); ``single`` / ``multi`` are the
16x16 / 2x16x16 production meshes, which need a group of 256 / 512
processes. The state is placed by ``sharding.state_specs`` (DTensors),
each batch by ``batch_specs``, and the step runs under the activation
rules. Weights come from a seeded generator on the device, batches from
``data.synthetic.lm_batch`` through the prefetching ``HostLoader``. On a
CUDA device the step is captured as a CUDA graph and replayed
(``training.loop``). As in the reference, the state holds no frozen
deltas, so W3A8 refits every weight's step size in each forward.
``--resume`` restores the latest checkpoint of ``--ckpt-dir`` onto the
mesh (``checkpoint.restore(shardings=)``, whatever mesh wrote it) and
continues from its step.
"""
from __future__ import annotations

import argparse
import os

import torch

from repro_torch import checkpoint as ckpt_lib
from repro_torch.configs import ShapeConfig, TrainConfig, get_config, reduced
from repro_torch.core.precision import FLOAT, W3A8
from repro_torch.data.pipeline import HostLoader
from repro_torch.data.synthetic import lm_batch
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import (init_single_process, make_host_mesh,
                                     make_production_mesh)
from repro_torch.launch.steps import mesh_step, place
from repro_torch.models import get_model
from repro_torch.training.loop import Trainer, make_train_step


def resolve_device(name: str) -> torch.device:
    """``name`` as a device; a CUDA device without a card raises."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} asked for but no CUDA card is "
                           f"available; pass --device cpu")
    return dev


def main(argv=None):
    """Returns the trainer (its ``history`` holds the logged rows)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--quant", default="w3a8", choices=["float", "w3a8"])
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized config (same family structure)")
    ap.add_argument("--mesh", default="host",
                    choices=["host", "single", "multi"])
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    started = _init_group(device)
    try:
        return _train(args, device)
    finally:
        if started:
            import torch.distributed as dist
            dist.destroy_process_group()


def _train(args, device):
    mesh = (make_host_mesh(device=device) if args.mesh == "host" else
            make_production_mesh(multi_pod=args.mesh == "multi",
                                 device=device))
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    policy = W3A8 if args.quant == "w3a8" else FLOAT
    tcfg = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                       warmup_steps=max(args.steps // 10, 1))

    gen = torch.Generator(device=device).manual_seed(0)
    params = get_model(cfg).init(gen, cfg, device=device)
    step_fn, init_state = make_train_step(cfg, tcfg, policy)
    state = init_state(params)
    shape = ShapeConfig("train", args.seq, args.batch, "train")
    shardings = shd.tree_shardings(mesh, shd.state_specs(cfg, state, mesh))

    start_step = 0
    ck = None
    if args.ckpt_dir:
        ck = ckpt_lib.Checkpointer(args.ckpt_dir, keep=3)
        if args.resume and ckpt_lib.latest_step(args.ckpt_dir) is not None:
            # elastic restore: placed on the current mesh
            state, meta = ckpt_lib.restore(args.ckpt_dir,
                                           shardings=shardings)
            start_step = meta["step"]
            print(f"resumed from step {start_step}")
    if start_step == 0:
        state = place(state, shardings)
    step = mesh_step(step_fn, cfg, shape, mesh)

    loader = HostLoader(lambda seed, s: lm_batch(
        seed, s, batch=args.batch, seq=args.seq, vocab=cfg.vocab_size),
        start_step=start_step, device=device)
    trainer = Trainer(step, state, checkpointer=ck,
                      ckpt_every=max(args.steps // 5, 10))
    trainer.run(loader, args.steps,
                on_log=lambda r: print(
                    f"step {r['step']:5d} loss {r['loss']:.4f} "
                    f"lr {r['lr']:.2e} {r['dt'] * 1e3:.0f}ms", flush=True))
    print(f"done; stragglers {trainer.monitor.slow_steps}/"
          f"{trainer.monitor.total_steps}")
    return trainer


def _init_group(device) -> bool:
    """The process group: ``env://`` when the environment names one (as
    ``torchrun`` does), else a one-process group; none if one exists.
    Returns whether it started one."""
    import torch.distributed as dist
    if dist.is_initialized():
        return False
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method="env://")
    else:
        init_single_process(device)
    return True


if __name__ == "__main__":
    main()
