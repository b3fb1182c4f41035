"""Multi-pod dry run — port of the reference's ``launch/dryrun.py``: for
every (architecture x input shape x mesh), build the real train / serve
step with its DTensor layouts (``launch/steps.py:build_cell``) on a
production mesh, trace it on fake tensors and record the cost, memory and
collective summaries of ``repro_torch.analysis.costs`` into
``build/dryrun/*.json``.

The meshes are the reference's (``launch/mesh.py``: 16x16 single pod,
2x16x16 multi-pod) over a FAKE process group of 256 or 512 ranks in this
one process (``torch.testing._internal.distributed.fake_pg``): every rank
but this one is imagined, every tensor is fake, nothing runs on a device
and no collective moves a byte; the trace records the collectives DTensor
issues with a rank's shapes. The reference's 512 forced host devices play
the same part. :func:`run_cell` also takes ``"host"``, the (1, 1) mesh of
one process: the dist phase's layout on one card.

Single-pod cells also record the reference's reduced-depth lowerings
(``aux_overrides``: L0 / L1, hybrid L0 / G1 / A1; prefill at
``prefill_seq_samples``), in the reference's schema, which the benchmark's
roofline reads; a trace counts every layer, so the full-depth record
needs no reconstruction. ``compile_s`` is the trace's seconds.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
      --shape decode_32k --mesh single --verify-tokens 5   # spec_k 4 verify
"""
from __future__ import annotations

import argparse
import dataclasses as dc
import json
import os
import time
import traceback
from pathlib import Path

import torch

from repro_torch.analysis import costs
from repro_torch.analysis.trace import fake_mode, fake_tree, trace
from repro_torch.configs import ARCH_IDS, LM_SHAPES, get_config, shape_by_name
from repro_torch.configs.base import TrainConfig
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.launch.steps import build_cell, input_specs  # noqa: F401

__all__ = ["OUT_DIR", "cell_id", "runnable_shapes", "lower_one",
           "aux_overrides", "prefill_seq_samples", "run_cell", "fake_world",
           "mesh_for", "WORLD"]

OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
WORLD = {"single": 256, "multi": 512, "host": 1}


def cell_id(arch, shape, mesh_name, quant):
    return f"{arch}__{shape}__{mesh_name}__{quant}"


def runnable_shapes(cfg):
    return [s for s in LM_SHAPES
            if not (s.name == "long_500k" and not cfg.sub_quadratic)]


def fake_world(world: int) -> None:
    """Make this process rank 0 of a fake process group of ``world``
    ranks (replacing any group of another size)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def mesh_for(mesh_name: str, device: str):
    """The named mesh over a fake group of its size."""
    fake_world(WORLD[mesh_name])
    if mesh_name == "host":
        return make_host_mesh(1, 1, device=device)
    return make_production_mesh(multi_pod=mesh_name == "multi",
                                device=device)


def _device(device: str) -> torch.device:
    d = torch.device(device)
    return torch.device("cuda", 0) if d.type == "cuda" and d.index is None \
        else d


def lower_one(cfg, shape, mesh, quant, layers_override=None, tcfg=None,
              device="cuda", verify_tokens=0):
    """Trace one cell on fake tensors -> ``{cost, memory, collectives,
    compile_s, gathers}``: its meta templates become fake tensors on
    ``device``, placed by the cell's layouts, and its step runs once
    (eagerly: a CUDA graph needs real tensors); ``gathers`` counts the
    trace's explicit gathers to ``Replicate`` by reason
    (``distributed.shards.gathers``). ``verify_tokens`` T > 0 traces a
    decode cell's speculative verify of T tokens a row instead of its
    decode step."""
    from repro_torch.distributed import shards
    from repro_torch.launch.steps import place
    t0 = time.time()
    before = dict(shards.gathers)
    cell = build_cell(cfg, shape, mesh, quant=quant,
                      num_layers_override=layers_override, tcfg=tcfg,
                      cost_exact=layers_override is not None, capture=False,
                      verify_tokens=verify_tokens)
    fm = fake_mode()
    args = fake_tree(cell.args, fm, _device(device))
    with fm:
        args = tuple(place(a, sh) for a, sh in zip(args, cell.in_shardings))
    tr = trace(cell.fn, *args, mode=fm)
    rec = {"cost": costs.cost_summary(tr),
           "memory": costs.memory_summary(tr),
           "collectives": costs.collective_bytes(tr),
           "compile_s": round(time.time() - t0, 1),
           "gathers": {k: n - before.get(k, 0)
                       for k, n in shards.gathers.items()
                       if n > before.get(k, 0)}}
    del tr, args, cell
    return rec


def aux_overrides(cfg):
    """Reduced-depth lowerings the roofline reads (the reference's)."""
    if cfg.family == "hybrid":
        return {"L0": 0, "G1": cfg.attn_every, "A1": 1}
    return {"L0": 0, "L1": 1}


def prefill_seq_samples(cfg):
    """The reference's prefill sequence samples: three points pin each
    cost term's quadratic in S; a sliding-window arch samples above twice
    its window."""
    if cfg.sliding_window:
        w = cfg.sliding_window
        return [2 * w, 3 * w, 4 * w]
    return [1024, 2048, 4096]


def run_cell(arch, shape_name, mesh_name, quant, *, force=False,
             with_aux=True, device="cuda", cfg=None, shape=None, tcfg=None,
             out_dir=None, verify_tokens=0):
    """Dry-run one cell and write its record (``cfg`` / ``shape`` override
    the named config and shape, e.g. a reduced config; ``tcfg`` the train
    cell's TrainConfig; ``verify_tokens`` T > 0 a decode shape's verify of
    T tokens, recorded as shape ``<shape>_verify<T>``). Returns the
    record; a failure is recorded with its traceback, not raised."""
    out_dir = Path(out_dir or OUT_DIR)
    out_dir.mkdir(parents=True, exist_ok=True)
    cfg = cfg or get_config(arch)
    shape = shape or shape_by_name(shape_name)
    if verify_tokens:
        if shape.kind != "decode":
            raise ValueError(f"verify_tokens: {shape_name} is a "
                             f"{shape.kind} shape, not a decode shape")
        shape_name = f"{shape_name}_verify{verify_tokens}"
    cid = cell_id(arch, shape_name, mesh_name, quant)
    path = out_dir / f"{cid}.json"
    if path.exists() and not force:
        print(f"[skip] {cid} (cached)")
        return json.loads(path.read_text())
    print(f"[run ] {cid} ...", flush=True)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "quant": quant, "num_layers": cfg.num_layers,
           "attn_every": cfg.attn_every,
           "params": cfg.param_count(),
           "active_params": cfg.active_param_count(),
           "seq_len": shape.seq_len, "global_batch": shape.global_batch,
           "kind": shape.kind, "device": str(device)}
    try:
        mesh = mesh_for(mesh_name, "cuda" if _device(device).type == "cuda"
                        else "cpu")
        rec["full"] = lower_one(cfg, shape, mesh, quant, tcfg=tcfg,
                                device=device, verify_tokens=verify_tokens)
        if with_aux and mesh_name == "single":
            aux_tcfg = (TrainConfig(microbatches=1) if shape.kind == "train"
                        else None)
            if shape.kind == "prefill":
                rec["aux_scheme"] = "seqfit"
                samples = prefill_seq_samples(cfg)
                rec["seq_samples"] = samples
                for s in samples:
                    sshape = dc.replace(shape, seq_len=s)
                    for name, ov in aux_overrides(cfg).items():
                        rec[f"{name}@{s}"] = lower_one(
                            cfg, sshape, mesh, quant, layers_override=ov,
                            device=device)
            else:
                rec["aux_scheme"] = "exact"
                for name, ov in aux_overrides(cfg).items():
                    rec[name] = lower_one(cfg, shape, mesh, quant,
                                          layers_override=ov, tcfg=aux_tcfg,
                                          device=device,
                                          verify_tokens=verify_tokens)
        rec["status"] = "ok"
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(rec["traceback"])
    tmp = path.with_suffix(".json.tmp")
    tmp.write_text(json.dumps(rec, indent=2))
    os.replace(tmp, path)
    print(f"[{'ok' if rec['status'] == 'ok' else 'ERR '}] {cid} "
          f"({rec.get('full', {}).get('compile_s', '?')}s)", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--quant", default="w3")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--no-aux", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the device of the fake tensors and the mesh "
                         "(default cuda: the card's graphs)")
    ap.add_argument("--verify-tokens", type=int, default=0,
                    help="trace a decode shape's speculative verify of this "
                         "many tokens a row (spec_k + 1) instead of its "
                         "decode step")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ARCH_IDS)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    failures = 0
    archs.sort(key=lambda a: get_config(a).param_count())
    for arch in archs:
        cfg = get_config(arch)
        shapes = [args.shape] if args.shape else \
            [s.name for s in runnable_shapes(cfg)]
        for sname in shapes:
            for mname in meshes:
                rec = run_cell(arch, sname, mname, args.quant,
                               force=args.force, with_aux=not args.no_aux,
                               device=args.device,
                               verify_tokens=args.verify_tokens)
                failures += rec["status"] != "ok"
    print(f"done; failures={failures}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
