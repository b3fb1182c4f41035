"""Serving launcher: quantize-and-serve through the batched engine on the
card (one decode call per tick, all slots at once).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --requests 8 --slots 4 --max-new 16

Any config serves (``--arch`` qwen2-1.5b, stablelm-3b, qwen2.5-14b,
qwen3-32b; the MoE family phi3.5-moe-42b-a6.6b and mixtral-8x22b, whose
cache is a ring of at most its 4096-token window; the state-space
mamba2-2.7b and the hybrid zamba2-1.2b; musicgen-large and internvl2-26b,
served as their decoders). ``--kv8`` and ``--spec-k`` refuse mamba2-2.7b
(no KV cache, a state that cannot be rewound) with the engine's error.
``--reduced`` shrinks the model for a rehearsal; ``--device cpu`` runs the
kernels' plain versions on the CPU. The weights are built on the card one
layer at a time into their serve form (``api.init_export``), so every
config but mixtral-8x22b serves at full depth on one 80 GB card
(qwen3-32b's W3A8 export is 14 GB, its fp32 master 131 GB); ``--layers N``
keeps the first N layers at full width (mixtral-8x22b: its int8 expert
levels alone are 136 GB). ``--spec-k K`` serves speculatively:
the packed 3-bit export of the same weights drafts K tokens a tick
(``--draft-depth`` keeps a leading share of its layers) and the target
verifies them. The same flags as the reference's ``launch/serve.py``,
the overload and durability ones among them:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --requests 16 --slots 2 --queue-limit 8 --shed-policy drop_oldest \
        --deadline 48 --preempt 8 --max-ticks 512

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --requests 8 --slots 4 --snapshot-dir snaps --snapshot-every 16 \
        --journal serve.jsonl --integrity-every 32 [--resume]

The counters print after the run as the reference prints them.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import quant_dense
from repro_torch.core.precision import FLOAT, W3A8
from repro_torch.models import api as model_api
from repro_torch.serving.engine import ServingEngine, check_family


def cast_weights(tree, dtype):
    """A float master with its weights and biases cast to ``dtype`` once,
    so that no forward casts the whole master again; the norms' scales
    stay fp32."""
    return {k: (cast_weights(v, dtype) if isinstance(v, dict)
                else v.to(dtype) if k in ("w", "b") else v)
            for k, v in tree.items()}


def config_for(arch: str, *, small: bool = False, layers=None):
    """The config of ``arch``, ``reduced`` for a rehearsal (``small``), or
    cut to its first ``layers`` layers at full width."""
    cfg = get_config(arch)
    if small:
        cfg = reduced(cfg)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    return cfg


def as_master(tree):
    """The float master itself: the ``--form w`` serve tree (the W3A8
    policy fake-quantizes it on the fly) and the fp32 engines' weights."""
    return tree


def to_bf16(tree):
    """The ``--quant float`` serve tree: the master cast once to bf16."""
    return cast_weights(tree, torch.bfloat16)


def export_q(tree):
    """The W3A8 int8-level export (``--form q``)."""
    return quant_dense.export_levels(tree, W3A8)


def export_qp(tree):
    """The W3A8 packed 3-bit container export (``--form qp``, and every
    speculative drafter)."""
    return quant_dense.export_container(tree, W3A8)


SERVE_EXPORTS = {"w": as_master, "q": export_q, "qp": export_qp}


def build_params(cfg, *, quant: str, form: str, seed: int, device,
                 spec_k: int = 0, draft_depth: float = 1.0):
    """Weights from a seeded generator, built on ``device`` one layer at a
    time into their serve form (``api.init_export``: the fp32 master is
    never whole there): the W3A8 export of ``form``, or for
    ``quant="float"`` the bf16 cast, the serving dtype. With ``spec_k`` the
    drafter (``draft_of``) is the ``qp`` export of the same weights: the
    served export itself under ``form="qp"``, else built in the same pass.
    Returns (params, policy, draft_cfg, draft_params), the last two None
    without ``spec_k``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    serve, policy = ((SERVE_EXPORTS[form], W3A8) if quant == "w3"
                     else (to_bf16, FLOAT))
    if spec_k and serve is not export_qp:
        params, qp = model_api.init_export(gen, cfg, (serve, export_qp),
                                           device=device)
    else:
        params = qp = model_api.init_export(gen, cfg, serve, device=device)
    draft_cfg = draft_params = None
    if spec_k:
        draft_cfg, draft_params = model_api.draft_of(
            cfg, qp, depth_fraction=draft_depth)
    return params, policy, draft_cfg, draft_params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="keep the first N layers (full width)")
    ap.add_argument("--quant", default="w3", choices=["float", "w3"])
    ap.add_argument("--form", default="qp", choices=["w", "q", "qp"],
                    help="weight form for --quant w3: levels (q) or packed "
                         "containers (qp, the paper's BRAM image)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--matmul-mode", default="auto",
                    choices=["auto", "kernel", "dequant"],
                    help="quantized-matmul dispatch: CUDA kernels, their "
                         "plain versions, or auto (kernels on CUDA)")
    ap.add_argument("--attn-mode", default="auto",
                    choices=["auto", "kernel", "ref"],
                    help="attention dispatch for prefill and decode: CUDA "
                         "kernels, reference, or auto (kernels on CUDA)")
    ap.add_argument("--kv8", action="store_true",
                    help="serve from an int8 KV cache (per-token scales)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: the packed 3-bit drafter "
                         "proposes this many tokens a tick (0 = off)")
    ap.add_argument("--draft-depth", type=float, default=1.0,
                    help="share of the layers the drafter keeps")
    ap.add_argument("--queue-limit", type=int, default=None,
                    help="bounded admission: queued requests past this "
                         "depth are shed per --shed-policy")
    ap.add_argument("--shed-policy", default="reject",
                    choices=["reject", "drop_oldest"],
                    help="what bounded admission sheds when the queue is "
                         "full: the new request, or the oldest queued one")
    ap.add_argument("--deadline", type=int, default=None,
                    help="default per-request deadline in decode ticks; "
                         "expired requests are cancelled mid-stream "
                         "(partial output, status='deadline')")
    ap.add_argument("--preempt", type=int, default=None,
                    help="preempt a slot held this many ticks when the "
                         "queue has waiters; the request requeues with its "
                         "committed tokens")
    ap.add_argument("--max-ticks", type=int, default=None,
                    help="watchdog: abort run_all with a diagnostic dump "
                         "after this many step() calls")
    ap.add_argument("--snapshot-dir", default=None,
                    help="durability: persist atomic engine snapshots here "
                         "(device caches, host bookkeeping, generator state)")
    ap.add_argument("--snapshot-every", type=int, default=None,
                    help="snapshot every N decode ticks (needs "
                         "--snapshot-dir)")
    ap.add_argument("--journal", default=None,
                    help="write-ahead JSONL journal of submit/admit/commit/"
                         "finish/shed events (the replay tail for --resume)")
    ap.add_argument("--resume", action="store_true",
                    help="recover before serving: restore the latest "
                         "snapshot under --snapshot-dir and resubmit the "
                         "journal tail (then also submit this run's "
                         "requests)")
    ap.add_argument("--integrity-every", type=int, default=None,
                    help="run the weight-store fingerprint probe every N "
                         "ticks; detected corruption is healed from the "
                         "golden copy")
    ap.add_argument("--golden-dir", default=None,
                    help="also persist the golden weight copy + CRC "
                         "manifest here (checkpoint.integrity)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = config_for(args.arch, small=args.reduced, layers=args.layers)
    check_family(cfg, kv_bits=8 if args.kv8 else None, spec_k=args.spec_k)
    params, policy, draft_cfg, draft_params = build_params(
        cfg, quant=args.quant, form=args.form, seed=args.seed,
        device=args.device, spec_k=args.spec_k, draft_depth=args.draft_depth)
    eng = ServingEngine(params, cfg, policy=policy, slots=args.slots,
                        max_len=64 + args.max_new + args.spec_k,
                        temperature=args.temperature, eos_id=args.eos_id,
                        matmul_mode=args.matmul_mode,
                        attn_mode=args.attn_mode,
                        kv_bits=8 if args.kv8 else None, seed=args.seed,
                        spec_k=args.spec_k, draft_params=draft_params,
                        draft_cfg=draft_cfg,
                        queue_limit=args.queue_limit,
                        shed_policy=args.shed_policy,
                        default_deadline=args.deadline,
                        preempt_after=args.preempt,
                        max_ticks=args.max_ticks,
                        snapshot_dir=args.snapshot_dir,
                        snapshot_every=args.snapshot_every,
                        journal=args.journal,
                        integrity_every=args.integrity_every,
                        golden_dir=args.golden_dir, device=args.device)
    if args.resume:
        stats = eng.recover()
        print(f"recovered: snapshot step {stats['restored_step']}, "
              f"{stats['replayed_events']} journal events replayed, "
              f"{stats['resubmitted']} requests resubmitted")
    # mixed prompt lengths: exercises the length-bucketed batched admission
    lens = [4, 8, 5, 12, 3, 16, 7, 9]
    t0 = time.time()
    for i in range(args.requests):
        plen = lens[i % len(lens)]
        eng.submit([(1 + i + j) % 50 + 1 for j in range(plen)],
                   max_new=args.max_new)
    done = eng.run_all()
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    dt = time.time() - t0
    toks = sum(len(r.out) for r in done)
    print(f"{len(done)} requests, {toks} tokens in {dt:.1f}s "
          f"({toks / dt:.1f} tok/s on {eng.device}), "
          f"{eng.decode_calls} batched decode ticks "
          f"({toks / max(eng.decode_calls, 1):.2f} tok/tick), "
          f"{eng.prefill_calls} bucketed prefill calls "
          f"({len(done) / max(eng.prefill_calls, 1):.2f} req/prefill)")
    if (args.queue_limit is not None or args.deadline is not None
            or args.preempt is not None):
        by_status: dict = {}
        for r in done:
            by_status[r.status] = by_status.get(r.status, 0) + 1
        print(f"resilience: statuses {by_status}, "
              f"shed {eng.shed_count}, "
              f"deadline misses {eng.deadline_miss_count}, "
              f"preemptions {eng.preempt_count}, "
              f"poisoned {eng.poisoned_count}, "
              f"queue peak {eng.queue_peak}")
    if (args.snapshot_dir is not None or args.journal is not None
            or args.integrity_every is not None):
        print(f"durability: snapshots written {eng.snapshots_written}, "
              f"journal events {eng.journal_events}, "
              f"replayed {eng.replayed_events}, "
              f"integrity probes {eng.integrity_probes}, "
              f"heals {eng.heal_count}")
    if args.spec_k:
        print(f"spec accept rate {eng.spec_accept_rate:.3f} "
              f"({eng.spec_accepted}/{eng.spec_drafted} drafts, "
              f"spec_k={args.spec_k}, draft depth "
              f"{eng.draft_cfg.num_layers}/{cfg.num_layers})")


if __name__ == "__main__":
    main()
