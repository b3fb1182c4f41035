#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py              # on a machine with a CUDA card
    python3 chip_smoke.py --rehearse   # CPU rehearsal: reduced models (MLP
                                       # hidden 64), the kernels' plain
                                       # versions, no result line
    python3 chip_smoke.py --phase dist # the card phase (the build) and
                                       # phase 13 alone, no result line

Phases, each printing one JSON line:

1. card      the card's name and power limit (nvidia-smi), torch/CUDA
             versions, the kernels' build time (one nvcc per source, all at
             once, for sm_90a). TF32 is switched off for fp32 products.
2. parity    every CUDA kernel against its plain PyTorch version at the
             main paths' shapes, in bf16 and fp32 (int8 KV for attention;
             attn_prefill at the buckets T = 16, 64 and 256 and at the
             speculative verify shape T = 5 against a 512-entry cache with
             ragged hi = valid, a row without a valid key, the fp32
             kernel with fp32 and int8 K/V; attn_decode also at B = 16 and
             S = 2048; qmatvec at M = 8, 512 and, for the d_ff shapes,
             2048; qmatmul for the tied readout, both MLP heads and the q
             form's four projections (row-major int8 levels, the QKV bias
             on wq / wk / wv) at M = 8, 512 and 2048 in bf16 and fp32 x,
             each gated to n_lanes in the variant its plan gives (decode
             for M <= 16, else prefill), against addmm on the dequantized
             matrix; for the dense family both attention kernels at
             stablelm-3b's head_dim 80, MHA, B = 8, S = T = 256 / 512, in
             bf16, int8 K/V and fp32, bf16 prefill at head_dim 32 and 256,
             qmatvec at the widest decode projections and the untied 8-bit
             heads of stablelm-3b, qwen2.5-14b and qwen3-32b stored
             K-major; for the ssm phase qmatvec at every projection of
             mamba2-2.7b and zamba2-1.2b at M = 8 and 2048, their tied
             readouts, and both attention kernels at zamba2's shared
             block, MHA, D = 64, with the verify shape), each case naming
             the variant, layout or kernel it
             took and gated that it is the one its plan gives (qmatvec:
             decode for M <= 16, else prefill; qmatmul: k_lanes / n_lanes;
             attn_prefill: wgmma for bf16 queries, simt for fp32), and
             qmatvec, attn_decode, the q-form qmatmul and the fp32
             attn_prefill run twice for the same bits:
             max abs error against the tolerance, held row by row (fp32:
             1e-4 x the row's max|ref|; bf16: 2e-2 x the row's max|ref|, the
             sums run in another order; a row is one output vector of a
             matmul, one query of attention), and the
             median CUDA-event ms of one call of the kernel, the plain
             version and one PyTorch library call computing the same
             function (host time included where the call is shorter than
             its launch), beside the device ms of one call of the kernel
             and of the library call from torch.profiler. The PLAN
             sigmoid (forward and backward) must be bit-identical, NaN where
             the plain version has NaN; its library column is torch.sigmoid
             (the same bytes, not the same function).
3. engine    full-width qwen2-1.5b, fp32 master weights from a seeded
             generator on the card, exported to W3A8 containers on the
             card, served by ServingEngine(slots=8, max_len=512, bf16) for
             16 requests x 32 new tokens, once with a bf16 KV cache and once
             with kv_bits=8: the engine replaying its tick and admissions as
             CUDA graphs, and its capture=False twin. Every timed engine
             (here and in the spec phase) first served the same requests
             for WARM_NEW tokens, so tok/s are compared warm and the
             captured engine's timed serve is replay only (gated: no
             capture in it). The twins must serve identical tokens. Launch
             counters (a replay adds the launches its capture recorded) are
             zeroed just before each timed run
             and read just after: every kernel of the path must have
             launched, no plain version may have run, every readout must
             have taken qmatmul's k_lanes layout, every admission the
             wgmma attn_prefill, and every qmatvec launch the variant its
             plan gives for its M (ticks decode, admissions prefill); the
             twins' counts must agree. Then each twin's steady tick (8
             slots active): host ms over STEADY_TICKS ticks, and device ms by
             kernel and the card's idle share over PROFILED_TICKS more under
             torch.profiler, which must name qmatvec, qmatmul and attn_decode
             in the captured engine's replayed ticks.
   q engine  the same fp32 master's export_levels (int8 levels at full
             shape, 1.31 GB of projections and the 233 MB embedding, made
             on the card) served by ServingEngine(slots=8, max_len=512,
             bf16, bf16 KV) captured and as its capture=False twin on the
             engine phase's requests: identical tokens, the timed serve
             replay only, the same launches in both twins; every
             projection in qmatmul's n_lanes layout in the variant its
             plan gives (ticks decode, admissions prefill), every readout
             k_lanes, every admission the wgmma attn_prefill, no qmatvec
             and no plain version; each twin's steady tick, the profiler
             naming qmatmul and attn_decode; then phase 4's path check on
             the q export. The export is freed before the next phase.
   quarantine the captured qp engine and its eager twin under a FaultPlan
             putting NaN in slot 3's logits at tick 2 (8 requests x 8
             tokens): one request "poisoned" with the tokens it had, seven
             "ok", poisoned_count 1, the twins identical.
4. path      prefill + 4 decode steps at full width in fp32 activations
             (no activation quant) with all kernels, then with the plain
             paths (matmul_mode="dequant", attn_mode="ref") on the same
             weights: logits must agree (max |diff| <= 2e-3 x max |logit|).
5. spec      self-speculative serving at full width: the same seeded fp32
             master, its weights cast once to bf16, is the target (FLOAT
             policy); its W3A8 container export (api.draft_of) drafts
             spec_k = 4 tokens a tick. ServingEngine(slots=8, max_len=512,
             bf16, spec_k=4) serves the engine phase's 16 requests x 32
             tokens, captured and as its capture=False twin (identical
             tokens): every request gets its tokens, all four serving kernels
             launched exactly as often as the tick's structure fixes (each
             tick: L verify attn_prefill, (spec_k + 1) x L attn_decode and
             7 L qmatvec decode, spec_k + 1 readouts; each admission round:
             target and drafter prefill), no plain version ran, every
             attn_prefill took wgmma, every readout k_lanes and every
             qmatvec the variant its plan gives. Prints tok/s, ticks,
             tokens per tick, the accept rate and histogram beside a plain
             spec_k=0 engine on the same target and the qp engine phase,
             and the share of requests whose bf16 stream matches the plain
             engine's (not gated: verify and decode round in different
             orders), and each twin's steady tick, the profiler naming all
             four serving kernels in the replayed spec ticks. Then the fp32
             gate: generate(spec_k=4) on the fp32 master must be
             token-identical to greedy generate (8 prompts x 16 new tokens,
             TF32 off, every attn_prefill on simt); on a mismatch it prints
             the top-2 logit margin where they part. The captured fp32 spec
             engine must serve greedy's tokens, and the captured fp32 plain
             engine its capture=False twin's.
6. paper     the paper's 3-step experiment (RBM pretraining, float SGD,
             3-bit quantization, STE retraining, packed check) for the digit
             net at full width 784-1022-1022-1022-10, batch 100, lr 0.1,
             momentum 0.9; the only cut is the epoch counts (1 / 3 / 2);
             the training steps and evaluations as CUDA graphs, after an
             eager twin run (capture=False). Fails on a non-finite loss,
             float MCR >= 35%, packed max err >= 1e-4, a packed/float
             weight ratio <= 8, MCRs or final losses that differ between
             the twins, or other than one capture per training run.
7. deploy    the retrained digit net and a seeded full-width phoneme net
             (429-1022x4-61), exported with export_container(W3A8) and run by
             dnn.forward(..., sigmoid_mode="pw") at batch 100 / 128: each
             forward must launch qmatvec once per hidden layer (its
             prefill kernel), qmatmul once (the head, in the k_lanes
             layout) and sigmoid_pw once per
             hidden layer, with no plain version;
             each layer must agree with its CPU plain version fed the same
             input (8-bit signals off; 1e-4 x the row's max, sigmoid_pw bit
             for bit) and dnn.forward with that chain bit for bit; end to
             end against the CPU, the logits must agree within 1e-4 x
             max|logit| but for a few rows, by no more than PLAN's 1/256
             jump at |x| = 2.375 can move them, with greedy agreement
             >= 0.99 (8-bit signals off) and all but a few rows' argmax
             equal (on). Prints the deployed test MCR and images/s of the
             W3A8 kernel forward and of the float net, batch 100.
8. dense     the rest of the dense family at full width: stablelm-3b at
             full depth (32 layers, head_dim 80, MHA, untied head),
             qwen2.5-14b (G = 5, QKV bias) and qwen3-32b (qk-norm) cut to
             8 layers (the fp32 master the export is made from must fit
             the card), and the audio / vlm decoders musicgen-large at
             full depth (48 layers, gelu MLP, MHA) and internvl2-26b cut
             to 8 of 48 layers, each from a seeded generator, exported to W3A8
             containers, served for 8 requests (prompts 3-16 and
             100-250) x 16 new tokens by ServingEngine(slots=8,
             max_len=512, bf16) captured and as its capture=False twin:
             identical tokens, the timed serve replay only, every kernel
             launched in the variant its plan gives (the untied head's
             readout in qmatmul's k_lanes layout, every admission the
             wgmma attn_prefill), the same launches in both twins; each
             twin's steady tick; then the path check of phase 4 on the
             model. Each model is freed before the next.
9. moe       the MoE family and the sliding-window KV ring at full width:
             phi3.5-moe (16 experts, top-2) cut to 8 of 32 layers and
             mixtral-8x22b (8 experts, top-2, window 4096) cut to 4 of 56
             (the fp32 master the export is made from must fit the card),
             each from a seeded generator on the card (its layers drawn
             into preallocated stacks), exported to W3A8 containers (the
             expert stacks as int8 levels, quantised a layer at a time),
             the master freed, served by ServingEngine(slots=8, bf16, kv
             bf16) captured and as its capture=False twin: phi3.5-moe 8
             requests x 16 tokens at max_len 512; mixtral at max_len 8192
             (a 4096-slot ring) four short prompts, a 4060-token prompt
             admitted in the 4096 bucket that decodes 100 tokens (past
             slot 4095: the ring wraps) and a 4500-token prompt admitted
             solo through the windowed attn_prefill and the ring roll.
             Gated: identical tokens, replay only, per forward L routers in
             qmatmul's row-major k_lanes, one readout K-major, 3 E L expert
             products in n_lanes in the variant their capacity M plans,
             4 L qmatvec in the variant the forward's tokens plan, no plain
             version, the same launches in both twins; for mixtral a solo
             admission and a slot past the ring. Each twin's steady tick;
             the build's seconds and peak GB; then the MoE path check
             (8 prompts filling a 64-token bucket + 4 decode steps in
             fp32, kernels against plain versions: routing first, a flip
             accepted only where the probabilities at stake differ by
             < 1e-5 and reported; logits within 2e-3 x max|logit|). The
             parity phase holds every kernel at these shapes (expert
             products at a tick's, an admission's and the solo prompt's
             capacity M, the routers, the windowed attn_prefill at
             T = 4500, attn_decode over a full 4096-slot ring).
10. ssm      the state-space and hybrid families at full width and
             depth: mamba2-2.7b (64 layers) and zamba2-1.2b (38 mamba
             blocks, 6 applications of its shared attention block, a
             2-block tail), seeded fp32 masters exported to W3A8 `qp`,
             each served by ServingEngine(slots=8, max_len=512, bf16) for
             the dense phase's 8 requests x 16 tokens captured and as its
             capture=False twin (zamba2 also with an int8 KV cache):
             identical tokens, replay only, the same launches in both
             twins, and launches gated per forward from each serve's
             ticks and admission rounds: every projection in qmatvec
             (ticks decode, admissions prefill), one readout in qmatmul's
             k_lanes, per shared-block application one attn_decode on a
             tick and one wgmma attn_prefill on an admission (none for
             mamba2), no plain version; each twin's steady tick; the path
             check. Then for zamba2: speculative serving (the float
             master, bf16 weights, verifying its qp drafter, spec_k 4,
             captured and eager, the spec phase's gates), the fp32 gate
             (spec generate and the captured fp32 spec engine
             token-identical to greedy, the captured fp32 plain engine to
             its eager twin), and under capture the fp32 master with
             preempt_after 4 (12 requests: tokens of the undisturbed
             engine) and the qp engine snapshotted at tick 8 and restored
             into a fresh engine (tokens of the uninterrupted run).
11. resilience overload hardening and durability on the full-width
             qwen2-1.5b of phases 3 and 5 (its qp export and fp32 master,
             parked on the host during phases 6-8), every engine
             ServingEngine(slots=8, max_len=512), every case captured and
             as its capture=False twin under the same FaultPlan, the twins
             gated equal in tokens, statuses, counters, fallback_events and
             launches net of the graphs' warm-ups; no degradation-ladder
             step outside the ladder case, no plain version outside it.
             (1) bounded admission: 24 requests in two waves into
             queue_limit=8, "reject" and "drop_oldest": outcomes, shed
             uids, shed_count, queue_peak as the host predicts them;
             (2) deadlines and preemption, qp bf16 (default_deadline 40,
             preempt_after 8, admission delayed at ticks 8 and 9: "ok" and
             "deadline" both, counters matching), and the fp32 master
             (preempt_after 4: the tokens of the undisturbed engine);
             (3) the ladder: the fp32 spec engine (spec_k 4) failing at
             ticks 2 and 5 walks spec -> plain -> plain versions, the
             graphs captured again (tick captures 2, then 3), the four
             serving kernels before tick 5 and only plain versions after,
             tokens equal to greedy generate (top-2 margin on a mismatch);
             (4) the watchdog: run_all(max_ticks=3) on 16 requests raises
             WatchdogExpired naming the queue and the slots, the finished
             requests drain; (5) durability: qp bf16 snapshot_every=8 and
             a journal, a fresh engine restored from the tick-8 snapshot
             continues as the uninterrupted run (snapshot bytes and ms,
             restore ms); the fp32 master crashed at ticks 5 and 11 and
             recovered on a fresh engine: the drains before the crash and
             the recovered output make the uncrashed run, shed, deadline
             and poisoned requests staying dead; (6) integrity: a flipped
             sign bit of a served 3-bit field (layer 0's down projection)
             at tick 6, integrity_every=4 and golden_dir: one heal at tick
             8, the manifest clean, every request served; on the fp32
             master (a mantissa bit) the clean run's tokens; with no probe
             the flip changes the K/V that the next replayed tick writes
             (layers 1 and up) against a clean engine's; the probe's ms
             beside its bound.
12. train    LM training (run after phase 10 and before 11, while phase
             11's weights are parked on the host), every step a CUDA graph
             captured once and replayed, beside its capture=False twin
             built anew from the same seed: (a) qwen2-1.5b at full width
             and depth (1.54 B parameters) under W3A8 with frozen
             fit_deltas_stacked deltas, AdamW, warmup_cosine, clip 1.0,
             remat layer, bf16 compute over fp32 masters, TRAIN_STEPS
             steps of lm_batch 8 x 256: losses, gnorm and lr of the twins
             equal bit for bit, finite, the lr different at every replay,
             the last 4 losses' average below the first 4's; ms a step
             captured and eager, tokens/s, peak GB, the share of the (6 +
             2) x params x tokens bound at 989 TFLOP/s; (b) the 100M config
             of launch/train_lm_100m.py trained float and W3A8 (deltas
             refitted every step) for TRAIN_100M_STEPS captured steps each
             (first and last losses), the W3A8-trained master exported to
             containers and served by ServingEngine(slots=8, greedy)
             captured and eager on prompts of the stream: identical tokens,
             the engine phase's launch gates (qmatvec, the k_lanes
             readout, attn_decode, attn_prefill), the path check within
             2e-3 x max|logit|, and the share of served transitions inside
             the stream's window beside chance (1/16, not gated); (c) one
             W3A8 step of phi3.5-moe (1 of 32 layers), mamba2-2.7b (32 of
             64) and zamba2-1.2b (full) at full width: finite, loss and
             gnorm of the twins equal bit for bit, peak GB.
13. dist     the distributed layer (run after phase 12): a one-process
             NCCL group and a (1, 1) (data, model) mesh (make_host_mesh;
             every placement Replicate on its size-1 dims). (a) The train
             cell of launch/steps.build_cell, qwen2-1.5b at full width and
             depth, W3A8 frozen deltas, state placed by state_specs,
             captured, DIST_TRAIN_STEPS steps of lm_batch 8 x 256 beside
             the same steps of training.loop without a mesh: losses,
             gnorms and lrs equal bit for bit; then DIST_COMPRESSED_STEPS
             eager steps with the int8 gradient compressor as
             grad_transform (finite losses), and the compressor's levels,
             scale and residual on the card equal to the CPU's bit for bit
             on every leaf of the last step's gradients. (b) The decode
             cell (qp export, 8 rows, a 4096-entry bf16 cache with 4000
             entries filled, 16 steps) and (c) the prefill cell (q export,
             8 x 512) equal transformer.decode_step / prefill without a
             mesh bit for bit, logits and caches; the launches of the
             cells alone: qmatvec, qmatmul's k_lanes and n_lanes,
             attn_decode and attn_prefill all above 0, no plain version.
             (d) The train state's params, step and deltas saved and
             restored with checkpoint.restore(shardings=): every leaf
             bit-identical on the asked placements. (e) pipeline_apply
             over a one-rank stage mesh: the forward bit for bit, the
             gradient within 1e-6 x max|grad| of each microbatch through
             the stage. Prints ms a step and tokens/s beside the
             one-device step, the decode and prefill cells' ms beside the
             one-device calls, peak GB.
14. analysis the contract linter and the dry run (run after phase 11):
             (a) the contract sweep (repro_torch.analysis, 4
             families x 2 forms x 2 modes on fake "cuda" tensors, one
             subprocess a family): 0 violations; (b) the qp engine's
             decode tick and one bucket-256 admission at full width traced
             on fake tensors: their kernel ops by name and variant equal
             the launch counters of the same calls run eagerly (tick: 7 x
             28 qmatvec decode, 28 attn_decode, 1 k_lanes; admission: 7 x
             28 qmatvec prefill, 28 wgmma attn_prefill, 1 k_lanes); (c)
             the on-chip table, one launch of every kernel route at its
             main shape: dynamic and static shared bytes, registers and
             spills (ptxas), blocks per SM by shared memory; every
             function within 227 KiB, every static size equal to ptxas's;
             (d) --exercise's capture budgets (a reduced spec engine on
             the card: the tick and its bucket captured once); (e)
             launch/dryrun.py's qwen2-1.5b decode_32k and train_4k on the
             fake 16 x 16 mesh (subprocesses): status ok, collectives and
             peak estimate printed; the dist phase's train cell dry-run on
             a (1, 1) mesh: its peak estimate beside the peak the dist
             phase measured. Then the script's seconds.
15. kernels  the per-kernel summary line (one entry per TPU kernel; qmatvec,
             qmatmul and attn_prefill add their launches by variant /
             layout / kernel on each path; then one entry for each of
             qmatmul's n_lanes and the fp32 attn_prefill, with their
             launches on the q engine and in the resilience phase's fp32
             engines and every shape the parity phase held them at),
             then the card line as
             nvidia-smi prints it, then the result line
             {"ok": true, "device": {"platform": "gpu", ...}}.

Any failure raises and exits non-zero without a result line; so does a run
without a CUDA card (unless --rehearse), or a directory without the port.
"""
from __future__ import annotations

import argparse
import itertools
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12                   # H100 SXM device memory rate
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}   # fp32 non-tensor, bf16 TC
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
KERNEL_META = {
    "qmatvec": ("src/repro_torch/csrc/qmatvec.cu",
                "src/repro/kernels/qmatvec/kernel.py:70"),
    "qmatmul": ("src/repro_torch/csrc/qmatmul.cu",
                "src/repro/kernels/qmatmul/kernel.py:50"),
    "attn_decode": ("src/repro_torch/csrc/attn_decode.cu",
                    "src/repro/kernels/attn_decode/kernel.py:116"),
    "attn_prefill": ("src/repro_torch/csrc/attn_prefill_tc.cu",
                     "src/repro/kernels/attn_prefill/kernel.py:124"),
    "sigmoid_pw": ("src/repro_torch/csrc/sigmoid_pw.cu",
                   "src/repro/kernels/sigmoid_pw/kernel.py:28"),
}
ENGINE_KERNELS = ("qmatvec", "qmatmul", "attn_decode", "attn_prefill")
# kernels with more than one CUDA kernel or layout behind one wrapper: the
# counter that splits their launches, and the source of each variant
VARIANTS = {
    "qmatvec": ("launches_by_variant",
                {"decode": "src/repro_torch/csrc/qmatvec.cu",
                 "prefill": "src/repro_torch/csrc/qmatvec.cu"}),
    "qmatmul": ("launches_by_layout",
                {"k_lanes": "src/repro_torch/csrc/qmatmul.cu",
                 "n_lanes": "src/repro_torch/csrc/qmatmul.cu"}),
    "attn_prefill": ("launches_by_variant",
                     {"wgmma": "src/repro_torch/csrc/attn_prefill_tc.cu",
                      "simt": "src/repro_torch/csrc/attn_prefill.cu"}),
}
# qmatmul's n_lanes launches by variant (decode for M <= 16, prefill above),
# read beside its layouts as "qmatmul/n_lanes"
N_LANES = "qmatmul/n_lanes"
# qmatmul's k_lanes launches by W's orientation (k_major: the readouts;
# row_major: the MLP heads and the MoE routers), read as "qmatmul/k_lanes"
K_LANES = "qmatmul/k_lanes"
# the fp32 attn_prefill's second kernel (the merge of a split of S), read
# as "attn_prefill/merge": {"merge": launches}
SIMT_MERGE = "attn_prefill/merge"
# kernel routes with an entry of their own in the kernels summary, beside
# their kernel's headline entry (n_lanes at M = 8, N = d_ff, bf16; simt at
# the largest bucket, fp32 K/V): (kernel, variant, source)
ROUTES = (("qmatmul", "n_lanes", "src/repro_torch/csrc/qmatmul.cu"),
          ("attn_prefill", "simt", "src/repro_torch/csrc/attn_prefill.cu"))
# the M at which the parity phase holds the q form's projections: decode,
# an admission (8 slots x bucket 64) and the largest admission
Q_MS = (8, 512, 2048)
PAPER_EPOCHS = dict(pretrain_epochs=1, float_epochs=3, retrain_epochs=2)
# the dense phase: (arch, layers kept on the card or None for all, the CPU
# rehearsal's reduced() sizes); the depth cut keeps the fp32 master and its
# stacked copy within the card's 80 GB (qwen3-32b's 8 layers: 15.6 GB, plus
# 6.2 GB of embedding and head)
DENSE = (("stablelm-3b", None, dict(d_model=320)),
         ("qwen2.5-14b", 8, {}),
         ("qwen3-32b", 8, {}),
         ("musicgen-large", None, {}),
         ("internvl2-26b", 8, {}))
DENSE_PROMPTS = (0, 3, 4, 5, 8, 9, 10, 11)   # prompts 4, 12, 3, 16, 100-250
DENSE_NEW = 16
# the moe phase: (arch, layers kept on the card, engine max_len); the depth
# cut keeps each fp32 master (phi3.5-moe 8 layers: 42 GB; mixtral 4: 41 GB)
# and its export within the card's 80 GB
MOE = (("phi3.5-moe-42b-a6.6b", 8, 512), ("mixtral-8x22b", 4, 8192))
MOE_NEW = 16
MOE_BUCKET = 64            # the admission round the parity phase holds
# mixtral's long requests (prompt tokens, new tokens): one admitted in the
# 4096 bucket that decodes past slot 4095 (the ring wraps), one past the
# bucket cap, admitted solo through the windowed attn_prefill
MOE_WRAP = (4060, 100)
MOE_SOLO = (4500, MOE_NEW)
# the parity phase's MoE shapes: (arch, T of the windowed attn_prefill)
MOE_PARITY = (("phi3.5-moe-42b-a6.6b", 0), ("mixtral-8x22b", MOE_SOLO[0]))
MOE_PATH_STEPS = 4         # decode steps of the MoE path check
# the ssm phase: (arch, the CPU rehearsal's reduced() sizes), both served
# at full width and depth (mamba2-2.7b's fp32 master: 10.8 GB)
SSM = (("mamba2-2.7b", dict(layers=2)), ("zamba2-1.2b", dict(layers=5)))
SSM_ARCHS = tuple(a for a, _ in SSM)
SSM_NEW = 16
SSM_PREEMPT = 4            # preempt_after of the hybrid's resilience case
SSM_SNAPSHOT_TICK = 8      # the tick its snapshot is taken at
SPEC_K = 4                                  # drafts a speculative tick
SPEC_GATE = dict(prompts=8, prompt_len=16, max_new=16)   # fp32 identity gate
WARM_NEW = 2 * (SPEC_K + 1)     # new tokens a request of a warm-up serve
STEADY_TICKS = 10               # host-timed steady ticks a steady measurement
PROFILED_TICKS = 4              # and then ticks under the profiler
SPECIAL = [0.0, -0.0, 1.0, -1.0, 2.375, -2.375, 5.0, -5.0, 0.99999994,
           -1.0000001, 2.3749998, 4.9999995, -5.0000005, 1e-40, -1e-40,
           float("inf"), float("-inf"), float("nan")]


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


class Clock:
    """Median ms of a callable: CUDA events on the card, the host clock in
    the CPU rehearsal (whose numbers are not device times)."""

    def __init__(self, device, reps: int):
        self.device, self.reps = device, reps

    def __call__(self, fn) -> float:
        import torch
        fn()
        if self.device.type != "cuda":
            ts = []
            for _ in range(self.reps):
                t0 = time.perf_counter()
                fn()
                ts.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(ts)
        torch.cuda.synchronize()
        evs = []
        for _ in range(self.reps):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            evs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in evs)

    def device_ms(self, fn):
        """Device ms of one call of ``fn``: the self time of every kernel,
        copy and set it runs on the card, from torch.profiler, averaged over
        ``reps`` calls. Free of the host's time, which a CUDA-event timing
        of one small call is not. A session that records no device activity
        at all (a short one sometimes does) is run again, up to three
        times, and then reported as None; so is the CPU rehearsal."""
        import torch
        from repro_torch.launch.profile_engine import device_ms_by_kernel
        if self.device.type != "cuda":
            return None
        fn()
        torch.cuda.synchronize()
        for _ in range(3):
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(self.reps):
                    fn()
                torch.cuda.synchronize()
            total = sum(device_ms_by_kernel(prof).values())
            if total > 0:
                return total / self.reps
        return None


def bound_ms(nbytes: float, ops: float, dtype: str):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / PEAK_OPS[dtype] * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


def tc_bound_ms(nbytes: float, ops: float, dtype: str):
    """The bound of a kernel whose products run on the tensor cores in
    bf16 (qmatvec, qmatmul's n_lanes and K-contiguous k_lanes): fp32 x
    enters as three bf16 planes, so it does three times the products at
    the bf16 tensor-core peak, never fp32 CUDA-core work."""
    return bound_ms(nbytes, ops * (3 if dtype == "float32" else 1),
                    "bfloat16")


def compare(got, ref, dtype: str, what: str, row_dims: int = 1) -> float:
    """Max abs error of ``got`` against ``ref``. Each row (an index into the
    first ``row_dims`` axes) is held to TOL x its own max|ref|, so rows of
    small outputs are not judged by the scale of large ones; a row whose
    ref is all zeros must come out exactly zero."""
    if not bool(got.float().isfinite().all()):
        fail(f"{what}: non-finite kernel output")
    diff = (got.float() - ref.float()).abs().flatten(row_dims).amax(-1)
    scale = ref.float().abs().flatten(row_dims).amax(-1)
    bad = (~(diff <= TOL[dtype] * scale)).flatten().nonzero()
    if bad.numel():
        i = int(bad[0, 0])
        fail(f"{what}: row {i}: kernel vs plain max abs err "
             f"{float(diff.flatten()[i])} exceeds {TOL[dtype]} x the row's "
             f"max|ref| ({float(scale.flatten()[i])})")
    return float(diff.max())


def same_bits(fn, what: str):
    """``fn()`` twice: the two outputs must be the same bits (the kernels
    sum in a fixed order, with no atomics). Returns the first."""
    import torch
    a, b = fn(), fn()
    if a.is_cuda and not torch.equal(a, b):
        fail(f"{what}: two runs differ (max "
             f"{float((a.float() - b.float()).abs().max())})")
    return a


def compare_exact(got, ref, what: str) -> float:
    """0.0 if ``got`` has ``ref``'s values bit for bit (NaN exactly where
    ``ref`` has NaN, zeros of the same sign), else fail."""
    import torch
    nan = torch.isnan(ref)
    if got.dtype != ref.dtype or got.shape != ref.shape \
            or not torch.equal(torch.isnan(got), nan) \
            or not torch.equal(got[~nan], ref[~nan]) \
            or not torch.equal(torch.signbit(got[~nan]), torch.signbit(ref[~nan])):
        d = (got.float() - ref.float()).abs()
        fail(f"{what}: kernel differs from the plain version (tolerance 0; "
             f"max abs err {float(d[~nan].max()) if (~nan).any() else 'n/a'})")
    return 0.0


# --- phase 1 ----------------------------------------------------------------------

def card_phase(device, rehearse: bool):
    import torch
    from repro_torch.analysis.smem import ptxas_summary
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = {"phase": "card", "torch": torch.__version__,
            "cuda": torch.version.cuda, "allow_tf32": False}
    from repro_torch.launch.profile_engine import card_line
    smi = "not measured (CPU rehearsal)"
    if not rehearse:
        smi = card_line()
        info["device_name"] = torch.cuda.get_device_name(0)
        t0 = time.perf_counter()
        secs = _build.build()
        info["build_s"] = round(time.perf_counter() - t0, 3)
        info["nvcc_s"] = {k: round(v, 3) for k, v in secs.items()}
        info["ptxas"] = {k: ptxas_summary(v)
                         for k, v in _build.build_log.items()}
    info["nvidia_smi"] = smi
    emit(info)
    return smi


# --- phase 2 ----------------------------------------------------------------------

def _kernel_cases(cfg, device, clock):
    """Yield one dict per (kernel, shape, dtype) case."""
    import torch

    g = torch.Generator(device=device).manual_seed(1234)
    d, hd = cfg.d_model, cfg.head_dim
    h, kvh = cfg.num_heads, cfg.num_kv_heads
    dts = [("bfloat16", torch.bfloat16), ("float32", torch.float32)]

    # qmatvec: the 7 projection shapes (4 distinct) at decode and prefill
    # M, and the largest admission (8 slots x the 256 bucket) at the d_ff
    # ones in bf16
    proj = ((d, h * hd), (d, kvh * hd), (d, cfg.d_ff), (cfg.d_ff, d))
    qmv = [(m, k, n, dn, dt) for k, n in proj for m in (8, 8 * 64)
           for dn, dt in dts]
    qmv += [(8 * 256, k, n, "bfloat16", torch.bfloat16) for k, n in proj
            if cfg.d_ff in (k, n)]
    for m, k, n, dname, dt in qmv:
        yield _qmatvec_case(g, device, clock, m, k, n, dname, dt,
                            headline=(m == 8 and n == cfg.d_ff
                                      and dname == "bfloat16"))

    # qmatmul: the tied readout, (slots, D) x (D, V) as the transposed view
    for dname, dt in dts:
        yield _readout_case(g, device, d, cfg.vocab_size, dname, dt,
                            headline=dname == "bfloat16")

    # qmatmul n_lanes: the q form's projections (row-major int8 levels;
    # qwen2's QKV bias on wq / wk / wv) at decode M, an admission's M and
    # the largest admission, in bf16 and fp32 x
    qproj = ((d, h * hd, cfg.qkv_bias), (d, kvh * hd, cfg.qkv_bias),
             (d, cfg.d_ff, False), (cfg.d_ff, d, False))
    for m in Q_MS:
        for k, n, bias in qproj:
            for dname, dt in dts:
                c = _q_proj_case(g, device, m, k, n, bias, dname, dt)
                c["summary_headline"] = (m == 8 and n == cfg.d_ff
                                         and dname == "bfloat16")
                yield c

    # attn_decode: 8 slots, S = 512, ragged lengths with one empty row, in
    # every cache form; then 16 slots, and a 2048-token cache
    decode_cases = [(8, 512, kvn, dn, dt_) for kvn, dn, dt_ in (
        ("bf16", "bfloat16", torch.bfloat16),
        ("int8", "bfloat16", torch.bfloat16),
        ("fp32", "float32", torch.float32),
        ("int8", "float32", torch.float32))]
    decode_cases += [(16, 512, "bf16", "bfloat16", torch.bfloat16),
                     (8, 2048, "bf16", "bfloat16", torch.bfloat16)]
    for b, s, kvname, dname, dt in decode_cases:
        yield _decode_case(g, device, b, s, h, kvh, hd, kvname, dname, dt,
                           headline=(b == 8 and s == 512 and kvname == "bf16"
                                     and dname == "bfloat16"))

    # attn_prefill: B = 8, T = S in {16, 64, 256} (the smallest bucket, a
    # middle one, the largest the engine admits), ragged lengths,
    # hi = min(t + 1, len); bf16 and fp32 q with a K/V of their dtype, and
    # bf16 q with an int8 K/V (the library yardstick then attends over the
    # dequantized K/V, as for attn_decode)
    for t in (16, 64, 256):
        kinds = [("bf16", "bfloat16", torch.bfloat16),
                 ("fp32", "float32", torch.float32)]
        if t >= 64:
            kinds.append(("int8", "bfloat16", torch.bfloat16))
        if t == 256:                     # the simt kernel's int8 K/V
            kinds.append(("int8", "float32", torch.float32))
        for kvname, dname, dt in kinds:
            c = _prefill_case(g, device, t, h, kvh, hd, kvname, dname, dt,
                              headline=(t == 256 and kvname == "bf16"))
            c["summary_headline"] = t == 256 and kvname == "fp32"
            yield c

    # attn_prefill at the speculative verify shape: T = spec_k + 1 = 5
    # queries of each of 8 slots against the whole 512-entry decode cache,
    # hi = valid, the cache lengths spread over 0..S-T (row 0 at 0); row 1
    # has no valid key at all and must come out as exact zeros
    for kvname, dname, dt in (("bf16", "bfloat16", torch.bfloat16),
                              ("int8", "bfloat16", torch.bfloat16),
                              ("fp32", "float32", torch.float32),
                              ("int8", "float32", torch.float32)):
        yield _verify_case(g, device, cfg, kvname, dname, dt)


def _readout_case(g, device, d, vocab, dname, dt, headline=False,
                  label=""):
    """The tied readout: (8 slots, D) against the (V, D) int8 table read
    as its transposed view, in qmatmul's k_lanes layout."""
    import torch
    from repro_torch.kernels.qmatmul import ops as qmm_ops
    from repro_torch.kernels.qmatmul.ref import qmatmul_ref
    table = torch.randint(-127, 128, (vocab, d), generator=g, device=device,
                          dtype=torch.int8)
    hs = torch.randn((8, d), generator=g, device=device).to(dt)
    got, layout = launched_variant(
        "qmatmul", lambda: qmm_ops.qmatmul(hs, table.T, 1.0), "k_lanes")
    ref = qmatmul_ref(hs, table.T, 1.0)
    tdq = table.to(dt)
    xb = hs.element_size()
    nbytes = 8 * d * xb + table.numel() + vocab * 4 + 8 * vocab * xb
    return dict(
        name="qmatmul", shape=f"M=8 K={d} N={vocab} (q.T view{label})",
        dtype=dname, variant=layout,
        err=compare(got, ref, dname, f"qmatmul {dname}{label}"),
        run=(lambda: qmm_ops.qmatmul(hs, table.T, 1.0)),
        plain=(lambda: qmatmul_ref(hs, table.T, 1.0)),
        library=(lambda: torch.matmul(hs, tdq.T)),
        bound=tc_bound_ms(nbytes, 2 * 8 * d * vocab, dname),
        headline=headline)


def _kv(g, device, b, s, kvh, hd, kvname, dt):
    """A (b, s, kvh, hd) K and V in ``dt``, or int8 with per-token scales;
    and the K/V in ``dt`` that the library yardstick attends over."""
    import torch
    if kvname == "int8":
        k_ = torch.randint(-127, 128, (b, s, kvh, hd), generator=g,
                           device=device, dtype=torch.int8)
        v_ = torch.randint(-127, 128, (b, s, kvh, hd), generator=g,
                           device=device, dtype=torch.int8)
        ks = torch.rand((b, s), generator=g, device=device) * 0.02
        vs = torch.rand((b, s), generator=g, device=device) * 0.02
        return (k_, v_, ks, vs, (k_.float() * ks[..., None, None]).to(dt),
                (v_.float() * vs[..., None, None]).to(dt))
    k_ = torch.randn((b, s, kvh, hd), generator=g, device=device).to(dt)
    v_ = torch.randn((b, s, kvh, hd), generator=g, device=device).to(dt)
    return k_, v_, None, None, k_, v_


def _decode_case(g, device, b, s, h, kvh, hd, kvname, dname, dt,
                 headline=False):
    """attn_decode of b slots against an s-entry cache, ragged lengths with
    one empty row (exact zeros), two runs the same bits."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.attn_decode import kernel as dec_k
    from repro_torch.kernels.attn_decode import ops as dec_ops
    from repro_torch.kernels.attn_decode.ref import attn_decode_ref
    grp = h // kvh
    base = [0, 1, 37, 128, 200, 333, s - 1, s]
    lens = torch.tensor([min(base[i % 8] + 64 * (i // 8), s)
                         for i in range(b)], dtype=torch.int32,
                        device=device)
    q = torch.randn((b, 1, h, hd), generator=g, device=device).to(dt)
    kc, vc, ks, vs, kl, vl = _kv(g, device, b, s, kvh, hd, kvname, dt)
    what = f"attn_decode B={b} S={s} KV={kvh} D={hd} {dname} kv-{kvname}"
    got = same_bits(lambda: dec_ops.attn_decode(q, kc, vc, lens, ks, vs),
                    what)
    ref = attn_decode_ref(q, kc, vc, lens, ks, vs)
    if bool((got[lens == 0] != 0).any()):
        fail(f"{what}: an empty row is not exactly zero")
    # library yardstick: SDPA over the (dequantized) cache, KV heads
    # expanded to the query heads beforehand
    qs = q.transpose(1, 2)
    kh = kl.transpose(1, 2).repeat_interleave(grp, dim=1)
    vh = vl.transpose(1, 2).repeat_interleave(grp, dim=1)
    mask = (torch.arange(s, device=device)[None, :]
            < lens[:, None])[:, None, None, :]
    tot = int(lens.sum())
    eb = kc.element_size()
    nbytes = (2 * b * h * hd * q.element_size() + 2 * tot * kvh * hd * eb
              + (2 * tot * 4 if ks is not None else 0) + b * 4)
    return dict(
        name="attn_decode", shape=f"B={b} S={s} KV={kvh} G={grp} D={hd} "
                                  f"lens ragged (one 0)",
        dtype=f"{dname}/kv-{kvname}",
        splits=dec_k.plan(b, s, kvh, grp, hd, kc.dtype).splits,
        err=compare(got, ref, dname, what),
        run=(lambda: dec_ops.attn_decode(q, kc, vc, lens, ks, vs)),
        plain=(lambda: attn_decode_ref(q, kc, vc, lens, ks, vs)),
        library=(lambda: F.scaled_dot_product_attention(
            qs, kh, vh, attn_mask=mask)),
        bound=bound_ms(nbytes, 4 * hd * h * tot, dname), headline=headline)


def _prefill_case(g, device, t, h, kvh, hd, kvname, dname, dt, b=8,
                  headline=False):
    """attn_prefill of a T-token bucket (T = S), ragged lengths,
    hi = min(t + 1, len); rows with an empty window exact zeros."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.attn_decode.ref import scale_q
    from repro_torch.kernels.attn_prefill import ops as pf_ops
    from repro_torch.kernels.attn_prefill.ref import attn_prefill_ref
    grp = h // kvh
    plen = torch.tensor([1, t, t // 2, 3, t - 1, min(17, t), t // 4,
                         min(9, t)], dtype=torch.int32, device=device)[:b]
    pos = torch.arange(t, dtype=torch.int32, device=device)
    hi = torch.minimum(pos[None, :] + 1, plen[:, None])
    lo = torch.zeros_like(hi)
    q = torch.randn((b, t, h, hd), generator=g, device=device).to(dt)
    k_, v_, ks, vs, kl, vl = _kv(g, device, b, t, kvh, hd, kvname, dt)
    what = f"attn_prefill T={t} KV={kvh} D={hd} {dname} kv-{kvname}"
    simt = dt == torch.float32
    got, variant = launched_variant("attn_prefill", lambda: same_bits(
        lambda: pf_ops.attn_prefill(q, k_, v_, hi, k_scale=ks, v_scale=vs),
        what) if simt else pf_ops.attn_prefill(q, k_, v_, hi, k_scale=ks,
                                                v_scale=vs),
        "simt" if simt else "wgmma")
    qg = scale_q(q, hd ** -0.5).reshape(b, t, kvh, grp, hd)
    ref = attn_prefill_ref(qg, k_, v_, lo, hi, ks, vs).reshape(b, t, h, hd)
    if bool((got[hi <= lo] != 0).any()):
        fail(f"{what}: a row with an empty window is not exactly zero")
    qs = q.transpose(1, 2)
    kh = kl.transpose(1, 2).repeat_interleave(grp, dim=1)
    vh = vl.transpose(1, 2).repeat_interleave(grp, dim=1)
    mask = (pos[None, None, :] < hi[:, :, None])[:, None]
    qb, kb = q.element_size(), k_.element_size()
    nbytes = (2 * b * t * h * hd * qb + 2 * int(plen.sum()) * kvh * hd * kb
              + (2 * int(plen.sum()) * 4 if ks is not None else 0)
              + 2 * b * t * 4)
    return dict(
        name="attn_prefill", shape=f"B={b} T=S={t} KV={kvh} G={grp} "
                                   f"D={hd} lens ragged",
        dtype=f"{dname}/kv-{kvname}", variant=variant,
        err=compare(got, ref, dname, what, row_dims=2),
        run=(lambda: pf_ops.attn_prefill(q, k_, v_, hi, k_scale=ks,
                                         v_scale=vs)),
        plain=(lambda: attn_prefill_ref(qg, k_, v_, lo, hi, ks, vs)),
        library=(lambda: F.scaled_dot_product_attention(
            qs, kh, vh, attn_mask=mask)),
        bound=bound_ms(nbytes, 4 * hd * h * int((hi - lo).sum()), dname),
        summary="simt" if simt else None, headline=headline)


def _dense_cases(device, clock, rehearse):
    """The dense family's new shapes: both attention kernels at
    stablelm-3b's head_dim 80 (MHA: 32 query heads over 32 KV heads) in
    every cache form, bf16 prefill at head_dim 32 and 256, qmatvec at the
    widest decode projections, and each untied 8-bit head through the
    qmatmul layout its plan picks for the container export's K-major
    levels. The CPU rehearsal shrinks the qmatvec and head shapes."""
    import torch
    from repro_torch.configs import get_config
    g = torch.Generator(device=device).manual_seed(5678)
    lm = get_config("stablelm-3b")
    h, kvh, hd = lm.num_heads, lm.num_kv_heads, lm.head_dim
    for kvname, dname, dt in (("bf16", "bfloat16", torch.bfloat16),
                              ("int8", "bfloat16", torch.bfloat16),
                              ("fp32", "float32", torch.float32)):
        yield _decode_case(g, device, 8, 512, h, kvh, hd, kvname, dname, dt)
    for kvname, dname, dt in (("bf16", "bfloat16", torch.bfloat16),
                              ("int8", "bfloat16", torch.bfloat16),
                              ("fp32", "float32", torch.float32)):
        yield _prefill_case(g, device, 256, h, kvh, hd, kvname, dname, dt)
    for d in (32, 256):
        yield _prefill_case(g, device, 256, 12, 2, d, "bf16", "bfloat16",
                            torch.bfloat16)
    cut = 16 if rehearse else 1
    for k, n in ((2560, 6912), (6912, 2560), (5120, 25600), (25600, 5120)):
        yield _qmatvec_case(g, device, clock, 8, k // cut, n // cut,
                            "bfloat16", torch.bfloat16)
    for arch in ("stablelm-3b", "qwen2.5-14b", "qwen3-32b"):
        c = get_config(arch)
        yield _untied_head_case(g, device, 8, c.d_model, c.vocab_size // cut,
                                arch)


def _untied_head_case(g, device, m, k, n, arch):
    """An untied 8-bit head as the container export stores it: (K, N)
    int8 levels K-contiguous, per-channel delta, bf16 x; the library call
    is ``matmul`` on the dequantized bf16 head."""
    import torch
    from repro_torch.kernels.qmatmul import kernel as qmm_k
    from repro_torch.kernels.qmatmul import ops as qmm_ops
    from repro_torch.kernels.qmatmul.ref import qmatmul_ref
    w = torch.randint(-127, 128, (n, k), generator=g, device=device,
                      dtype=torch.int8).T
    delta = torch.rand(n, generator=g, device=device) * 0.01
    x = torch.randn((m, k), generator=g, device=device).to(torch.bfloat16)
    want = qmm_k.plan(m, k, n, *w.stride(), x.dtype).layout
    got, layout = launched_variant(
        "qmatmul", lambda: qmm_ops.qmatmul(x, w, delta), want)
    ref = qmatmul_ref(x, w, delta)
    wdq = (w.float() * delta).to(torch.bfloat16).contiguous()
    nbytes = m * k * 2 + w.numel() + n * 4 + m * n * 2
    return dict(
        name="qmatmul", shape=f"M={m} K={k} N={n} ({arch} untied head, "
                              f"K-major)",
        dtype="bfloat16", variant=layout,
        err=compare(got, ref, "bfloat16", f"qmatmul {arch} head"),
        run=(lambda: qmm_ops.qmatmul(x, w, delta)),
        plain=(lambda: qmatmul_ref(x, w, delta)),
        library=(lambda: torch.matmul(x, wdq)),
        library_call="matmul on the dequantized bf16 head",
        bound=bound_ms(nbytes, 2 * m * k * n, "bfloat16"), headline=False)


def _verify_case(g, device, cfg, kvname, dname, dt, b=8, t=SPEC_K + 1,
                 s=512):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.attn_decode.ref import scale_q
    from repro_torch.kernels.attn_prefill import ops as pf_ops
    from repro_torch.kernels.attn_prefill.ref import attn_prefill_ref
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    grp = h // kvh
    lens = torch.tensor([0, 1, 37, 128, 200, 333, 480, s - t],
                        dtype=torch.int32, device=device)
    valid = torch.clamp(lens[:, None] + torch.arange(
        1, t + 1, dtype=torch.int32, device=device)[None, :], max=s)
    valid[1] = 0
    q = torch.randn((b, t, h, hd), generator=g, device=device).to(dt)
    if kvname == "int8":
        k_ = torch.randint(-127, 128, (b, s, kvh, hd), generator=g,
                           device=device, dtype=torch.int8)
        v_ = torch.randint(-127, 128, (b, s, kvh, hd), generator=g,
                           device=device, dtype=torch.int8)
        ks = torch.rand((b, s), generator=g, device=device) * 0.02
        vs = torch.rand((b, s), generator=g, device=device) * 0.02
        kl = (k_.float() * ks[..., None, None]).to(dt)
        vl = (v_.float() * vs[..., None, None]).to(dt)
    else:
        k_ = torch.randn((b, s, kvh, hd), generator=g, device=device).to(dt)
        v_ = torch.randn((b, s, kvh, hd), generator=g, device=device).to(dt)
        ks = vs = None
        kl, vl = k_, v_
    what = f"attn_prefill verify T={t} S={s} {dname} kv-{kvname}"
    simt = dt == torch.float32
    got, variant = launched_variant("attn_prefill", lambda: same_bits(
        lambda: pf_ops.attn_prefill(q, k_, v_, valid, k_scale=ks,
                                    v_scale=vs), what) if simt else
        pf_ops.attn_prefill(q, k_, v_, valid, k_scale=ks, v_scale=vs),
        "simt" if simt else "wgmma")
    qg = scale_q(q, hd ** -0.5).reshape(b, t, kvh, grp, hd)
    lo = torch.zeros_like(valid)
    ref = attn_prefill_ref(qg, k_, v_, lo, valid, ks, vs).reshape(b, t, h, hd)
    if bool((got[valid == 0] != 0).any()):
        fail(f"{what}: a query with no valid key is not exactly zero")
    qs = q.transpose(1, 2)
    kh = kl.transpose(1, 2).repeat_interleave(grp, dim=1)
    vh = vl.transpose(1, 2).repeat_interleave(grp, dim=1)
    mask = (torch.arange(s, device=device)[None, None, :]
            < valid[:, :, None])[:, None]                    # (B, 1, T, S)
    # each row reads its keys below its largest frontier once
    keys = int(valid.amax(1).sum())
    qb, kb = q.element_size(), k_.element_size()
    nbytes = (2 * b * t * h * hd * qb + 2 * keys * kvh * hd * kb
              + (2 * keys * 4 if ks is not None else 0) + b * t * 4)
    return dict(
        name="attn_prefill", shape=f"verify B={b} T={t} S={s} KV={kvh} "
                                   f"G={grp} D={hd} hi=valid ragged",
        dtype=f"{dname}/kv-{kvname}", variant=variant,
        err=compare(got, ref, dname, what, row_dims=2),
        run=(lambda: pf_ops.attn_prefill(q, k_, v_, valid, k_scale=ks,
                                         v_scale=vs)),
        plain=(lambda: attn_prefill_ref(qg, k_, v_, lo, valid, ks, vs)),
        library=(lambda: F.scaled_dot_product_attention(
            qs, kh, vh, attn_mask=mask)),
        library_call="SDPA with the (B, H, T, S) mask of valid",
        bound=bound_ms(nbytes, 4 * hd * h * int(valid.sum()), dname),
        summary="simt" if simt else None, headline=False)


def _qmatvec_case(g, device, clock, m, k, n, dname, dt, headline=False):
    import torch
    from repro_torch.core.packing import pack_matrix, unpack_matrix
    from repro_torch.kernels.qmatvec import kernel as qmv_k
    from repro_torch.kernels.qmatvec import ops as qmv_ops
    from repro_torch.kernels.qmatvec.ref import qmatvec_ref
    lv = torch.randint(-3, 4, (k, n), generator=g, device=device,
                       dtype=torch.int8)
    w = pack_matrix(lv, 3)
    delta = torch.rand(n, generator=g, device=device) * 0.05
    bias = torch.randn(n, generator=g, device=device)
    x = torch.randn((m, k), generator=g, device=device).to(dt)
    what = f"qmatvec {m}x{k}x{n} {dname}"
    got, variant = launched_variant(
        "qmatvec", lambda: same_bits(
            lambda: qmv_ops.qmatvec(x, w, delta, k=k, bias=bias), what),
        qmv_k.plan(m, k, n, dt).variant)
    ref = qmatvec_ref(x, w, delta, k, bias=bias)
    wdq = (unpack_matrix(w, k, 3).float() * delta).to(dt)
    bx = bias.to(dt)
    xb = x.element_size()
    nbytes = m * k * xb + w.numel() * 4 + 2 * n * 4 + m * n * xb
    return dict(
        name="qmatvec", shape=f"M={m} K={k} N={n}", dtype=dname,
        variant=variant, err=compare(got, ref, dname, what),
        run=(lambda: qmv_ops.qmatvec(x, w, delta, k=k, bias=bias)),
        plain=(lambda: qmatvec_ref(x, w, delta, k, bias=bias)),
        library=(lambda: torch.addmm(bx, x, wdq)),
        bound=tc_bound_ms(nbytes, 2 * m * k * n, dname), headline=headline)


def _q_proj_case(g, device, m, k, n, bias, dname, dt, label="q form"):
    """A q-form projection: (K, N) row-major int8 levels, per-channel
    delta, the QKV bias where qwen2 has it; run twice for the same bits,
    gated to launch qmatmul's n_lanes layout in the variant its plan gives
    for M. The library call is ``addmm`` on the dequantized matrix."""
    import torch
    from repro_torch.kernels.qmatmul import kernel as qmm_k
    from repro_torch.kernels.qmatmul import ops as qmm_ops
    from repro_torch.kernels.qmatmul.ref import qmatmul_ref
    w = torch.randint(-127, 128, (k, n), generator=g, device=device,
                      dtype=torch.int8)
    delta = torch.rand(n, generator=g, device=device) * 0.01
    b = torch.randn(n, generator=g, device=device) if bias else None
    x = torch.randn((m, k), generator=g, device=device).to(dt)
    want = qmm_k.plan(m, k, n, *w.stride(), dt)
    what = f"qmatmul q form {m}x{k}x{n} {dname}"
    run = lambda: qmm_ops.qmatmul(x, w, delta, bias=b)
    before = read_variants()
    got = same_bits(run, what)
    after = read_variants()
    ran = {key: [v for v in after[key] if after[key][v] != before[key][v]]
           for key in ("qmatmul", N_LANES)}
    if got.is_cuda and (ran["qmatmul"] != ["n_lanes"]
                        or ran[N_LANES] != [want.variant]):
        fail(f"{what}: launched {ran}, expected n_lanes {want.variant}")
    ref = qmatmul_ref(x, w, delta, bias=b)
    wdq = (w.float() * delta).to(dt)
    bx = (b if bias else torch.zeros(n, device=device)).to(dt)
    xb = x.element_size()
    nbytes = m * k * xb + w.numel() + n * 4 * (2 if bias else 1) \
        + m * n * xb
    return dict(
        name="qmatmul", shape=f"M={m} K={k} N={n} ({label}"
                              f"{', bias' if bias else ''})",
        dtype=dname, variant=f"n_lanes/{want.variant}", ksplit=want.ksplit,
        err=compare(got, ref, dname, what), run=run,
        plain=(lambda: qmatmul_ref(x, w, delta, bias=b)),
        library=(lambda: torch.addmm(bx, x, wdq)),
        library_call="addmm on the dequantized matrix",
        bound=tc_bound_ms(nbytes, 2 * m * k * n, dname), summary="n_lanes",
        headline=False)


def _qmatmul_head_case(g, device, clock, m, k, n, dname, dt):
    """The MLP's 8-bit head: int8 levels, per-channel delta, bias."""
    import torch
    from repro_torch.kernels.qmatmul import ops as qmm_ops
    from repro_torch.kernels.qmatmul.ref import qmatmul_ref
    w = torch.randint(-127, 128, (k, n), generator=g, device=device,
                      dtype=torch.int8)
    delta = torch.rand(n, generator=g, device=device) * 0.01
    bias = torch.randn(n, generator=g, device=device)
    x = torch.randn((m, k), generator=g, device=device).to(dt)
    got, layout = launched_variant(
        "qmatmul", lambda: qmm_ops.qmatmul(x, w, delta, bias=bias), "k_lanes")
    ref = qmatmul_ref(x, w, delta, bias=bias)
    wdq, bx = (w.float() * delta).to(dt), bias.to(dt)
    xb = x.element_size()
    nbytes = m * k * xb + w.numel() + 2 * n * 4 + m * n * xb
    return dict(
        name="qmatmul", shape=f"M={m} K={k} N={n} (MLP head)", dtype=dname,
        variant=layout, err=compare(got, ref, dname, f"qmatmul head {m}x{k}x{n} {dname}"),
        run=(lambda: qmm_ops.qmatmul(x, w, delta, bias=bias)),
        plain=(lambda: qmatmul_ref(x, w, delta, bias=bias)),
        library=(lambda: torch.addmm(bx, x, wdq)),
        bound=bound_ms(nbytes, 2 * m * k * n, dname), headline=False)


def _parts_case(parts, name, label, gate=None, twice=True, row_dims=1,
                **extra):
    """A bf16 case that ``bench_kernels`` builds as parts (inputs, plain
    version, library call, the bytes and operations of its bound), gated
    as every case here: launched in the variant ``gate`` = (counter,
    variant) names, two runs the same bits where ``twice``, against its
    plain version."""
    what = f"{name} {parts['shape']} {label}"
    fn = (lambda: same_bits(parts["run"], what)) if twice else parts["run"]
    if gate:
        counter, want = gate
        got, v = launched_variant(counter, fn, want)
        # a layout's counter (qmatmul/k_lanes) names the layout too
        extra["variant"] = (f"{counter.split('/')[1]}/{v}" if "/" in counter
                            else v)
    else:
        got = fn()
    return dict(
        name=name, shape=f"{parts['shape']} ({label})", dtype=parts["dtype"],
        err=compare(got, parts["plain"](), "bfloat16", what, row_dims),
        run=parts["run"], plain=parts["plain"], library=parts["library"],
        library_call=parts["library_call"],
        bound=bound_ms(parts["nbytes"], parts["ops"], parts["peak"]),
        headline=False, **extra)


def _moe_cases(device, clock, rehearse):
    """The MoE family's new shapes (bf16): every expert product of
    phi3.5-moe and mixtral-8x22b in qmatmul's n_lanes at the capacity M of
    a decode tick, of an admission round and of mixtral's solo prefill;
    their routers in the row-major k_lanes at a tick's M = 8 and at the
    4096 bucket's 32768 rows; mixtral's windowed attn_prefill at its solo
    prompt; attn_decode over a full 4096-slot ring. The CPU rehearsal
    shrinks every shape by 16."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.attn_decode import kernel as dec_k
    from repro_torch.launch import bench_kernels as bk
    from repro_torch.models.moe import groups
    g = torch.Generator(device=device).manual_seed(2468)
    cut = 16 if rehearse else 1
    bf = ("bfloat16", torch.bfloat16)
    for arch, window_t in MOE_PARITY:
        c = get_config(arch)
        # a tick (8 slots), an admission round, and for mixtral its solo
        # prompt and its 4096 bucket
        toks = (8, 8 * MOE_BUCKET) + ((MOE_SOLO[0], 8 * 4096)
                                     if c.sliding_window else ())
        for t in toks:
            t = max(1, t // cut)
            ng, _, cap = groups(c, t)
            for k, n in ((c.d_model, c.d_ff), (c.d_ff, c.d_model)):
                yield _q_proj_case(g, device, ng * cap, k // cut, n // cut,
                                   False, *bf, label=f"{arch} expert, "
                                   f"{t} tokens")
        for m in (8, 8 * 4096) if c.sliding_window else (8,):
            yield _parts_case(bk.router_parts(
                g, device, max(1, m // cut), c.d_model // cut,
                c.num_experts), "qmatmul", arch, gate=(K_LANES, "row_major"))
        if c.sliding_window:
            kv = dict(kvh=c.num_kv_heads, grp=c.num_heads // c.num_kv_heads,
                      hd=c.head_dim)
            yield _parts_case(bk.window_prefill_parts(
                g, device, window_t // cut, c.sliding_window // cut, **kv),
                "attn_prefill", arch, gate=("attn_prefill", "wgmma"),
                twice=False, row_dims=2)
            s = c.sliding_window // cut
            yield _parts_case(bk.ring_decode_parts(g, device, 8, s, **kv),
                              "attn_decode", arch, splits=dec_k.plan(
                                  8, s, kv["kvh"], kv["grp"], kv["hd"],
                                  torch.bfloat16).splits)


def _ssm_cases(device, clock, rehearse):
    """The state-space and hybrid families' shapes: qmatvec at every
    projection of mamba2-2.7b (in_proj 2560 -> 10576, out_proj 5120 ->
    2560) and of zamba2-1.2b (in_proj 2048 -> 8384, out_proj 4096 -> 2048,
    the shared block's 2048 -> 2048 / 8192, 8192 -> 2048) at a tick's M = 8
    (bf16; zamba2's also fp32, its drafter in the fp32 gate) and its mamba
    projections at the largest admission (8 x the 256 bucket); the tied
    readouts at V = 50280 and 32000 (bf16; zamba2's also fp32); both
    attention kernels at zamba2's shared block (MHA, KV = 32, G = 1,
    D = 64): decode and a 256 bucket in bf16 and int8 K/V, fp32 decode,
    and the verify shape in bf16 and fp32. The CPU rehearsal shrinks the
    qmatvec and readout shapes by 16."""
    import torch
    from repro_torch.configs import get_config
    g = torch.Generator(device=device).manual_seed(1357)
    cut = 16 if rehearse else 1
    bf, f32 = ("bfloat16", torch.bfloat16), ("float32", torch.float32)
    for arch in SSM_ARCHS:
        c = get_config(arch)
        gn2 = 2 * c.ssm_ngroups * c.ssm_state
        mamba = ((c.d_model, 2 * c.d_inner + gn2 + c.ssm_heads),
                 (c.d_inner, c.d_model))
        shared = (((c.d_model, c.num_heads * c.head_dim),
                   (c.d_model, c.d_ff), (c.d_ff, c.d_model))
                  if c.family == "hybrid" else ())
        dts = (bf, f32) if c.family == "hybrid" else (bf,)
        for k, n in mamba + shared:
            for dname, dt in dts:
                yield _qmatvec_case(g, device, clock, 8, k // cut, n // cut,
                                    dname, dt)
        for k, n in mamba:
            yield _qmatvec_case(g, device, clock, 8 * 256, k // cut, n // cut,
                                *bf)
        for dname, dt in dts:
            yield _readout_case(g, device, c.d_model // cut,
                                c.vocab_size // cut, dname, dt,
                                label=f", {arch} tied readout")
        if c.family != "hybrid":
            continue
        h, kvh, hd = c.num_heads, c.num_kv_heads, c.head_dim
        for kvname, dname, dt in (("bf16", *bf), ("int8", *bf),
                                  ("fp32", *f32)):
            yield _decode_case(g, device, 8, 512, h, kvh, hd, kvname, dname,
                               dt)
        for kvname, dname, dt in (("bf16", *bf), ("int8", *bf)):
            yield _prefill_case(g, device, 256, h, kvh, hd, kvname, dname, dt)
        for kvname, dname, dt in (("bf16", *bf), ("fp32", *f32)):
            yield _verify_case(g, device, c, kvname, dname, dt)


def _mlp_cases(device, clock, rehearse):
    """The paper MLP's shapes: its hidden layers through qmatvec, its head
    through qmatmul, and the PLAN sigmoid forward and backward."""
    import torch
    from repro_torch.kernels.sigmoid_pw import kernel as sig_k
    from repro_torch.kernels.sigmoid_pw import ops as sig_ops
    from repro_torch.kernels.sigmoid_pw import ref as sig_ref

    g = torch.Generator(device=device).manual_seed(4321)
    dts = [("bfloat16", torch.bfloat16), ("float32", torch.float32)]
    for k in (784, 429):
        for dname, dt in dts:
            yield _qmatvec_case(g, device, clock, 100, k, 1022, dname, dt)
    for m, n in ((100, 10), (128, 61)):             # digit and phoneme heads
        for dname, dt in dts:
            yield _qmatmul_head_case(g, device, clock, m, 1022, n, dname, dt)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device) * 4

    big = 1 << (20 if rehearse else 26)
    bwd = sig_k.sigmoid_pw_bwd_cuda if device.type == "cuda" \
        else sig_ref.sigmoid_pw_bwd
    for dname, dt in dts:
        cases = [("(100, 1022)", randn(100, 1022)), ("(7,)", randn(7)),
                 ("(2, 3, 129)", randn(2, 3, 129)),
                 ("(64, 130)[:, 1:129:2] view", randn(64, 130)[:, 1:129:2]),
                 ("linspace(-8, 8, 1000), breaks, +-0, +-inf, NaN",
                  torch.cat([torch.linspace(-8, 8, 1000, device=device),
                             torch.tensor(SPECIAL, device=device)])),
                 (f"({big},)", randn(big))]
        for label, x in cases:
            x = x.to(dt)
            r = randn(*x.shape).to(dt)
            what = f"sigmoid_pw {label} {dname}"
            err = compare_exact(sig_ops.sigmoid_pw(x), sig_ref.sigmoid_pw_fwd(x),
                                what)
            compare_exact(bwd(x, r), sig_ref.sigmoid_pw_bwd(x, r),
                          what + " backward")
            n, xb = x.numel(), x.element_size()
            case = dict(
                name="sigmoid_pw", shape=label, dtype=dname, err=err,
                backward_err=0.0,
                run=(lambda: sig_ops.sigmoid_pw(x)),
                plain=(lambda: sig_ref.sigmoid_pw(x)),
                library=(lambda: torch.sigmoid(x)),
                library_call="torch.sigmoid (same bytes, not the same function)",
                backward_ms=clock(lambda: bwd(x, r)),
                bound=bound_ms(2 * n * xb, 2 * n, dname),
                headline=(label == "(100, 1022)" and dname == "float32"))
            case["bytes_moved"] = 2 * n * xb
            yield case
            del x, r


def parity_phase(cfg, device, rehearse):
    clock = Clock(device, reps=3 if rehearse else 20)
    cases = []
    for c in itertools.chain(_kernel_cases(cfg, device, clock),
                             _dense_cases(device, clock, rehearse),
                             _moe_cases(device, clock, rehearse),
                             _ssm_cases(device, clock, rehearse),
                             _mlp_cases(device, clock, rehearse)):
        c["bound_ms"], c["bound_by"] = c.pop("bound")
        run, plain, library = c.pop("run"), c.pop("plain"), c.pop("library")
        c["ms"], c["device_ms"] = clock(run), clock.device_ms(run)
        c["plain_ms"] = clock(plain)
        c["library_ms"] = clock(library)
        c["library_device_ms"] = clock.device_ms(library)
        if c["name"] == "attn_prefill" and "kv-int8" in c["dtype"]:
            # measured again in profiler runs of their own: one run once
            # recorded 0.0014 ms for SDPA here, against 0.0276 in bf16
            c["library_device_ms_again"] = [clock.device_ms(library)
                                            for _ in range(3)]
        if "bytes_moved" in c:
            c["GB_per_s"] = round(c.pop("bytes_moved") / c["ms"] / 1e6, 1)
        cases.append(c)
    emit({"phase": "parity", "tolerance": TOL,
          "timing": "median ms, CUDA events" if not rehearse
          else "median ms, host clock (CPU rehearsal, not device times)",
          "cases": [{k: v for k, v in c.items()
                     if k not in ("headline", "summary", "summary_headline")}
                    for c in cases]})
    routes = {}
    for c in cases:
        if c.get("summary"):
            routes.setdefault(c["summary"], []).append(c)
    return {c["name"]: c for c in cases if c["headline"]}, routes


# --- phase 3 ----------------------------------------------------------------------

def _counters():
    from repro_torch.kernels.attn_decode import kernel as k1, ref as r1
    from repro_torch.kernels.attn_prefill import kernel as k2, ref as r2
    from repro_torch.kernels.qmatmul import kernel as k3, ref as r3
    from repro_torch.kernels.qmatvec import kernel as k4, ref as r4
    from repro_torch.kernels.sigmoid_pw import kernel as k5, ref as r5
    return {"qmatvec": (k4, r4), "qmatmul": (k3, r3),
            "attn_decode": (k1, r1), "attn_prefill": (k2, r2),
            "sigmoid_pw": (k5, r5)}


def reset_counts():
    c = _counters()
    for kmod, rmod in c.values():
        kmod.launches = 0
        rmod.calls = 0
    for name, (attr, _) in VARIANTS.items():
        split = getattr(c[name][0], attr)
        for key in split:
            split[key] = 0
    for split in (c["qmatmul"][0].launches_by_variant,
                  c["qmatmul"][0].launches_by_orientation):
        for key in split:
            split[key] = 0
    c["attn_prefill"][0].merges = 0


def read_counts():
    c = _counters()
    return ({n: km.launches for n, (km, _) in c.items()},
            {n: rm.calls for n, (_, rm) in c.items()})


def read_variants():
    """Launches by variant (qmatvec, attn_prefill), by layout (qmatmul),
    qmatmul's n_lanes launches by variant (N_LANES) and k_lanes launches by
    orientation (K_LANES), and the fp32 attn_prefill's merges
    (SIMT_MERGE)."""
    c = _counters()
    out = {name: dict(getattr(c[name][0], attr))
           for name, (attr, _) in VARIANTS.items()}
    out[N_LANES] = dict(c["qmatmul"][0].launches_by_variant)
    out[K_LANES] = dict(c["qmatmul"][0].launches_by_orientation)
    out[SIMT_MERGE] = {"merge": c["attn_prefill"][0].merges}
    return out


def launched_variant(name, fn, expect):
    """Run ``fn`` and return its output and the variant of kernel ``name``
    it launched. On the card it must have launched ``expect``, the variant
    meant for these inputs, and no other; on the CPU rehearsal no kernel
    runs and the variant is None."""
    before = read_variants()[name]
    out = fn()
    after = read_variants()[name]
    ran = [k for k in after if after[k] != before[k]]
    if out.is_cuda and ran != [expect]:
        fail(f"{name}: launched {ran or 'nothing'}, expected {expect}")
    return out, (ran[0] if ran else None)


def build_model(cfg, device, seed):
    """fp32 master weights from a seeded generator on the card and their
    W3A8 container export: (master, params, seconds)."""
    import torch
    from repro_torch.core import quant_dense
    from repro_torch.core.precision import W3A8
    from repro_torch.models import get_model
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(seed)
    master = get_model(cfg).init(gen, cfg, device=device)
    params = quant_dense.export_container(master, W3A8)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return master, params, time.perf_counter() - t0


def _engine_launch_gate(eng, cfg, run, what):
    """The plain engine's launch gates over one serve (``run``): every
    kernel of the path launched, no plain version ran, every readout took
    qmatmul's k_lanes layout, every admission the wgmma attn_prefill, and
    every qmatvec launch the variant its plan gives for its M (ticks decode,
    admissions prefill), the same number for each forward."""
    import torch
    from repro_torch.kernels.qmatvec import kernel as qmv_k
    from repro_torch.serving.engine import _MIN_BUCKET
    launches, plain, variants = run["launches"], run["plain"], run["variants"]
    if min(launches[k] for k in ENGINE_KERNELS) <= 0:
        fail(f"{what}: a kernel of the engine path never launched: {launches}")
    if max(plain.values()) != 0:
        fail(f"{what}: a plain version ran on the engine path: {plain}")
    # every readout reads the table with lanes along K, every bf16
    # admission runs the tensor-core attention
    if variants["qmatmul"]["k_lanes"] != launches["qmatmul"]:
        fail(f"{what}: a readout did not take the k_lanes layout: {variants}")
    if variants["attn_prefill"]["wgmma"] != launches["attn_prefill"]:
        fail(f"{what}: a bf16 admission did not run the wgmma attn_prefill: "
             f"{variants}")
    # every tick (M = slots) takes qmatvec's decode tiles and every
    # admission (M = slots x bucket) the variant its plan gives, which is
    # prefill from the smallest bucket up
    plan = qmv_k.plan
    calls = run["ticks"] + run["rounds"]
    per_call, rest = divmod(launches["qmatvec"], calls)
    want = {"decode": per_call * run["ticks"],
            "prefill": per_call * run["rounds"]}
    if (rest or plan(eng.slots, cfg.d_model, cfg.d_model,
                     torch.bfloat16).variant != "decode"
            or plan(eng.slots * _MIN_BUCKET, cfg.d_model, cfg.d_model,
                    torch.bfloat16).variant != "prefill"
            or variants["qmatvec"] != want):
        fail(f"{what}: qmatvec launches by variant {variants['qmatvec']}, "
             f"want {want} ({per_call} a forward)")


def _twin_gate(runs, what, replay_only=True):
    """The captured engine and its capture=False twin served the same
    tokens to every request, and (on the card) the captured one, warmed,
    replayed only: its graphs (one tick, one per admission bucket) were all
    captured before the timed serve."""
    a, b = runs["captured"], runs["eager"]
    if a["fallback_events"] or b["fallback_events"]:
        fail(f"{what}: a degradation-ladder step with no injected fault: "
             f"{a['fallback_events']} / {b['fallback_events']}")
    outs = [[(r.status, r.out) for r in run["done"]] for run in (a, b)]
    if outs[0] != outs[1]:
        i = next(i for i, (x, y) in enumerate(zip(*outs)) if x != y)
        fail(f"{what}: captured and eager engines differ on request {i}: "
             f"{outs[0][i]} vs {outs[1][i]}")
    if replay_only and a["captures"] != a["captures_before"]:
        fail(f"{what}: the timed serve captured a graph: "
             f"{a['captures_before']} -> {a['captures']}")
    if b["captures"]["tick"] or b["captures"]["admit"]:
        fail(f"{what}: the capture=False twin captured {b['captures']}")


def _run_line(run):
    toks = sum(len(r.out) for r in run["done"])
    return {"tokens": toks, "ticks": run["ticks"],
            "prefill_calls": run["rounds"], "wall_s": round(run["wall"], 4),
            "tok_per_s": round(toks / run["wall"], 2),
            "captures": run["captures"]}


def engine_phase(cfg, params, device, kv_bits, rehearse):
    import torch
    from repro_torch.core.precision import W3A8
    from repro_torch.launch.profile_engine import MAX_NEW, prompts
    from repro_torch.serving.engine import ServingEngine
    reqs = prompts(cfg.vocab_size)
    what = f"engine kv-{'int8' if kv_bits else 'bf16'}"

    def make(capture):
        return ServingEngine(params, cfg, policy=W3A8, slots=8, max_len=512,
                             dtype=torch.bfloat16, kv_bits=kv_bits,
                             capture=capture, device=device)
    # the captured engine (capture defaults on for the card) and its eager
    # twin, each warmed, then timed in turn
    engines = {"captured": _warmed(make(None), reqs),
               "eager": _warmed(make(False), reqs)}
    runs = {name: _serve(eng, reqs, device) for name, eng in engines.items()}
    eng, run = engines["captured"], runs["captured"]
    done = run["done"]
    out = {"phase": "engine", "kv": "int8" if kv_bits else "bf16",
           "requests": len(done), **_run_line(run),
           "eager_twin": _run_line(runs["eager"]),
           "launches": run["launches"],
           "launches_by_variant": run["variants"],
           "plain_calls": run["plain"],
           "eager_twin_launches": runs["eager"]["launches"]}
    if len(done) != len(reqs) or any(len(r.out) != MAX_NEW for r in done):
        fail(f"engine did not serve every request its {MAX_NEW} tokens")
    if any(not 0 <= t < cfg.vocab_size for r in done for t in r.out):
        fail("engine emitted a token id outside the vocabulary")
    _twin_gate(runs, what)
    out["captured_eager_token_identical"] = True
    if not rehearse:
        for name, eng_ in engines.items():
            _engine_launch_gate(eng_, cfg, runs[name], f"{what} {name}")
        if runs["eager"]["launches"] != run["launches"] \
                or runs["eager"]["variants"] != run["variants"]:
            fail(f"{what}: replayed launches {run['variants']} differ from "
                 f"the eager twin's {runs['eager']['variants']}")
    out["steady"] = {name: _steady(e, cfg, device, rehearse,
                                   names=("qmatvec", "qmatmul", "attn_decode"))
                     for name, e in engines.items()}
    emit(out)
    del engines
    return run["launches"], run["variants"], out["tok_per_s"]


def _q_launch_gate(eng, cfg, run, what):
    """The q engine's launch gates over one serve: every projection (7 a
    layer a forward) in qmatmul's n_lanes layout, in the variant its plan
    gives for its M (ticks decode, admissions prefill), every readout in
    k_lanes, every admission the wgmma attn_prefill, attn_decode launched,
    no qmatvec and no plain version."""
    import torch
    from repro_torch.kernels.qmatmul import kernel as qmm_k
    from repro_torch.serving.engine import _MIN_BUCKET
    launches, plain, variants = run["launches"], run["plain"], run["variants"]
    ticks, rounds, layers = run["ticks"], run["rounds"], cfg.num_layers
    if max(plain.values()) != 0:
        fail(f"{what}: a plain version ran: {plain}")
    if launches["qmatvec"] != 0 or launches["attn_decode"] <= 0:
        fail(f"{what}: launches {launches}")
    want = {"n_lanes": 7 * layers * (ticks + rounds),
            "k_lanes": ticks + rounds}
    by_m = {"decode": 7 * layers * ticks, "prefill": 7 * layers * rounds}
    d = cfg.d_model
    if (variants["qmatmul"] != want or variants[N_LANES] != by_m
            or launches["qmatmul"] != sum(want.values())
            or qmm_k.plan(eng.slots, d, d, d, 1, torch.bfloat16).variant
            != "decode"
            or qmm_k.plan(eng.slots * _MIN_BUCKET, d, d, d, 1,
                          torch.bfloat16).variant != "prefill"):
        fail(f"{what}: qmatmul launches by layout {variants['qmatmul']} and "
             f"n_lanes variant {variants[N_LANES]}, want {want} and {by_m} "
             f"({ticks} ticks, {rounds} rounds)")
    if not 0 < variants["attn_prefill"]["wgmma"] == launches["attn_prefill"]:
        fail(f"{what}: an admission did not run the wgmma attn_prefill: "
             f"{variants}")


def q_engine_phase(cfg, master, device, rehearse):
    """The q form served: the fp32 master's export_levels (int8 levels at
    full shape, made on the card), ServingEngine(slots=8, max_len=512,
    bf16, bf16 KV) captured and as its capture=False twin on the engine
    phase's requests, gated as the engine phase is (identical tokens, the
    timed serve replay only, the same launches in both twins) and by
    _q_launch_gate; each twin's steady tick; then the path check on the
    export. The export is freed before the next phase. Returns the
    captured run's launches and variants."""
    import gc

    import torch
    from repro_torch.core import quant_dense
    from repro_torch.core.precision import W3A8
    from repro_torch.core.treeutil import flatten_with_path
    from repro_torch.launch.profile_engine import MAX_NEW, prompts
    from repro_torch.serving.engine import ServingEngine
    t0 = time.perf_counter()
    qparams = quant_dense.export_levels(master, W3A8)
    if device.type == "cuda":
        torch.cuda.synchronize()
    export_s = time.perf_counter() - t0
    leaves = flatten_with_path(qparams)
    int8_gb = sum(v.numel() for k, v in leaves.items()
                  if v.dtype == torch.int8) / 1e9
    if any(k.endswith("qp") for k in leaves):
        fail("q export holds packed containers")
    reqs = prompts(cfg.vocab_size)
    what = "q engine"

    def make(capture):
        return ServingEngine(qparams, cfg, policy=W3A8, slots=8, max_len=512,
                             dtype=torch.bfloat16, capture=capture,
                             device=device)
    engines = {"captured": _warmed(make(None), reqs),
               "eager": _warmed(make(False), reqs)}
    runs = {name: _serve(eng, reqs, device) for name, eng in engines.items()}
    run = runs["captured"]
    done = run["done"]
    if len(done) != len(reqs) or any(len(r.out) != MAX_NEW for r in done):
        fail(f"{what} did not serve every request its {MAX_NEW} tokens")
    if any(not 0 <= t < cfg.vocab_size for r in done for t in r.out):
        fail(f"{what} emitted a token id outside the vocabulary")
    _twin_gate(runs, what)
    if not rehearse:
        for name, eng in engines.items():
            _q_launch_gate(eng, cfg, runs[name], f"{what} {name}")
        if runs["eager"]["launches"] != run["launches"] \
                or runs["eager"]["variants"] != run["variants"]:
            fail(f"{what}: replayed launches {run['variants']} differ from "
                 f"the eager twin's {runs['eager']['variants']}")
    out = {"phase": "q_engine", "form": "q (W3A8 export_levels: int8 "
           "levels, qmatmul n_lanes)", "export_s": round(export_s, 3),
           "int8_gb": round(int8_gb, 4), "kv": "bf16",
           "requests": len(done), **_run_line(run),
           "eager_twin": _run_line(runs["eager"]),
           "captured_eager_token_identical": True,
           "launches": run["launches"], "launches_by_variant": run["variants"],
           "plain_calls": run["plain"],
           "eager_twin_launches": runs["eager"]["launches"]}
    out["steady"] = {name: _steady(e, cfg, device, rehearse,
                                   names=("qmatmul", "attn_decode"))
                     for name, e in engines.items()}
    del engines
    gc.collect()
    out["path"] = _path_check(cfg, qparams, device)
    emit(out)
    del qparams, leaves
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return run["launches"], run["variants"], out["tok_per_s"]


# --- phase 4 ----------------------------------------------------------------------

def _path_check(cfg, params, device):
    """Prefill + 4 decode steps in fp32 activations, no activation quant,
    through the kernels and through the plain versions on the same
    weights: the logits must agree within 2e-3 x max|logit|. Returns the
    record."""
    import dataclasses

    import torch
    from repro_torch.core.precision import W3A8
    from repro_torch.models import api
    policy = dataclasses.replace(W3A8, act_bits=None)
    lens = [4, 8, 5, 12, 3, 16, 40, 64]
    toks = torch.zeros((8, 64), dtype=torch.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = torch.arange(n) % (cfg.vocab_size - 1) + 1 + i
    toks = toks.to(device)
    lengths = torch.tensor(lens, dtype=torch.int32, device=device)
    runs = {}
    feed = None
    for name, mm, am in (("kernel", "kernel", "kernel"),
                         ("plain", "dequant", "ref")):
        kw = dict(policy=policy, dtype=torch.float32, matmul_mode=mm)
        if cfg.family != "ssm":              # ssm has no attention
            kw["attn_mode"] = am
        logits, cache = api.prefill(params, {"tokens": toks}, cfg, max_len=96,
                                    lengths=lengths, **kw)
        steps = [logits]
        tok_seq = feed or []
        for i in range(4):
            nxt = (steps[-1][:, -1].argmax(-1).to(torch.int32)[:, None]
                   if feed is None else tok_seq[i])
            if feed is None:
                tok_seq.append(nxt)
            logits, cache = api.decode_step(params, cache, nxt, cfg, **kw)
            steps.append(logits)
        feed = tok_seq
        runs[name] = torch.stack([s[:, -1] for s in steps])   # (5, B, V)
    a, b = runs["kernel"].float(), runs["plain"].float()
    err = float((a - b).abs().max())
    scale = float(b.abs().max())
    agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    rec = {"activations": "float32", "act_bits": None,
           "steps": "prefill + 4 decode", "max_abs_logit_diff": err,
           "max_abs_logit": scale, "tolerance": "2e-3 x max|logit|",
           "greedy_agreement": agree}
    if not (a.isfinite().all() and b.isfinite().all()):
        fail(f"{cfg.name}: non-finite logits on the path-parity run")
    if not err <= 2e-3 * scale:
        fail(f"{cfg.name}: kernel path vs plain path logits differ by {err} "
             f"(> 2e-3 x {scale})")
    return rec


def path_phase(cfg, params, device):
    emit({"phase": "path", **_path_check(cfg, params, device)})


# --- phase 5 ----------------------------------------------------------------------

def _warmed(eng, reqs):
    """``eng`` after it has served ``reqs`` for WARM_NEW tokens each: the
    timed serve that follows on it finds every shape it launches (admission
    buckets, tick, readout) loaded and tuned, and on the card every graph
    it replays captured, so engines are compared warm."""
    for p in reqs:
        eng.submit(p, max_new=WARM_NEW)
    eng.run_all()
    return eng


def _serve(eng, reqs, device, max_new=None):
    """Serve ``reqs`` on ``eng`` with the launch counters zeroed just before
    and read just after: the requests (by uid), wall seconds, ticks and
    admission rounds it took, the counters, and the engine's captures
    before and after. ``max_new``: the new tokens of every request, or a
    list of them, one a request."""
    import copy

    import torch
    from repro_torch.launch.profile_engine import MAX_NEW
    if device.type == "cuda":
        torch.cuda.synchronize()
    ticks, rounds = eng.decode_calls, eng.prefill_calls
    drafted, accepted = eng.spec_drafted, eng.spec_accepted
    caps = copy.deepcopy(eng.captures)
    reset_counts()
    t0 = time.perf_counter()
    news = max_new if isinstance(max_new, (list, tuple)) \
        else [max_new or MAX_NEW] * len(reqs)
    for p, n in zip(reqs, news):
        eng.submit(p, max_new=n)
    done = sorted(eng.run_all(), key=lambda r: r.uid)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = read_counts()
    return {"done": done, "wall": wall, "ticks": eng.decode_calls - ticks,
            "fallback_events": list(eng.fallback_events),
            "rounds": eng.prefill_calls - rounds, "launches": launches,
            "spec_drafted": eng.spec_drafted - drafted,
            "spec_accepted": eng.spec_accepted - accepted,
            "plain": plain, "variants": read_variants(),
            "captures_before": caps, "captures": copy.deepcopy(eng.captures)}


def _steady(eng, cfg, device, rehearse, names, ticks=STEADY_TICKS):
    """A steady tick of ``eng`` with every slot active: 8 requests of 64
    tokens admitted and two ticks run first, then the host ms of a tick
    over ``ticks`` ticks (host clock, synchronised), then ``PROFILED_TICKS``
    more under torch.profiler: the device ms of a tick by kernel and the
    idle share of the card over them. On the card each kernel of ``names``
    must show device time there: a run of replayed graphs (none captured in
    the window) names by name the kernels it ran."""
    import torch
    from repro_torch.launch.profile_engine import device_ms_by_kernel
    k1 = eng.spec_k + 1
    for i in range(eng.slots):
        eng.submit([(7 * i) % (cfg.vocab_size - 1) + 1] * 64,
                   max_new=(2 * (ticks + PROFILED_TICKS) + 4) * k1)
    eng.step()
    eng.step()
    eng.drain()
    caps = dict(eng.graphs.captures)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for _ in range(ticks):
        eng.step()
    sync()
    host_ms = (time.perf_counter() - t0) / ticks * 1e3
    out = {"ticks": ticks, "tick_host_ms": host_ms}
    if not rehearse:
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILED_TICKS):
                eng.step()
            sync()
            wall = (time.perf_counter() - t0) * 1e3
        by = device_ms_by_kernel(prof)
        dev = sum(by.values())
        out.update({"profiled_ticks": PROFILED_TICKS,
                    "tick_device_ms": dev / PROFILED_TICKS,
                    "tick_device_ms_by_kernel": {
                        k: v / PROFILED_TICKS for k, v in by.items()},
                    "profiled_tick_host_ms": wall / PROFILED_TICKS,
                    "idle_share": 1.0 - dev / wall})
        if eng.graphs.capture:
            if eng.graphs.captures != caps:
                fail(f"steady ticks captured a graph: {caps} -> "
                     f"{eng.graphs.captures}")
            missing = [k for k in names if not by[k] > 0]
            if missing:
                fail(f"the profiler saw no device time of {missing} in "
                     f"{PROFILED_TICKS} replayed ticks: {by}")
    eng.drain()
    return out


def attn_layers(cfg) -> int:
    """Attention launches of one forward (``profile_engine.attn_layers``)."""
    from repro_torch.launch.profile_engine import attn_layers as count
    return count(cfg)


def _projections(cfg) -> int:
    """qmatvec launches of one forward of the qp export: 4 attention and 3
    (SwiGLU) or 2 MLP projections a transformer layer; in_proj and
    out_proj (or the four split projections and out_proj) a mamba block,
    plus the shared block's at each of its applications."""
    mlp = 3 if cfg.mlp_act == "silu" else 2
    if cfg.family in ("ssm", "hybrid"):
        per = 5 if cfg.ssm_split_proj else 2
        return per * cfg.num_layers + (4 + mlp) * attn_layers(cfg)
    return (4 + mlp) * cfg.num_layers


def _spec_launch_gate(eng, cfg, dcfg, run, rehearse):
    """The launches one run of the spec engine must have made, from the
    tick's structure: each tick verifies through the target's A attention
    layers (attn_prefill; A = L, or the shared-block applications of a
    hybrid) after spec_k + 1 drafter steps (Ad attn_decode, P qmatvec
    decode — 7 Ld for a SwiGLU transformer — one qmatmul readout each);
    each admission round prefills target and drafter (A + Ad attn_prefill,
    P qmatvec prefill, one drafter readout). The target's products are
    plain float matmuls. On the CPU rehearsal the plain versions take the
    same calls, so the formulas are checked there too."""
    import torch
    from repro_torch.kernels.qmatvec import kernel as qmv_k
    from repro_torch.serving.engine import _MIN_BUCKET
    launches, plain, variants = run["launches"], run["plain"], run["variants"]
    ticks, rounds, t1 = run["ticks"], run["rounds"], SPEC_K + 1
    big, small = attn_layers(cfg), attn_layers(dcfg)
    proj = _projections(dcfg)
    want = {"attn_prefill": big * ticks + (big + small) * rounds,
            "attn_decode": small * t1 * ticks,
            "qmatmul": t1 * ticks + rounds,
            "qmatvec": proj * (t1 * ticks + rounds)}
    seen = plain if rehearse else launches
    if {k: seen[k] for k in want} != want:
        fail(f"spec engine {'plain calls' if rehearse else 'launches'} "
             f"{seen}, want {want} ({ticks} ticks, {rounds} rounds)")
    if rehearse:
        return want
    if max(plain.values()) != 0:
        fail(f"a plain version ran on the spec path: {plain}")
    if variants["attn_prefill"]["wgmma"] != launches["attn_prefill"]:
        fail(f"a bf16 verify or admission did not run the wgmma "
             f"attn_prefill: {variants}")
    if variants["qmatmul"]["k_lanes"] != launches["qmatmul"]:
        fail(f"a drafter readout did not take the k_lanes layout: {variants}")
    plan = qmv_k.plan
    vwant = {"decode": proj * t1 * ticks, "prefill": proj * rounds}
    if (plan(eng.slots, cfg.d_model, cfg.d_model,
             torch.bfloat16).variant != "decode"
            or plan(eng.slots * _MIN_BUCKET, cfg.d_model, cfg.d_model,
                    torch.bfloat16).variant != "prefill"
            or variants["qmatvec"] != vwant):
        fail(f"drafter qmatvec launches by variant {variants['qmatvec']}, "
             f"want {vwant}")
    return want


def _first_mismatch_margin(master, cfg, policy, prompts, spec, plain):
    """Where the spec and plain fp32 streams first differ: the row, the
    position, both tokens, and the top-2 margin of the target's logits
    there (prefill of the plain stream's prefix)."""
    import torch
    from repro_torch.models import api
    p = prompts.shape[1]
    diff = (spec != plain).nonzero()
    r, c = int(diff[0, 0]), int(diff[0, 1])
    with torch.no_grad():
        logits, _ = api.prefill(master, {"tokens": plain[r:r + 1, :c]}, cfg,
                                policy=policy, dtype=torch.float32,
                                max_len=c)
    top = torch.topk(logits[0, -1].float(), 2).values
    return {"row": r, "new_token_index": c - p, "spec": int(spec[r, c]),
            "plain": int(plain[r, c]),
            "top2_margin": float(top[0] - top[1])}


def _fp32_engine_gates(master, cfg, dcfg, dparams, gp, greedy, device):
    """The fp32 engines against greedy generate on the gate's prompts: the
    captured spec engine must serve greedy's tokens, and the captured plain
    engine its capture=False twin's (both also compared with greedy)."""
    import torch
    from repro_torch.core.precision import FLOAT
    from repro_torch.serving.engine import ServingEngine
    n, plen, new = (SPEC_GATE[k] for k in ("prompts", "prompt_len",
                                           "max_new"))
    want = greedy[:, plen:].tolist()
    kw = dict(policy=FLOAT, slots=n, dtype=torch.float32, device=device)
    outs = {}
    for name, spec_k, capture in (("spec_captured", SPEC_K, None),
                                  ("plain_captured", 0, None),
                                  ("plain_eager", 0, False)):
        eng = ServingEngine(master, cfg, max_len=plen + new + spec_k,
                            spec_k=spec_k, draft_params=dparams,
                            draft_cfg=dcfg, capture=capture, **kw)
        for p in gp.tolist():
            eng.submit(p, max_new=new)
        outs[name] = [r.out for r in sorted(eng.run_all(),
                                            key=lambda r: r.uid)]
        if eng.fallback_events:
            fail(f"fp32 {name} engine: a degradation-ladder step with no "
                 f"injected fault: {eng.fallback_events}")
        del eng
    res = {"fp32_spec_engine_captured_equals_greedy":
           outs["spec_captured"] == want,
           "fp32_plain_engine_captured_equals_eager":
           outs["plain_captured"] == outs["plain_eager"],
           "fp32_plain_engine_equals_greedy": outs["plain_eager"] == want}
    return res


def spec_phase(cfg, master, params, device, qp_tok_s, rehearse):
    """Self-speculative serving at full width: the float master is the
    target (FLOAT policy), its packed 3-bit export the drafter."""
    import torch
    from repro_torch.core.precision import FLOAT
    from repro_torch.launch.profile_engine import MAX_NEW, prompts
    from repro_torch.launch.serve import cast_weights
    from repro_torch.models import api
    from repro_torch.serving.engine import ServingEngine, generate
    dcfg, dparams = api.draft_of(cfg, params)       # already the qp export
    target = cast_weights(master, torch.bfloat16)
    reqs = prompts(cfg.vocab_size)
    kw = dict(policy=FLOAT, slots=8, max_len=512, dtype=torch.bfloat16,
              device=device)

    def make(capture):
        return ServingEngine(target, cfg, spec_k=SPEC_K, draft_params=dparams,
                             draft_cfg=dcfg, capture=capture, **kw)
    engines = {"captured": _warmed(make(None), reqs),
               "eager": _warmed(make(False), reqs)}
    runs = {name: _serve(e, reqs, device) for name, e in engines.items()}
    eng, run = engines["captured"], runs["captured"]
    done = run["done"]
    toks = sum(len(r.out) for r in done)
    if len(done) != len(reqs) or any(len(r.out) != MAX_NEW for r in done):
        fail(f"spec engine did not serve every request its {MAX_NEW} tokens")
    if any(not 0 <= t < cfg.vocab_size for r in done for t in r.out):
        fail("spec engine emitted a token id outside the vocabulary")
    _twin_gate(runs, "spec")
    want = _spec_launch_gate(eng, cfg, dcfg, run, rehearse)
    _spec_launch_gate(engines["eager"], cfg, dcfg, runs["eager"], rehearse)
    hist: dict = {}
    for r in done:
        for n, c in r.accept_hist.items():
            hist[n] = hist.get(n, 0) + c
    eng0 = _warmed(ServingEngine(target, cfg, **kw), reqs)
    base = _serve(eng0, reqs, device)
    del eng0
    same = sum(a.out == b.out for a, b in zip(done, base["done"])) / len(done)
    slot_ticks = sum(r.ticks for r in done)
    steady = {name: _steady(e, cfg, device, rehearse, names=ENGINE_KERNELS)
              for name, e in engines.items()}
    del engines, eng, target
    out = {"phase": "spec", "target": "float master, FLOAT policy, bf16 "
                                      "weights (cast once)",
           "drafter": f"draft_of: qp export, {dcfg.num_layers} layers",
           "spec_k": SPEC_K, "requests": len(done), **_run_line(run),
           "eager_twin": _run_line(runs["eager"]),
           "captured_eager_token_identical": True,
           "tokens_per_tick": toks / run["ticks"],
           "tokens_per_slot_tick": sum(len(r.out) - 1 for r in done)
           / slot_ticks,
           "spec_accept_rate": run["spec_accepted"] / run["spec_drafted"],
           "spec_drafted": run["spec_drafted"],
           "spec_accepted": run["spec_accepted"],
           "accept_hist_tokens_per_tick": dict(sorted(hist.items())),
           "plain_float_engine_tok_per_s": _run_line(base)["tok_per_s"],
           "plain_float_engine_ticks": base["ticks"],
           "qp_engine_tok_per_s": round(qp_tok_s, 2),
           "bf16_share_of_requests_matching_plain_engine": same,
           "launches": run["launches"], "launches_want": want,
           "launches_by_variant": run["variants"],
           "plain_calls": run["plain"], "steady": steady}
    # fp32 token identity: speculative and plain greedy generate on the
    # fp32 master (TF32 off), every attn_prefill on the simt kernel; then
    # the fp32 engines, captured, against greedy and their eager twin
    n, plen, new = (SPEC_GATE[k] for k in ("prompts", "prompt_len",
                                           "max_new"))
    gp = torch.tensor([r[:plen] for r in reqs[-n:]], dtype=torch.int32)
    gkw = dict(policy=FLOAT, max_new_tokens=new, dtype=torch.float32,
               device=device)
    reset_counts()
    spec = generate(master, gp, cfg, spec_k=SPEC_K, draft_params=dparams,
                    draft_cfg=dcfg, **gkw).cpu()
    launches32, plain32 = read_counts()
    variants32 = read_variants()
    greedy = generate(master, gp, cfg, **gkw).cpu()
    out.update({"fp32_gate": f"generate(spec_k={SPEC_K}) == greedy "
                             f"generate, {n} prompts x {new} new tokens, "
                             "fp32 activations, TF32 off",
                "fp32_token_identical": bool(torch.equal(spec, greedy)),
                "fp32_attn_prefill_by_variant": variants32["attn_prefill"],
                "fp32_attn_prefill_merges": variants32[SIMT_MERGE]["merge"]})
    if not torch.equal(spec, greedy):
        out["fp32_first_mismatch"] = _first_mismatch_margin(
            master, cfg, FLOAT, gp.to(device), spec.to(device),
            greedy.to(device))
    out.update(_fp32_engine_gates(master, cfg, dcfg, dparams, gp, greedy,
                                  device))
    emit(out)
    if not torch.equal(spec, greedy):
        fail(f"fp32 spec stream differs from greedy: "
             f"{out['fp32_first_mismatch']}")
    if not out["fp32_spec_engine_captured_equals_greedy"]:
        fail("the captured fp32 spec engine's tokens differ from greedy")
    if not out["fp32_plain_engine_captured_equals_eager"]:
        fail("the captured fp32 engine's tokens differ from its eager twin")
    if not rehearse:
        if max(plain32.values()) != 0:
            fail(f"a plain version ran on the fp32 spec path: {plain32}")
        if not 0 < variants32["attn_prefill"]["simt"] \
                == launches32["attn_prefill"]:
            fail(f"an fp32 verify or admission did not run the simt "
                 f"attn_prefill: {variants32}")
    return run["launches"], run["variants"]


def quarantine_phase(cfg, params, device, rehearse):
    """NaN logits in one slot of the captured qp engine: the FaultPlan
    poisons slot 3 at tick 2 of 8 requests x 8 tokens. That request must
    finish "poisoned" with the tokens it had, the other seven "ok" with all
    theirs, poisoned_count 1, statuses and tokens equal to the eager
    twin's under the same plan."""
    import torch
    from repro_torch.core.precision import W3A8
    from repro_torch.launch.profile_engine import prompts
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.resilience import FaultPlan
    reqs, new, plan = prompts(cfg.vocab_size)[:8], 8, FaultPlan([(2, 3)])
    runs = {}
    for name, capture in (("captured", None), ("eager", False)):
        eng = ServingEngine(params, cfg, policy=W3A8, slots=8, max_len=512,
                            dtype=torch.bfloat16, fault_plan=plan,
                            capture=capture, device=device)
        run = _serve(eng, reqs, device, max_new=new)
        run["poisoned_count"] = eng.poisoned_count
        runs[name] = run
        del eng
    run = runs["captured"]
    statuses = [r.status for r in run["done"]]
    out = {"phase": "quarantine", "fault_plan": "nan_logits {(tick 2, "
                                                 "slot 3)}",
           "requests": len(run["done"]), "statuses": statuses,
           "tokens_by_request": [len(r.out) for r in run["done"]],
           "poisoned_count": run["poisoned_count"],
           "captures": run["captures"],
           "eager_twin_statuses": [r.status for r in runs["eager"]["done"]]}
    emit(out)
    if statuses.count("poisoned") != 1 or run["poisoned_count"] != 1 \
            or statuses.count("ok") != len(reqs) - 1:
        fail(f"quarantine: statuses {statuses}, poisoned_count "
             f"{run['poisoned_count']}")
    bad = next(r for r in run["done"] if r.status == "poisoned")
    if not 0 < len(bad.out) < new or any(
            len(r.out) != new for r in run["done"] if r.status == "ok"):
        fail(f"quarantine: tokens by request {out['tokens_by_request']}")
    _twin_gate(runs, "quarantine", replay_only=False)


# --- phase 6 ----------------------------------------------------------------------

def paper_phase(device, rehearse):
    """The paper's 3-step experiment for the digit net, epochs cut."""
    import math

    import torch
    from repro_torch.paper.pipeline import PaperRunConfig, run_paper_experiment
    hidden = (64, 64, 64) if rehearse else None        # None: 1022 x 3
    rc = PaperRunConfig(task="digit", hidden=hidden, **PAPER_EPOCHS)
    log = lambda line: print(line, file=sys.stderr, flush=True)  # noqa: E731
    # the eager twin first, then the captured run, whose counts are read
    t0 = time.perf_counter()
    eager = run_paper_experiment(rc, device=device, log=log, capture=False)
    eager_wall = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    m = run_paper_experiment(rc, device=device, log=log)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = read_counts()
    params = m.pop("params")
    eager.pop("params")
    same = {k: m[k] == eager[k] for k in ("float_mcr", "direct_quant_mcr",
                                          "w3a8_mcr", "float_final_loss",
                                          "retrain_final_loss")}
    ratio = m["weight_bytes_float"] / m["weight_bytes_packed"]
    emit({"phase": "paper", "task": "digit",
          "net": "784-" + "-".join(map(str, hidden or (1022,) * 3)) + "-10",
          "batch": rc.batch, "lr": rc.lr, "momentum": rc.momentum,
          "reduced": f"epochs only: RBM {rc.pretrain_epochs}/layer, float "
                     f"{rc.float_epochs}, retrain {rc.retrain_epochs} "
                     "(paper: 50 / 100 / 100)",
          **m, "weight_ratio": ratio, "wall_s": round(wall, 3),
          "eager_twin": {"wall_s": round(eager_wall, 3),
                         "float_train_s": eager["float_train_s"],
                         "retrain_s": eager["retrain_s"],
                         "train_step_captures": eager["train_step_captures"]},
          "captured_equals_eager": same,
          "w3a8_vs_direct": "reported, not gated at this epoch count",
          "launches": launches, "plain_calls": plain})
    if not all(same.values()):
        fail(f"the captured training steps differ from the eager ones: {same}")
    if not rehearse and m["train_step_captures"] != 2:
        fail(f"the float and retraining steps made "
             f"{m['train_step_captures']} captures, want one each")
    losses = (m["float_final_loss"], m["retrain_final_loss"])
    if not all(math.isfinite(v) for v in losses):
        fail(f"non-finite training loss: {losses}")
    if not m["float_mcr"] < 35.0:
        fail(f"float MCR {m['float_mcr']} >= 35%")
    if not m["packed_max_err"] < 1e-4:
        fail(f"packed vs fake-quant logits differ by {m['packed_max_err']}")
    if not ratio > 8.0:
        fail(f"packed weights only {ratio:.2f}x smaller than fp32")
    if not rehearse and max(plain.values()) != 0:
        fail(f"a plain version ran on the paper path: {plain}")
    return params, m, launches


# --- phase 7 ----------------------------------------------------------------------

def _mcr(params, task, policy, device):
    import torch
    from repro_torch.models import dnn
    from repro_torch.training.losses import accuracy
    with torch.no_grad():
        accs = [float(accuracy(dnn.forward(params, x, policy=policy,
                                           sigmoid_mode="pw"), y))
                for x, y in task.batches("test", 500, device=device)]
    return 100.0 * (1.0 - sum(accs) / len(accs))


def _layerwise(served, cpu, x, policy):
    """Each layer of the deployed forward on the card (qmatvec or qmatmul,
    then sigmoid_pw) against its plain version on the CPU, both fed the
    card's input to that layer. Returns each layer's max abs error and the
    card's logits at the end of this chain."""
    import torch
    from repro_torch.core import quant_dense
    from repro_torch.kernels.sigmoid_pw import ops as sig_ops
    from repro_torch.kernels.sigmoid_pw.ref import sigmoid_pw_fwd
    names = [f"fc{i}" for i in range(len(served) - 1)] + ["head"]
    h, errs = x, {}
    with torch.no_grad():
        for name in names:
            role = "output" if name == "head" else "hidden"
            y = quant_dense.apply(served[name], h, policy=policy, role=role)
            ref = quant_dense.apply(cpu[name], h.cpu(), policy=policy,
                                    role=role)
            errs[name] = compare(y.cpu(), ref, "float32",
                                 f"deploy layer {name}")
            if name != "head":
                h = sig_ops.sigmoid_pw(y)
                compare_exact(h.cpu(), sigmoid_pw_fwd(y.cpu()),
                              f"deploy sigmoid_pw after {name}")
    return errs, y


def _e2e_gate(name, card, plain, card_a8, plain_a8, head):
    """End-to-end parity of the deployed forward with the CPU. With the
    8-bit signals off the logits must agree within 1e-4 x max|logit|, but
    for a few rows: the PLAN sigmoid jumps by 1/256 at |x| = 2.375, so a
    pre-activation that the two sides round to either side of the break
    moves a row. No row may move by more than that jump can move it, if
    every unit of the last hidden layer jumped: (1/256) x max_j sum_i
    |W_head[i, j]|, plus the rounding. Greedy agreement >= 0.99; with the
    8-bit signals on (a level can flip at a rounding tie) all but a few
    rows must agree. Returns the numbers the gate read."""
    import torch
    batch = plain.shape[0]
    few = max(2, batch // 50)
    diff = (card - plain).abs()
    err, scale = float(diff.max()), float(plain.abs().max())
    w_head = head["q"].float().abs() * head["delta"].float().abs().reshape(-1)
    jump_bound = float(w_head.sum(0).max()) / 256 + 1e-4 * scale
    over = int((diff.amax(-1) > 1e-4 * scale).sum())
    agree = float((card.argmax(-1) == plain.argmax(-1)).float().mean())
    miss_a8 = int((card_a8.argmax(-1) != plain_a8.argmax(-1)).sum())
    if not bool(torch.isfinite(card).all()):
        fail(f"deploy {name}: non-finite logits")
    if over > few:
        fail(f"deploy {name}: {over} rows differ from the CPU by more than "
             f"1e-4 x max|logit| ({1e-4 * scale}); at most {few} may")
    if not err <= jump_bound:
        fail(f"deploy {name}: logits differ from the CPU by {err}, more "
             f"than the PLAN jump can explain ({jump_bound})")
    if not agree >= 0.99:
        fail(f"deploy {name}: greedy agreement with the CPU {agree} < 0.99")
    if miss_a8 > few:
        fail(f"deploy {name}: with 8-bit signals {miss_a8} rows' argmax "
             f"differ from the CPU; at most {few} may")
    return {"act_bits_none_max_abs_logit_diff": err,
            "max_abs_logit": scale,
            "act_bits_none_rows_over_1e-4_max_logit": over,
            "rows_allowed_over": few,
            "plan_jump_bound": jump_bound,
            "act_bits_none_greedy_agreement_vs_cpu": agree,
            "a8_greedy_agreement_vs_cpu": 1.0 - miss_a8 / batch}


def deploy_phase(digit_params, digit_mcr, device, seed, rehearse):
    """The W3A8 deployment of the paper's nets through the kernels."""
    import dataclasses

    import torch
    from repro_torch.core import quant_dense
    from repro_torch.core.precision import FLOAT, W3A8
    from repro_torch.data.synthetic import digit_task, phoneme_task
    from repro_torch.models import dnn
    width = 64 if rehearse else 1022
    gen = torch.Generator(device=device).manual_seed(seed)
    nets = {
        "digit": (digit_params, digit_task(seed=seed), 100),
        "phoneme": (dnn.init(gen, 429, (width,) * 4, 61, device=device),
                    phoneme_task(seed=seed), 128),
    }
    clock = Clock(device, reps=5 if rehearse else 50)
    no_a8 = dataclasses.replace(W3A8, act_bits=None)
    total = {k: 0 for k in _counters()}
    total_variants = {k: dict.fromkeys(v, 0) for k, v in read_variants().items()}
    out = {"phase": "deploy", "form": "export_container(W3A8): qp hidden, "
                                      "q head, per-channel deltas",
           "sigmoid_mode": "pw", "nets": {}}
    for name, (master, task, batch) in nets.items():
        served = quant_dense.export_container(master, W3A8)
        layers = len(master) - 1
        x = torch.from_numpy(task.test[0][:batch]).to(device)
        if device.type == "cuda":
            torch.cuda.synchronize()
        reset_counts()
        with torch.no_grad():
            logits = dnn.forward(served, x, policy=W3A8, sigmoid_mode="pw")
        if device.type == "cuda":
            torch.cuda.synchronize()
        launches, plain = read_counts()
        variants = read_variants()
        for k, v in launches.items():
            total[k] += v
        for k, split in variants.items():
            for key, v in split.items():
                total_variants[k][key] += v
        want = {"qmatvec": layers, "qmatmul": 1, "sigmoid_pw": layers}
        if not rehearse:
            if any(launches[k] != v for k, v in want.items()):
                fail(f"deploy {name}: launches {launches}, want {want}")
            if max(plain.values()) != 0:
                fail(f"deploy {name}: a plain version ran: {plain}")
            if variants["qmatmul"]["k_lanes"] != 1:
                fail(f"deploy {name}: the 8-bit head did not take the "
                     f"k_lanes layout: {variants}")
            if variants["qmatvec"] != {"decode": 0, "prefill": layers}:
                fail(f"deploy {name}: the hidden layers (M = {batch}) did "
                     f"not all take qmatvec's prefill tiles: {variants}")
        # parity with the CPU plain path on the same weights and inputs:
        # layer by layer (both fed the card's input to the layer), the
        # real forward against that chain bit for bit, then end to end
        cpu = {k: {kk: v.cpu() for kk, v in leaf.items()}
               for k, leaf in served.items()}
        layer_err, chain = _layerwise(served, cpu, x, no_a8)
        with torch.no_grad():
            card = dnn.forward(served, x, policy=no_a8, sigmoid_mode="pw")
            plain_out = dnn.forward(cpu, x.cpu(), policy=no_a8,
                                    sigmoid_mode="pw")
            plain_a8 = dnn.forward(cpu, x.cpu(), policy=W3A8,
                                   sigmoid_mode="pw")
        if logits.shape != (batch, task.num_classes) \
                or not bool(torch.isfinite(logits).all()):
            fail(f"deploy {name}: bad logits {tuple(logits.shape)}")
        if not torch.equal(card, chain):
            fail(f"deploy {name}: dnn.forward's logits differ from its "
                 f"layers' ({float((card - chain).abs().max())})")
        net = {"batch": batch, "launches": launches,
               "launches_by_variant": variants, "plain_calls": plain,
               "layerwise_max_abs_err": layer_err,
               "layerwise_tolerance": "1e-4 x the row's max|plain| per "
                                      "layer; sigmoid_pw bit-identical",
               "end_to_end_gate": "act_bits None: rows over 1e-4 x "
                                  "max|logit| <= rows_allowed_over, max "
                                  "diff <= plan_jump_bound, greedy >= 0.99; "
                                  "A8: greedy misses <= rows_allowed_over",
               **_e2e_gate(name, card.cpu(), plain_out, logits.cpu(),
                           plain_a8, cpu["head"])}
        if name == "digit":
            with torch.no_grad():
                x100 = x[:100]
                w3a8_ms = clock(lambda: dnn.forward(served, x100, policy=W3A8,
                                                    sigmoid_mode="pw"))
                float_ms = clock(lambda: dnn.forward(master, x100,
                                                     policy=FLOAT))
            net.update({
                "deployed_test_mcr": _mcr(served, task, W3A8, device),
                "w3a8_mcr_fake_quant_per_tensor": digit_mcr,
                "forward_ms_w3a8_kernels": w3a8_ms,
                "forward_ms_float": float_ms,
                "images_per_s_w3a8_kernels": 100 / (w3a8_ms / 1e3),
                "images_per_s_float": 100 / (float_ms / 1e3),
                "timing": "median of 50 CUDA-event timings of one forward, "
                          "batch 100" if not rehearse else
                          "host clock (CPU rehearsal, not device times)"})
        out["nets"][name] = net
    emit(out)
    return total, total_variants


# --- main -------------------------------------------------------------------------

# --- phase 8 ----------------------------------------------------------------------

def dense_phase(device, seed, rehearse):
    """The rest of the dense family: each model of DENSE built from a
    seeded generator on the card, exported to W3A8 containers (the fp32
    master freed after the export), served for DENSE_REQUESTS requests x
    DENSE_NEW tokens by ServingEngine(slots=8, max_len=512, bf16 KV)
    captured and as its capture=False twin, gated as the engine phase
    gates (identical tokens, replay only, every kernel launched in the
    variant its plan gives, every readout of the untied head in qmatmul's
    k_lanes layout), then the path check and each twin's steady tick.
    Returns the summed launches and variants of the captured runs."""
    import dataclasses
    import gc

    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.precision import W3A8
    from repro_torch.launch.profile_engine import prompts
    from repro_torch.serving.engine import ServingEngine
    launches, variants = None, None
    models = []
    for arch, layers, small in DENSE:
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        cfg = get_config(arch)
        full = cfg.num_layers
        if rehearse:
            cfg = reduced(cfg, **small)
        elif layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        master, params, build_s = build_model(cfg, device, seed)
        del master
        gc.collect()
        reqs = [p for i, p in enumerate(prompts(cfg.vocab_size))
                if i in DENSE_PROMPTS]
        what = f"dense {arch}"

        def make(capture):
            return ServingEngine(params, cfg, policy=W3A8, slots=8,
                                 max_len=512, dtype=torch.bfloat16,
                                 capture=capture, device=device)
        engines = {"captured": _warmed(make(None), reqs),
                   "eager": _warmed(make(False), reqs)}
        runs = {name: _serve(eng, reqs, device, max_new=DENSE_NEW)
                for name, eng in engines.items()}
        run = runs["captured"]
        done = run["done"]
        if len(done) != len(reqs) or any(len(r.out) != DENSE_NEW
                                         for r in done):
            fail(f"{what}: not every request got its {DENSE_NEW} tokens")
        _twin_gate(runs, what)
        if not rehearse:
            for name, eng in engines.items():
                _engine_launch_gate(eng, cfg, runs[name], f"{what} {name}")
            if runs["eager"]["launches"] != run["launches"] \
                    or runs["eager"]["variants"] != run["variants"]:
                fail(f"{what}: replayed launches {run['variants']} differ "
                     f"from the eager twin's {runs['eager']['variants']}")
        cut = (f"depth {cfg.num_layers} of {full}; widths as published"
               if cfg.num_layers < full else "none")
        if rehearse:
            cut = f"CPU rehearsal: reduced({small})"
        rec = {"arch": arch, "layers": cfg.num_layers, "full_layers": full,
               "cut": cut,
               "d_model": cfg.d_model, "heads": cfg.num_heads,
               "kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
               "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
               "qkv_bias": cfg.qkv_bias, "qk_norm": cfg.qk_norm,
               "tie_embeddings": cfg.tie_embeddings,
               "init_export_s": round(build_s, 3),
               "requests": len(done), **_run_line(run),
               "eager_twin": _run_line(runs["eager"]),
               "captured_eager_token_identical": True,
               "launches": run["launches"],
               "launches_by_variant": run["variants"],
               "plain_calls": run["plain"]}
        rec["steady"] = {name: _steady(e, cfg, device, rehearse,
                                       names=("qmatvec", "qmatmul",
                                              "attn_decode"))
                         for name, e in engines.items()}
        del engines, runs
        rec["path"] = _path_check(cfg, params, device)
        if device.type == "cuda":
            rec["peak_gb"] = round(torch.cuda.max_memory_allocated() / 1e9, 2)
        models.append(rec)
        if launches is None:
            launches, variants = run["launches"], run["variants"]
        else:
            launches = {k: launches[k] + v for k, v in run["launches"].items()}
            variants = {n: {k: variants[n][k] + c for k, c in d.items()}
                        for n, d in run["variants"].items()}
        del params, run
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    emit({"phase": "dense", "engine": "ServingEngine(slots=8, max_len=512, "
          "bf16, kv bf16), W3A8 qp export of a seeded fp32 master",
          "requests": f"{len(DENSE_PROMPTS)} x {DENSE_NEW} new tokens",
          "models": models})
    return launches, variants


# --- phase 9 ----------------------------------------------------------------------

def _admission_log(eng):
    """Log ``eng``'s admissions from now on: the tokens of each admission
    forward (slots x bucket for a round, the prompt's length for a solo
    admission) and the solo prompts' lengths."""
    log = {"tokens": [], "solo": []}
    batch, solo = eng._admit_batch, eng._admit_solo

    def _batch(slot_ids, reqs, bucket):
        log["tokens"].append(eng.slots * bucket)
        return batch(slot_ids, reqs, bucket)

    def _solo(slot, req):
        log["tokens"].append(len(req.admit_prompt))
        log["solo"].append(len(req.admit_prompt))
        return solo(slot, req)
    eng._admit_batch, eng._admit_solo = _batch, _solo
    return log


def _moe_launch_gate(eng, cfg, run, admitted, what):
    """The MoE engine's launch gates over one serve: every kernel of the
    path launched and no plain version ran; per forward (each tick, each
    admission of ``admitted`` tokens) L router products in qmatmul's
    row-major k_lanes, one readout in its K-major k_lanes, 3 E L expert
    products in n_lanes in the variant its plan gives for the forward's
    capacity M (decode for M <= 16), 4 L qmatvec launches in the variant
    its plan gives for the forward's tokens; L wgmma attn_prefill an
    admission and L attn_decode a tick."""
    import torch
    from repro_torch.kernels.qmatmul import kernel as qmm_k
    from repro_torch.kernels.qmatvec import kernel as qmv_k
    from repro_torch.models.moe import groups
    launches, plain, v = run["launches"], run["plain"], run["variants"]
    if min(launches[k] for k in ENGINE_KERNELS) <= 0:
        fail(f"{what}: a kernel of the engine path never launched: {launches}")
    if max(plain.values()) != 0:
        fail(f"{what}: a plain version ran on the engine path: {plain}")
    if len(admitted) != run["rounds"]:
        fail(f"{what}: {len(admitted)} admissions logged, {run['rounds']} "
             f"rounds counted")
    n_l, e, d, f = cfg.num_layers, cfg.num_experts, cfg.d_model, cfg.d_ff
    fwd = [eng.slots] * run["ticks"] + list(admitted)
    experts = dict.fromkeys(("decode", "prefill"), 0)
    qmv = dict.fromkeys(("decode", "prefill"), 0)
    for t in fwd:
        ng, _, cap = groups(cfg, t)
        for k, n, times in ((d, f, 2), (f, d, 1)):        # up, gate; down
            experts[qmm_k.plan(ng * cap, k, n, n, 1, torch.bfloat16)
                    .variant] += times * e * n_l
        qmv[qmv_k.plan(t, d, d, torch.bfloat16).variant] += 4 * n_l
    want = {"qmatmul": {"n_lanes": 3 * e * n_l * len(fwd),
                        "k_lanes": (n_l + 1) * len(fwd)},
            K_LANES: {"k_major": len(fwd), "row_major": n_l * len(fwd)},
            N_LANES: experts, "qmatvec": qmv,
            "attn_prefill": {"wgmma": n_l * run["rounds"], "simt": 0}}
    got = {k: v[k] for k in want}
    if got != want:
        fail(f"{what}: launches by variant {got}, want {want}")
    if launches["attn_decode"] != n_l * run["ticks"]:
        fail(f"{what}: {launches['attn_decode']} attn_decode launches for "
             f"{run['ticks']} ticks of {n_l} layers")


def _moe_path_runs(cfg, params, device, toks, max_len, lengths):
    """Prefill of ``toks`` (B, T) and MOE_PATH_STEPS decode steps in fp32
    activations, no activation quant, through the kernels and through the
    plain versions on the same weights (the plain run is fed the kernel
    run's greedy tokens), the routing of every MoE call recorded. Returns
    {"kernel" / "plain": (last-position logits (steps + 1, B, V), the
    routing trace)}."""
    import dataclasses

    import torch
    from repro_torch.core.precision import W3A8
    from repro_torch.models import api, moe
    policy = dataclasses.replace(W3A8, act_bits=None)
    runs, feed = {}, None
    for name, mm, am in (("kernel", "kernel", "kernel"),
                         ("plain", "dequant", "ref")):
        kw = dict(policy=policy, dtype=torch.float32, matmul_mode=mm,
                  attn_mode=am)
        with moe.trace_routing() as trace:
            logits, cache = api.prefill(params, {"tokens": toks}, cfg,
                                        max_len=max_len, lengths=lengths,
                                        **kw)
            steps, seq = [logits], feed or []
            for i in range(MOE_PATH_STEPS):
                if feed is None:
                    seq.append(steps[-1][:, -1].argmax(-1).to(
                        torch.int32)[:, None])
                logits, cache = api.decode_step(params, cache, seq[i], cfg,
                                                **kw)
                steps.append(logits)
        feed = seq
        runs[name] = (torch.stack([s_[:, -1] for s_ in steps]), list(trace))
    return runs


def _moe_path_compare(cfg, runs, b, t, what):
    """The kernel run against the plain run, routing first, call by call.
    A token whose top-k experts differ (a flip) in a row that no earlier
    flip reached is accepted only where the plain path's probabilities of
    the experts the two paths chose, at each choice where they differ,
    differ by under 1e-5; each is reported. The kept mask must agree in
    every group without a flip or a tainted row. A flip, or a kept mask
    that differs, taints every row of its group from then on (capacity
    couples the rows of a group; attention carries the taint down the
    row). Then the logits of every (step, row) left untainted must agree
    within 2e-3 x max|logit|; at least one must be left."""
    import torch
    (a, ta), (p, tp) = runs["kernel"], runs["plain"]
    n_l = cfg.num_layers
    calls = (1 + MOE_PATH_STEPS) * n_l
    if len(ta) != len(tp) or len(ta) != calls:
        fail(f"{what}: {len(ta)} / {len(tp)} MoE calls traced, want {calls}")
    tainted = torch.zeros(b, dtype=torch.bool)
    flips, downstream, ok_rows = [], 0, []
    for i, (rk, rp) in enumerate(zip(ta, tp)):
        step, layer = divmod(i, n_l)
        ki, pi = rk["top_i"].cpu(), rp["top_i"].cpu()
        ng, g = ki.shape[:2]
        rows = torch.arange(ng * g).reshape(ng, g) // (t if step == 0 else 1)
        flipped = (ki != pi).any(-1)                             # (ng, g)
        clean = ~tainted[rows]                                   # (ng, g)
        probs = rp["probs"].cpu()
        for grp, tok in (flipped & clean).nonzero().tolist():
            at = ki[grp, tok] != pi[grp, tok]
            pr = probs[grp, tok]
            margin = float((pr[ki[grp, tok][at]]
                            - pr[pi[grp, tok][at]]).abs().max())
            flips.append({"step": step, "layer": layer, "group": grp,
                          "token": tok, "row": int(rows[grp, tok]),
                          "kernel_experts": ki[grp, tok].tolist(),
                          "plain_experts": pi[grp, tok].tolist(),
                          "margin": margin})
            if not margin < 1e-5:
                fail(f"{what}: routing flip at step {step} layer {layer} "
                     f"row {int(rows[grp, tok])} with margin {margin} "
                     f">= 1e-5")
        downstream += int((flipped & ~clean).sum())
        g_flip = flipped.any(-1)                                 # (ng,)
        g_keep = (rk["keep"].cpu() != rp["keep"].cpu()).flatten(1).any(-1)
        if bool((g_keep & ~g_flip & clean.all(-1)).any()):
            fail(f"{what}: the kept mask differs at step {step} layer "
                 f"{layer} in a group without a routing flip or a tainted "
                 f"row")
        tainted[rows[g_flip | g_keep].flatten()] = True
        if layer == n_l - 1:
            ok_rows.append(~tainted.clone())
    ok = torch.stack(ok_rows).to(a.device)                       # (steps, B)
    rec = {"routing_flips": flips, "flips_in_tainted_rows": downstream,
           "moe_calls_compared": len(ta),
           "logit_rows_compared": int(ok.sum()),
           "logit_rows": int(ok.numel())}
    if not bool(ok.any()):
        fail(f"{what}: routing flips left no (step, row) to compare: "
             f"{flips}")
    a, p = a[ok].float(), p[ok].float()
    if not (a.isfinite().all() and p.isfinite().all()):
        fail(f"{what}: non-finite logits on the path-parity run")
    err, scale = float((a - p).abs().max()), float(p.abs().max())
    rec.update(max_abs_logit_diff=err, max_abs_logit=scale,
               greedy_agreement=float(
                   (a.argmax(-1) == p.argmax(-1)).float().mean()))
    if not err <= 2e-3 * scale:
        fail(f"{what}: kernel path vs plain path logits differ by {err} "
             f"(> 2e-3 x {scale})")
    return rec


def _moe_path_check(cfg, params, device, max_len):
    """The kernel path against the plain path (``_moe_path_runs``,
    ``_moe_path_compare``): 8 prompts that fill a 64-token bucket (no
    padded query, whose attention differs between the two paths and whose
    hidden state would take expert capacity); and, on a sliding-window
    ring of the engine's ``max_len``, two unpadded prompts of the window
    plus one routing group (4608 tokens on mixtral's 4096-slot ring: the
    windowed prefill, kept and rolled into the ring, 18 groups of 512),
    whose decode steps write past the wrap."""
    import torch
    from repro_torch.models import moe
    from repro_torch.models.transformer import cache_len_for
    t = min(MOE_BUCKET, cfg.sliding_window or MOE_BUCKET)
    cases = [("full bucket", 8, t, t + 32, True)]
    if cfg.sliding_window:
        w = cfg.sliding_window
        cases.append(("ring", 2, w + min(moe.GROUP_SIZE, w), max_len, False))
    out = []
    for label, b, t, ml, padded in cases:
        toks = torch.tensor([[(7 * i + 3 * j) % (cfg.vocab_size - 1) + 1
                              for j in range(t)] for i in range(b)],
                            dtype=torch.int32, device=device)
        lengths = (torch.full((b,), t, dtype=torch.int32, device=device)
                   if padded else None)
        runs = _moe_path_runs(cfg, params, device, toks, ml, lengths)
        rec = {"case": label, "prompts": f"{b} x {t} tokens",
               "cache_len": cache_len_for(cfg, ml),
               "activations": "float32", "act_bits": None,
               "steps": f"prefill + {MOE_PATH_STEPS} decode",
               "tolerance": "2e-3 x max|logit| over untainted (step, row); "
                            "a routing flip only where the probabilities "
                            "at stake differ by < 1e-5",
               **_moe_path_compare(cfg, runs, b, t,
                                   f"{cfg.name} path check, {label}")}
        del runs
        out.append(rec)
    return out


def moe_phase(device, seed, rehearse):
    """The MoE family and the sliding-window ring at full width:
    phi3.5-moe (8 of 32 layers) and mixtral-8x22b (4 of 56 layers), each
    from a seeded generator on the card, exported to W3A8 containers (the
    expert stacks as int8 levels; the fp32 master freed after the export),
    served by ServingEngine(slots=8, bf16, kv bf16; max_len 512, and 8192
    for mixtral, whose cache is then a 4096-slot ring) captured and as its
    capture=False twin: phi3.5-moe 8 requests x MOE_NEW tokens; mixtral
    four short prompts, one of MOE_WRAP[0] tokens admitted in the 4096
    bucket that decodes past slot 4095, and one of MOE_SOLO[0] tokens
    admitted solo past the bucket cap. Gated: identical tokens, replay
    only, every launch in the variant its plan gives (every expert product
    in n_lanes, every router in the row-major k_lanes), no plain version,
    the same launches in both twins; for mixtral at least one solo
    admission and a ring that wrapped. Then each twin's steady tick and the
    MoE path check. Returns the summed launches and variants of the
    captured runs."""
    import dataclasses
    import gc

    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.precision import W3A8
    from repro_torch.launch.profile_engine import prompts
    from repro_torch.models.transformer import cache_len_for
    from repro_torch.serving.engine import ServingEngine
    launches, variants = None, None
    models = []
    for arch, layers, max_len in MOE:
        cfg = get_config(arch)
        full = cfg.num_layers
        wrap, solo = MOE_WRAP, MOE_SOLO
        if rehearse:
            cfg = reduced(cfg)
            if cfg.sliding_window:
                max_len, wrap, solo = 128, (28, 12), (40, 8)
        else:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        cs = cache_len_for(cfg, max_len)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        master, params, build_s = build_model(cfg, device, seed)
        build_gb = (round(torch.cuda.max_memory_allocated() / 1e9, 2)
                    if device.type == "cuda" else None)
        del master
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        base = [p for i, p in enumerate(prompts(cfg.vocab_size))
                if i in DENSE_PROMPTS]
        reqs, news = base, [MOE_NEW] * len(base)
        if cfg.sliding_window:
            longs = [[(5 * j + 11 * i) % (cfg.vocab_size - 1) + 1
                      for j in range(n)] for i, (n, _) in
                     enumerate((wrap, solo))]
            reqs = base[:4] + longs
            news = [MOE_NEW] * 4 + [wrap[1], solo[1]]
        what = f"moe {arch}"

        def make(capture):
            return ServingEngine(params, cfg, policy=W3A8, slots=8,
                                 max_len=max_len, dtype=torch.bfloat16,
                                 capture=capture, device=device)
        engines = {"captured": _warmed(make(None), reqs),
                   "eager": _warmed(make(False), reqs)}
        logs = {name: _admission_log(e) for name, e in engines.items()}
        runs = {name: _serve(e, reqs, device, max_new=news)
                for name, e in engines.items()}
        run = runs["captured"]
        done = run["done"]
        if [len(r.out) for r in done] != news:
            fail(f"{what}: not every request got its tokens: "
                 f"{[len(r.out) for r in done]} of {news}")
        _twin_gate(runs, what)
        ring = {}
        if cfg.sliding_window:
            for name, e in engines.items():
                ring[name] = {"solo_admissions": len(logs[name]["solo"]),
                              "max_slot_len": int(e.cache["len"].max()),
                              "cache_len": cs}
                if not logs[name]["solo"] or ring[name]["max_slot_len"] <= cs:
                    fail(f"{what} {name}: no solo admission or no slot past "
                         f"the {cs}-slot ring: {ring[name]}")
            if not any(len(r.prompt) <= cs < len(r.prompt) + len(r.out)
                       for r in done):
                fail(f"{what}: no bucketed request decoded past the ring")
        if not rehearse:
            for name, e in engines.items():
                _moe_launch_gate(e, cfg, runs[name], logs[name]["tokens"],
                                 f"{what} {name}")
            if runs["eager"]["launches"] != run["launches"] \
                    or runs["eager"]["variants"] != run["variants"]:
                fail(f"{what}: replayed launches {run['variants']} differ "
                     f"from the eager twin's {runs['eager']['variants']}")
        cut = (f"depth {cfg.num_layers} of {full}; widths as published"
               if not rehearse else "CPU rehearsal: reduced()")
        rec = {"arch": arch, "layers": cfg.num_layers, "full_layers": full,
               "cut": cut, "d_model": cfg.d_model, "d_ff": cfg.d_ff,
               "experts": cfg.num_experts, "top_k": cfg.experts_per_token,
               "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
               "head_dim": cfg.head_dim, "vocab": cfg.vocab_size,
               "sliding_window": cfg.sliding_window, "max_len": max_len,
               "cache_len": cs, "init_export_s": round(build_s, 3),
               "build_peak_gb": build_gb,
               "requests": [f"{len(p)} prompt + {n} new"
                            for p, n in zip(reqs, news)],
               **_run_line(run), "eager_twin": _run_line(runs["eager"]),
               "captured_eager_token_identical": True,
               "admission_tokens": list(logs["captured"]["tokens"]),
               "ring": ring,
               "launches": run["launches"],
               "launches_by_variant": run["variants"],
               "plain_calls": run["plain"]}
        rec["steady"] = {name: _steady(e, cfg, device, rehearse,
                                       names=("qmatvec", "qmatmul",
                                              "attn_decode"))
                         for name, e in engines.items()}
        del engines, runs
        rec["path"] = _moe_path_check(cfg, params, device, max_len)
        if device.type == "cuda":
            rec["peak_gb"] = round(torch.cuda.max_memory_allocated() / 1e9, 2)
        models.append(rec)
        if launches is None:
            launches, variants = run["launches"], run["variants"]
        else:
            launches = {k: launches[k] + v for k, v in run["launches"].items()}
            variants = {n: {k: variants[n][k] + c for k, c in d.items()}
                        for n, d in run["variants"].items()}
        del params, run
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    emit({"phase": "moe", "engine": "ServingEngine(slots=8, bf16, kv bf16), "
          "W3A8 qp export of a seeded fp32 master (expert stacks as int8 "
          "levels)", "models": models})
    return launches, variants


# --- phase 10 ---------------------------------------------------------------------

def _ssm_launch_gate(cfg, run, what, rehearse):
    """The plain engine's launches over one serve, from the forward's
    structure: each tick (M = slots) and each admission round (M = slots x
    bucket) runs every projection in qmatvec (ticks in its decode variant,
    admissions in its prefill one), one readout in qmatmul's k_lanes
    layout, and one attention launch a shared-block application (hybrid:
    attn_decode on a tick, the wgmma attn_prefill on an admission; none
    for ssm); no plain version. On the CPU rehearsal the plain versions
    take the same calls, so the formulas are checked there too."""
    launches, plain, variants = run["launches"], run["plain"], run["variants"]
    ticks, rounds = run["ticks"], run["rounds"]
    proj, att = _projections(cfg), attn_layers(cfg)
    want = {"qmatvec": proj * (ticks + rounds), "qmatmul": ticks + rounds,
            "attn_decode": att * ticks, "attn_prefill": att * rounds}
    seen = plain if rehearse else launches
    if {k: seen[k] for k in want} != want:
        fail(f"{what}: {'plain calls' if rehearse else 'launches'} {seen}, "
             f"want {want} ({ticks} ticks, {rounds} rounds)")
    if rehearse:
        return want
    if max(plain.values()) != 0:
        fail(f"{what}: a plain version ran: {plain}")
    vwant = {"decode": proj * ticks, "prefill": proj * rounds}
    if variants["qmatvec"] != vwant:
        fail(f"{what}: qmatvec launches by variant {variants['qmatvec']}, "
             f"want {vwant}")
    if variants["qmatmul"]["k_lanes"] != launches["qmatmul"]:
        fail(f"{what}: a readout did not take the k_lanes layout: {variants}")
    if variants["attn_prefill"]["wgmma"] != launches["attn_prefill"]:
        fail(f"{what}: an admission did not run the wgmma attn_prefill: "
             f"{variants}")
    return want


def _ssm_engines(cfg, params, device, reqs, kv_bits, rehearse):
    """The qp export served by ServingEngine(slots=8, max_len=512, bf16)
    captured and as its capture=False twin: identical tokens, replay only,
    the launch gates on both and the same launches in both, each twin's
    steady tick. Returns (record, the captured run)."""
    import torch
    from repro_torch.core.precision import W3A8
    from repro_torch.serving.engine import ServingEngine
    what = f"ssm {cfg.name} kv-{'int8' if kv_bits else 'bf16'}"

    def make(capture):
        return ServingEngine(params, cfg, policy=W3A8, slots=8, max_len=512,
                             dtype=torch.bfloat16, kv_bits=kv_bits,
                             capture=capture, device=device)
    engines = {"captured": _warmed(make(None), reqs),
               "eager": _warmed(make(False), reqs)}
    runs = {name: _serve(eng, reqs, device, max_new=SSM_NEW)
            for name, eng in engines.items()}
    run = runs["captured"]
    done = run["done"]
    if len(done) != len(reqs) or any(len(r.out) != SSM_NEW for r in done):
        fail(f"{what}: not every request got its {SSM_NEW} tokens")
    if any(not 0 <= t < cfg.vocab_size for r in done for t in r.out):
        fail(f"{what}: a token id outside the vocabulary")
    _twin_gate(runs, what)
    want = _ssm_launch_gate(cfg, run, f"{what} captured", rehearse)
    _ssm_launch_gate(cfg, runs["eager"], f"{what} eager", rehearse)
    if not rehearse and (runs["eager"]["launches"] != run["launches"]
                         or runs["eager"]["variants"] != run["variants"]):
        fail(f"{what}: replayed launches {run['variants']} differ from the "
             f"eager twin's {runs['eager']['variants']}")
    names = ("qmatvec", "qmatmul") + (("attn_decode",)
                                      if attn_layers(cfg) else ())
    rec = {"kv": "int8" if kv_bits else "bf16", "requests": len(done),
           **_run_line(run), "eager_twin": _run_line(runs["eager"]),
           "captured_eager_token_identical": True,
           "launches": run["launches"], "launches_want": want,
           "launches_by_variant": run["variants"], "plain_calls": run["plain"],
           "steady": {name: _steady(e, cfg, device, rehearse, names=names)
                      for name, e in engines.items()}}
    return rec, run


def _ssm_spec(cfg, master, params, device, rehearse):
    """The hybrid's speculative serving: the float master (weights cast
    once to bf16) verifies the drafts of its qp export, spec_k 4, captured
    and eager, gated as the spec phase gates (launches from the tick's
    structure, replay only, identical tokens); then the fp32 gate:
    generate(spec_k=4) on the fp32 master token-identical to greedy, the
    captured fp32 spec engine greedy's tokens, the captured fp32 plain
    engine its eager twin's. Returns (record, the captured run)."""
    import torch
    from repro_torch.core.precision import FLOAT
    from repro_torch.launch.profile_engine import prompts
    from repro_torch.launch.serve import cast_weights
    from repro_torch.models import api
    from repro_torch.serving.engine import ServingEngine, generate
    what = f"ssm {cfg.name} spec"
    dcfg, dparams = api.draft_of(cfg, params)       # already the qp export
    target = cast_weights(master, torch.bfloat16)
    allp = prompts(cfg.vocab_size)
    reqs = [p for i, p in enumerate(allp) if i in DENSE_PROMPTS]

    def make(capture):
        return ServingEngine(target, cfg, policy=FLOAT, slots=8, max_len=512,
                             dtype=torch.bfloat16, spec_k=SPEC_K,
                             draft_params=dparams, draft_cfg=dcfg,
                             capture=capture, device=device)
    engines = {"captured": _warmed(make(None), reqs),
               "eager": _warmed(make(False), reqs)}
    runs = {name: _serve(e, reqs, device, max_new=SSM_NEW)
            for name, e in engines.items()}
    run = runs["captured"]
    done = run["done"]
    if len(done) != len(reqs) or any(len(r.out) != SSM_NEW for r in done):
        fail(f"{what}: not every request got its {SSM_NEW} tokens")
    _twin_gate(runs, what)
    want = _spec_launch_gate(engines["captured"], cfg, dcfg, run, rehearse)
    _spec_launch_gate(engines["eager"], cfg, dcfg, runs["eager"], rehearse)
    del engines, target
    rec = {"target": "float master, FLOAT policy, bf16 weights (cast once)",
           "drafter": f"draft_of: qp export, {dcfg.num_layers} layers",
           "spec_k": SPEC_K, "requests": len(done), **_run_line(run),
           "eager_twin": _run_line(runs["eager"]),
           "captured_eager_token_identical": True,
           "spec_accept_rate": run["spec_accepted"] / run["spec_drafted"],
           "tokens_per_tick": sum(len(r.out) for r in done) / run["ticks"],
           "launches": run["launches"], "launches_want": want,
           "launches_by_variant": run["variants"], "plain_calls": run["plain"]}
    n, plen, new = (SPEC_GATE[k] for k in ("prompts", "prompt_len",
                                           "max_new"))
    gp = torch.tensor([r[:plen] for r in allp[-n:]], dtype=torch.int32)
    gkw = dict(policy=FLOAT, max_new_tokens=new, dtype=torch.float32,
               device=device)
    spec = generate(master, gp, cfg, spec_k=SPEC_K, draft_params=dparams,
                    draft_cfg=dcfg, **gkw).cpu()
    greedy = generate(master, gp, cfg, **gkw).cpu()
    rec.update({"fp32_gate": f"generate(spec_k={SPEC_K}) == greedy "
                             f"generate, {n} prompts x {new} new tokens, "
                             "fp32 activations, TF32 off",
                "fp32_token_identical": bool(torch.equal(spec, greedy))})
    if not torch.equal(spec, greedy):
        rec["fp32_first_mismatch"] = _first_mismatch_margin(
            master, cfg, FLOAT, gp.to(device), spec.to(device),
            greedy.to(device))
        emit({"phase": "ssm", "partial": rec})
        fail(f"{what}: fp32 spec stream differs from greedy: "
             f"{rec['fp32_first_mismatch']}")
    rec.update(_fp32_engine_gates(master, cfg, dcfg, dparams, gp, greedy,
                                  device))
    for key in ("fp32_spec_engine_captured_equals_greedy",
                "fp32_plain_engine_captured_equals_eager"):
        if not rec[key]:
            emit({"phase": "ssm", "partial": rec})
            fail(f"{what}: {key} is false")
    return rec, run


def _ssm_resilience(cfg, master, params, device, reqs):
    """Under capture: (1) the fp32 master (FLOAT policy, fp32 activations)
    serving 12 requests with preempt_after=SSM_PREEMPT — the first 8 slots
    preempted while 4 wait, re-admitted with their committed tokens —
    against the same engine undisturbed; (2) the qp export in bf16
    snapshotted at tick SSM_SNAPSHOT_TICK and restored into a fresh
    captured engine, which continues to the donor's tokens, the donor's
    being the uninterrupted run's. Tokens must be equal."""
    import tempfile

    import torch
    from repro_torch.core.precision import FLOAT, W3A8
    from repro_torch.launch.profile_engine import prompts
    from repro_torch.serving.engine import ServingEngine
    what = f"ssm {cfg.name} resilience"
    many = prompts(cfg.vocab_size)[:12]

    def serve32(**kw):
        eng = ServingEngine(master, cfg, policy=FLOAT, slots=8, max_len=512,
                            dtype=torch.float32, max_ticks=400,
                            device=device, **kw)
        for p in many:
            eng.submit(p, max_new=SSM_NEW)
        done = sorted(eng.run_all(), key=lambda r: r.uid)
        return [(r.status, r.out) for r in done], eng.preempt_count
    calm, _ = serve32()
    pre, n_pre = serve32(preempt_after=SSM_PREEMPT)
    if n_pre <= 0:
        fail(f"{what}: preempt_after={SSM_PREEMPT} preempted nothing")
    if pre != calm:
        i = next(i for i, (a, b) in enumerate(zip(pre, calm)) if a != b)
        fail(f"{what}: preempted request {i} served {pre[i]}, the "
             f"undisturbed engine {calm[i]}")

    def make():
        return ServingEngine(params, cfg, policy=W3A8, slots=8, max_len=512,
                             dtype=torch.bfloat16, device=device)
    with tempfile.TemporaryDirectory() as tmp:
        eng = make()
        for p in reqs:
            eng.submit(p, max_new=SSM_NEW)
        while eng.decode_calls < SSM_SNAPSHOT_TICK:
            eng.step()
        eng.snapshot(tmp)
        early = eng.drain()
        donor = sorted(early + eng.run_all(), key=lambda r: r.uid)
        fresh = make()
        fresh.restore(tmp)
        restored = sorted(early + fresh.run_all(), key=lambda r: r.uid)
        captures = fresh.captures
    plain = make()
    for p in reqs:
        plain.submit(p, max_new=SSM_NEW)
    calm_qp = [r.out for r in sorted(plain.run_all(), key=lambda r: r.uid)]
    if [r.out for r in restored] != [r.out for r in donor]:
        fail(f"{what}: the restored engine's tokens differ from the donor's")
    if [r.out for r in donor] != calm_qp:
        fail(f"{what}: the snapshotting engine's tokens differ from an "
             f"uninterrupted engine's")
    return {"preempt": {"engine": "fp32 master, FLOAT, fp32 activations, "
                                  "captured",
                        "requests": f"{len(many)} x {SSM_NEW} new tokens",
                        "preempt_after": SSM_PREEMPT,
                        "preemptions": n_pre,
                        "tokens_equal_undisturbed": True},
            "snapshot_restore": {"engine": "qp bf16, captured",
                                 "snapshot_tick": SSM_SNAPSHOT_TICK,
                                 "restored_captures": captures,
                                 "tokens_equal_uninterrupted": True}}


def ssm_phase(device, seed, rehearse):
    """The state-space and hybrid families at full width and depth: each
    model of SSM built from a seeded generator on the card and exported to
    W3A8 containers, served captured and as its capture=False twin (the
    hybrid also with an int8 KV cache), gated (``_ssm_launch_gate``),
    its path check; for the hybrid also speculative serving with the fp32
    gate (``_ssm_spec``) and the resilience case (``_ssm_resilience``).
    Returns the summed launches and variants of the captured runs."""
    import gc

    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.profile_engine import prompts
    t0 = time.perf_counter()
    launches, variants = None, None
    models = []

    def add(run):
        nonlocal launches, variants
        if launches is None:
            launches, variants = run["launches"], run["variants"]
            return
        launches = {k: launches[k] + v for k, v in run["launches"].items()}
        variants = {n: {k: variants[n][k] + c for k, c in d.items()}
                    for n, d in run["variants"].items()}
    for arch, small in SSM:
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        cfg = get_config(arch)
        full = cfg.num_layers
        if rehearse:
            cfg = reduced(cfg, **small)
        master, params, build_s = build_model(cfg, device, seed)
        if cfg.family == "ssm":
            del master
            master = None
            gc.collect()
        reqs = [p for i, p in enumerate(prompts(cfg.vocab_size))
                if i in DENSE_PROMPTS]
        rec = {"arch": arch, "family": cfg.family, "layers": cfg.num_layers,
               "full_layers": full,
               "cut": (f"CPU rehearsal: reduced({small})" if rehearse
                       else "none"),
               "d_model": cfg.d_model, "d_inner": cfg.d_inner,
               "ssm_heads": cfg.ssm_heads, "ssm_state": cfg.ssm_state,
               "vocab": cfg.vocab_size,
               "shared_block_applications": attn_layers(cfg),
               "projections_per_forward": _projections(cfg),
               "init_export_s": round(build_s, 3), "engines": []}
        for kv_bits in (None, 8) if cfg.family == "hybrid" else (None,):
            r, run = _ssm_engines(cfg, params, device, reqs, kv_bits,
                                  rehearse)
            rec["engines"].append(r)
            add(run)
        rec["path"] = _path_check(cfg, params, device)
        if master is not None:
            rec["spec"], run = _ssm_spec(cfg, master, params, device,
                                         rehearse)
            add(run)
            rec["resilience"] = _ssm_resilience(cfg, master, params, device,
                                                reqs)
        if device.type == "cuda":
            rec["peak_gb"] = round(torch.cuda.max_memory_allocated() / 1e9, 2)
        models.append(rec)
        del master, params
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    emit({"phase": "ssm", "engine": "ServingEngine(slots=8, max_len=512, "
          "bf16), W3A8 qp export of a seeded fp32 master",
          "requests": f"{len(DENSE_PROMPTS)} x {SSM_NEW} new tokens",
          "models": models, "seconds": round(time.perf_counter() - t0, 1)})
    return launches, variants


# --- phase 11 ---------------------------------------------------------------------

RES_COUNTERS = ("decode_calls", "prefill_calls", "shed_count",
                "deadline_miss_count", "preempt_count", "poisoned_count",
                "queue_peak", "spec_drafted", "spec_accepted",
                "snapshots_written", "journal_events", "replayed_events",
                "integrity_probes", "heal_count")
LADDER_STEPS = ("spec->plain", "kernel->fallback", "retry")
RES_FLIP = "layers/mlp/down/qp"       # the container leaf the flips hit


def _res_prompts(vocab, n, lens=(3, 4, 5, 6, 7, 8)):
    """``n`` short prompts (bucket 8), token ids in [1, vocab)."""
    return [[(7 * i + 3 * j) % (vocab - 1) + 1
             for j in range(lens[i % len(lens)])] for i in range(n)]


def _outcome(o):
    return (bool(o), o.uid, o.reason, tuple(o.shed))


def _res_record(eng, done):
    """What the captured engine and its eager twin must agree on."""
    return {"requests": sorted((r.uid, r.status, list(r.out), r.preemptions)
                               for r in done),
            "fallback_events": [list(e) for e in eng.fallback_events],
            **{k: getattr(eng, k) for k in RES_COUNTERS}}


def _by_kernel(counters, name):
    """{kernel: count} of the counters named ``name`` ("launches" of the
    kernels, "calls" of their plain versions) in a ``graphs`` counter
    dict."""
    return {mod.split(".")[2]: v for (mod, n), v in counters.items()
            if n == name}


def _res_run(make, drive, capture, device):
    """Counters zeroed, then ``drive(mk)`` with ``mk()`` building engines
    (``make(capture)``); counters read after. Returns the drive's result
    and the launches and plain calls, raw and net of the warm-ups (which
    launch for real but only in the captured twin)."""
    import gc

    import torch
    made = []

    def mk(**kw):
        eng = make(capture, **kw)
        made.append(eng)
        return eng
    reset_counts()
    out = drive(mk)
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches, plain = read_counts()
    variants = read_variants()
    warm_l, warm_p = {}, {}
    for eng in made:
        for k, v in _by_kernel(eng.graphs.warmup_launches,
                               "launches").items():
            warm_l[k] = warm_l.get(k, 0) + v
        for k, v in _by_kernel(eng.graphs.warmup_launches, "calls").items():
            warm_p[k] = warm_p.get(k, 0) + v
    caps = [dict(e.captures) for e in made]
    del made
    gc.collect()
    return {"out": out, "launches": launches, "plain": plain,
            "variants": variants, "captures": caps,
            "net": {k: v - warm_l.get(k, 0) for k, v in launches.items()},
            "net_plain": {k: v - warm_p.get(k, 0) for k, v in plain.items()}}


def _res_twins(what, make, drive, device, rehearse, *, ladder=False):
    """The case captured and as its capture=False twin: the same tokens,
    statuses, counters and fallback_events (everything the drive returns
    but its "_"-keys), the same launches and plain calls net of the
    warm-ups; no capture in the eager twin; no ladder step unless the case
    injects tick failures; on the card no plain version outside the
    ladder case."""
    runs = {name: _res_run(make, drive, capture, device)
            for name, capture in (("captured", None), ("eager", False))}
    a, b = runs["captured"], runs["eager"]
    pub = [{k: v for k, v in r["out"].items() if not k.startswith("_")}
           for r in (a, b)]
    if pub[0] != pub[1]:
        diff = [k for k in pub[0] if pub[0][k] != pub[1].get(k)]
        fail(f"resilience {what}: captured and eager twins differ in "
             f"{diff}: {[pub[0][k] for k in diff]} vs "
             f"{[pub[1][k] for k in diff]}")
    if (a["net"], a["net_plain"]) != (b["net"], b["net_plain"]):
        fail(f"resilience {what}: launches net of warm-ups "
             f"{a['net']} / plain {a['net_plain']} differ from the eager "
             f"twin's {b['net']} / {b['net_plain']}")
    if any(c["tick"] or c["admit"] for c in b["captures"]):
        fail(f"resilience {what}: the eager twin captured {b['captures']}")
    for r in (a, b):
        events = [e for rec in _records(r["out"])
                  for e in rec["fallback_events"]]
        if not ladder and any(e[1] in LADDER_STEPS for e in events):
            fail(f"resilience {what}: a ladder step without an injected "
                 f"tick failure: {events}")
        if not rehearse and not ladder and max(r["plain"].values()):
            fail(f"resilience {what}: a plain version ran: {r['plain']}")
    return runs


def _records(out):
    """Every engine record a drive returned."""
    return [v for k, v in sorted(out.items())
            if isinstance(v, dict) and "fallback_events" in v]


def _predict_shed(policy, waves, limit, slots):
    """The host's prediction of bounded admission for submits in
    ``waves`` with one step between waves (which admits up to ``slots``
    queued requests, one bucket): each submit's outcome, the shed uids,
    shed_count and queue_peak."""
    queue, outcomes, shed = [], [], []
    uid = count = peak = 0
    for i, n in enumerate(waves):
        if i:
            del queue[:slots]
        for _ in range(n):
            evicted = ()
            if len(queue) >= limit:
                count += 1
                if policy == "reject":
                    outcomes.append((False, None, "queue_full", ()))
                    continue
                evicted = (queue.pop(0),)
                shed.extend(evicted)
            uid += 1
            queue.append(uid)
            peak = max(peak, len(queue))
            outcomes.append((True, uid, None, evicted))
    return outcomes, shed, count, peak


def _res_admission(cfg, make_qp, device, rehearse):
    """Case 1: 24 requests in two waves of 12 (a step between) into
    queue_limit=8, "reject" and "drop_oldest": outcomes, shed uids,
    shed_count and queue_peak as the host predicts them."""
    reqs = _res_prompts(cfg.vocab_size, 24)
    rec, runs_all = {}, []
    for policy in ("reject", "drop_oldest"):
        def drive(mk):
            eng = mk(queue_limit=8, shed_policy=policy)
            outs = [_outcome(eng.submit(p, max_new=4)) for p in reqs[:12]]
            eng.step()
            outs += [_outcome(eng.submit(p, max_new=4)) for p in reqs[12:]]
            return {"run": _res_record(eng, eng.run_all(max_ticks=100)),
                    "outcomes": outs}
        runs = _res_twins(f"admission {policy}", make_qp, drive, device,
                          rehearse)
        runs_all.append(runs["captured"])
        got = runs["captured"]["out"]
        outcomes, shed, count, peak = _predict_shed(policy, (12, 12), 8, 8)
        run = got["run"]
        shed_got = [u for u, s, *_ in run["requests"] if s == "shed"]
        if (got["outcomes"] != outcomes or shed_got != shed or run["shed_count"] != count
                or run["queue_peak"] != peak):
            fail(f"resilience admission {policy}: outcomes "
                 f"{got['outcomes']}, shed {shed_got}, shed_count "
                 f"{run['shed_count']}, queue_peak {run['queue_peak']}; "
                 f"predicted {outcomes}, {shed}, {count}, {peak}")
        if any(s == "ok" and len(out) != 4
               for _, s, out, _ in run["requests"]):
            fail(f"resilience admission {policy}: an ok request lacks "
                 f"tokens: {run['requests']}")
        rec[policy] = {"accepted": sum(o[0] for o in outcomes),
                       "shed_count": count, "shed_uids": shed,
                       "queue_peak": peak, "ticks": run["decode_calls"]}
    return rec, runs_all


def _res_deadlines(cfg, make_qp, make_fp32, device, rehearse):
    """Case 2: qp bf16 with default_deadline=40 and preempt_after=8 under
    delay_admission at ticks 8 and 9 (16 requests x 24 tokens, 8 slots):
    "ok" and "deadline" both occur, the counters match the statuses. Then
    the fp32 master with preempt_after=4 (12 requests x 12 tokens): every
    request finishes "ok" with the tokens of the same engine undisturbed.
    Returns (record, captured runs, the undisturbed fp32 output)."""
    from repro_torch.serving.resilience import FaultPlan
    reqs = _res_prompts(cfg.vocab_size, 16)

    def drive(mk):
        eng = mk(default_deadline=40, preempt_after=8,
                 fault_plan=FaultPlan(delay_admission=[8, 9]))
        for p in reqs:
            eng.submit(p, max_new=24)
        return {"run": _res_record(eng, eng.run_all(max_ticks=200))}
    runs = _res_twins("deadlines qp bf16", make_qp, drive, device, rehearse)
    run = runs["captured"]["out"]["run"]
    statuses = [s for _, s, _, _ in run["requests"]]
    if (set(statuses) != {"ok", "deadline"}
            or run["deadline_miss_count"] != statuses.count("deadline")
            or not 0 < run["preempt_count"]
            == sum(p for *_, p in run["requests"])
            or any(len(o) != 24 for _, s, o, _ in run["requests"]
                   if s == "ok")
            or any(len(o) >= 24 for _, s, o, _ in run["requests"]
                   if s == "deadline")):
        fail(f"resilience deadlines: {run}")
    rec = {"qp_bf16": {"statuses": {s: statuses.count(s)
                                    for s in sorted(set(statuses))},
                       "deadline_miss_count": run["deadline_miss_count"],
                       "preempt_count": run["preempt_count"],
                       "ticks": run["decode_calls"]}}
    caps = [runs["captured"]]
    reqs32 = _res_prompts(cfg.vocab_size, 12)

    def drive32(mk, preempt=4):
        eng = mk(preempt_after=preempt)
        for p in reqs32:
            eng.submit(p, max_new=12)
        return {"run": _res_record(eng, eng.run_all(max_ticks=200))}
    runs = _res_twins("preemption fp32", make_fp32, drive32, device,
                      rehearse)
    calm = _res_run(make_fp32, lambda mk: drive32(mk, None), None, device)
    caps += [runs["captured"], calm]
    got = runs["captured"]["out"]["run"]["requests"]
    want = calm["out"]["run"]["requests"]
    same = [g[2] == w[2] for g, w in zip(got, want)]
    rec["fp32"] = {"preempt_count":
                   runs["captured"]["out"]["run"]["preempt_count"],
                   "requests_matching_undisturbed": f"{sum(same)}/"
                                                    f"{len(same)}"}
    if (not all(s == "ok" for _, s, _, _ in got) or not all(same)
            or not rec["fp32"]["preempt_count"]):
        fail(f"resilience preemption fp32: tokens differ from the "
             f"undisturbed engine's: {got} vs {want}")
    return rec, caps, {u: o for u, _, o, _ in want}


def _res_ladder(cfg, master, params, device, rehearse):
    """Case 3: the fp32 spec engine (spec_k 4, the qp export drafting)
    with tick failures at 2 and 5: spec -> plain, then kernels -> plain
    versions; the graphs captured again after each step; the four serving
    kernels launched before tick 5 and no plain version; after it plain
    versions only; tokens equal greedy generate."""
    import torch
    from repro_torch.core.precision import FLOAT
    from repro_torch.models import api
    from repro_torch.serving.engine import ServingEngine, generate
    from repro_torch.serving.resilience import FaultPlan
    dcfg, dparams = api.draft_of(cfg, params)
    reqs = _res_prompts(cfg.vocab_size, 8, lens=(6,))

    def make(capture):
        return ServingEngine(master, cfg, policy=FLOAT, slots=8,
                             max_len=512, dtype=torch.float32,
                             spec_k=SPEC_K, draft_params=dparams,
                             draft_cfg=dcfg,
                             fault_plan=FaultPlan(fail_ticks=[2, 5]),
                             capture=capture, device=device)

    def drive(mk):
        eng = mk()
        for p in reqs:
            eng.submit(p, max_new=12)
        done = []
        while eng.decode_calls < 5 and (eng.queue or eng._occupied()):
            eng.step()
            done += eng.drain()
        if device.type == "cuda":
            torch.cuda.synchronize()
        at_t2 = read_counts()
        caps = dict(eng.captures)
        done += eng.run_all(max_ticks=100)
        return {"run": _res_record(eng, done), "_at_t2": at_t2,
                "_caps_at_t2": caps}
    runs = _res_twins("ladder", lambda c: make(c), drive, device, rehearse,
                      ladder=True)
    a = runs["captured"]
    run = a["out"]["run"]
    want = [[2, "spec->plain"], [5, "kernel->fallback"]]
    if run["fallback_events"] != want:
        fail(f"resilience ladder: fallback_events {run['fallback_events']}")
    gp = torch.tensor(reqs, dtype=torch.int32)
    greedy = generate(master, gp, cfg, policy=FLOAT, max_new_tokens=12,
                      dtype=torch.float32, device=device).cpu()
    outs = torch.tensor([o for _, _, o, _ in run["requests"]])
    rec = {"fallback_events": want,
           "tokens_equal_greedy": bool(torch.equal(outs, greedy[:, 6:]))}
    for name, r in runs.items():
        (l2, p2), (l9, p9) = r["out"]["_at_t2"], (r["launches"], r["plain"])
        rec[f"{name}_launches_before_t2"] = {k: l2[k] for k in ENGINE_KERNELS}
        rec[f"{name}_plain_after_t2"] = {k: p9[k] - p2[k] for k in p9}
        if not rehearse:
            if min(l2[k] for k in ENGINE_KERNELS) <= 0 or max(p2.values()):
                fail(f"resilience ladder {name}: before tick 5 launches "
                     f"{l2}, plain calls {p2}")
            if any(l9[k] != l2[k] for k in l9) \
                    or p9["attn_decode"] <= p2["attn_decode"]:
                fail(f"resilience ladder {name}: after tick 5 launches "
                     f"{l9} (at 5: {l2}), plain {p9} (at 5: {p2})")
    caps = a["captures"][0]
    rec["captures"] = {"at_tick_5": a["out"]["_caps_at_t2"], "end": caps}
    if device.type == "cuda" and (a["out"]["_caps_at_t2"]["tick"] != 2
                                  or caps["tick"] != 3):
        fail(f"resilience ladder: tick captures {rec['captures']}, want 2 "
             f"after spec -> plain and 3 after kernel -> fallback")
    if not rec["tokens_equal_greedy"]:
        full = torch.cat([gp, outs], dim=1)
        rec["first_mismatch"] = _first_mismatch_margin(
            master, cfg, FLOAT, gp.to(device), full.to(device),
            greedy.to(device))
        emit({"phase": "resilience", "ladder": rec})
        fail(f"resilience ladder: the fp32 tokens differ from greedy: "
             f"{rec['first_mismatch']}")
    return rec, [a]


def _res_watchdog(cfg, make_qp, device, rehearse):
    """Case 4: run_all(max_ticks=3) on 16 requests (4 of 2 tokens, 12 of
    16) raises WatchdogExpired naming the queue depth and the slots; the 4
    finished requests still drain."""
    from repro_torch.serving.resilience import WatchdogExpired
    reqs = _res_prompts(cfg.vocab_size, 16)

    def drive(mk):
        eng = mk()
        for i, p in enumerate(reqs):
            eng.submit(p, max_new=2 if i < 4 else 16)
        try:
            eng.run_all(max_ticks=3)
        except WatchdogExpired as e:
            diag = e.diagnostics
        else:
            fail("resilience watchdog: run_all(max_ticks=3) returned")
        return {"run": _res_record(eng, eng.drain()),
                "diagnostics": {k: diag[k] for k in (
                    "queue_depth", "queued_uids", "active_slots", "slots",
                    "decode_calls")}}
    runs = _res_twins("watchdog", make_qp, drive, device, rehearse)
    out = runs["captured"]["out"]
    diag, run = out["diagnostics"], out["run"]
    if (diag["queue_depth"] != 4 or diag["queued_uids"] != [13, 14, 15, 16]
            or diag["active_slots"] != list(range(8))
            or [s["uid"] for s in diag["slots"]] != [9, 10, 11, 12, 5, 6,
                                                     7, 8]
            or [(u, s, len(o)) for u, s, o, _ in run["requests"]]
            != [(u, "ok", 2) for u in (1, 2, 3, 4)]):
        fail(f"resilience watchdog: diagnostics {diag}, drained "
             f"{run['requests']}")
    return {"diagnostics": diag, "drained": [u for u, *_ in
                                             run["requests"]]}, \
        [runs["captured"]]


def _res_snapshot(cfg, make_qp, device, rehearse, tmp):
    """Case 5a: qp bf16 with snapshot_every=8 and a journal; at tick 12 a
    timed explicit snapshot; a fresh engine (captured in the captured twin)
    restored from the tick-8 snapshot continues bit-identical to the
    uninterrupted run."""
    import os
    import torch
    reqs = _res_prompts(cfg.vocab_size, 8)

    def drive(mk):
        tag = f"{len(os.listdir(tmp))}"
        snaps, jpath = f"{tmp}/snap{tag}", f"{tmp}/wal{tag}.jsonl"
        eng = mk(snapshot_dir=snaps, snapshot_every=8, journal=jpath)
        for p in reqs:
            eng.submit(p, max_new=24)
        while eng.decode_calls < 12:
            eng.step()
        sync = torch.cuda.synchronize if device.type == "cuda" \
            else (lambda: None)
        sync()
        t0 = time.perf_counter()
        path = eng.snapshot(f"{tmp}/explicit{tag}")
        snap_ms = (time.perf_counter() - t0) * 1e3
        nbytes = os.path.getsize(os.path.join(path, "arrays.npz"))
        donor = _res_record(eng, eng.drain() + eng.run_all(max_ticks=100))
        fresh = mk()
        sync()
        t0 = time.perf_counter()
        fresh.restore(snaps, step=8)
        sync()
        restore_ms = (time.perf_counter() - t0) * 1e3
        if fresh.decode_calls != 8:
            fail(f"resilience snapshot: restored at tick "
                 f"{fresh.decode_calls}, not 8")
        restored = _res_record(fresh, fresh.run_all(max_ticks=100))
        return {"donor": donor, "tokens": donor["requests"],
                "restored_tokens": restored["requests"],
                "_ms": {"snapshot_ms": snap_ms, "snapshot_bytes": nbytes,
                        "restore_ms": restore_ms}}
    runs = _res_twins("snapshot", make_qp, drive, device, rehearse)
    out = runs["captured"]["out"]
    if out["restored_tokens"] != out["tokens"]:
        fail(f"resilience snapshot: the restored engine's tokens "
             f"{out['restored_tokens']} differ from the uninterrupted "
             f"run's {out['tokens']}")
    return {"restored_equals_uninterrupted": True,
            "captured": runs["captured"]["out"]["_ms"],
            "eager": runs["eager"]["out"]["_ms"]}, [runs["captured"]]


def _res_crash(cfg, make_fp32, device, rehearse, tmp):
    """Case 5b: the fp32 master, 12 requests x 12 tokens into
    queue_limit=10 (drop_oldest sheds 2), one with a 3-tick deadline, NaN
    in slot 2 at tick 3; snapshot_every=4 and a journal. A crash at tick 5
    and at tick 11, each recovered on a fresh engine: the union of the
    drains before the crash and the recovered output is the uncrashed
    run; shed, deadline and poisoned requests stay dead."""
    import os
    from repro_torch.serving.resilience import FaultPlan, InjectedCrash
    reqs = _res_prompts(cfg.vocab_size, 12)
    nan = [(3, 2)]

    def submit(eng):
        for i, p in enumerate(reqs):
            eng.submit(p, max_new=12, deadline_ticks=3 if i == 2 else None)

    def outputs(done):
        return {r.uid: [r.status, list(r.out)] for r in done}

    def ref_drive(mk):
        eng = mk(queue_limit=10, shed_policy="drop_oldest",
                 fault_plan=FaultPlan(nan_logits=nan))
        submit(eng)
        return {"ref": outputs(eng.run_all(max_ticks=100)),
                "run": _res_record(eng, [])}
    ref = _res_twins("crash reference", make_fp32, ref_drive, device,
                     rehearse)
    want = ref["captured"]["out"]["ref"]
    if sorted(s for s, _ in want.values()) != sorted(
            ["deadline", "poisoned", "shed", "shed"] + ["ok"] * 8):
        fail(f"resilience crash: the uncrashed run's statuses {want}")
    rec, caps = {}, [ref["captured"]]
    for crash in (5, 11):
        def drive(mk):
            tag = f"{len(os.listdir(tmp))}"
            snaps, jpath = f"{tmp}/crash{tag}", f"{tmp}/crash{tag}.jsonl"
            eng = mk(queue_limit=10, shed_policy="drop_oldest",
                     snapshot_dir=snaps, snapshot_every=4, journal=jpath,
                     fault_plan=FaultPlan(nan_logits=nan,
                                          crash_at_tick=crash))
            submit(eng)
            delivered = {}
            try:
                while eng.queue or eng._occupied():
                    eng.step()
                    delivered.update(outputs(eng.drain()))
            except InjectedCrash:
                pass
            else:
                fail(f"resilience crash: no crash at tick {crash}")
            fresh = mk(queue_limit=10, shed_policy="drop_oldest",
                       snapshot_dir=snaps, journal=jpath,
                       fault_plan=FaultPlan(nan_logits=nan))
            stats = fresh.recover()
            recovered = outputs(fresh.run_all(max_ticks=100))
            return {"delivered": delivered, "stats": stats,
                    "recovered": recovered,
                    "run": _res_record(fresh, [])}
        runs = _res_twins(f"crash at {crash}", make_fp32, drive, device,
                          rehearse)
        caps.append(runs["captured"])
        out = runs["captured"]["out"]
        d, r = out["delivered"], out["recovered"]
        if ({**d, **r} != want
                or any(d[u] != r[u] for u in set(d) & set(r))):
            fail(f"resilience crash at {crash}: delivered {d}, recovered "
                 f"{r}, uncrashed {want}")
        rec[f"crash_at_{crash}"] = {
            **out["stats"], "delivered_before_crash": len(d),
            "recovered": len(r), "delivered_twice": len(set(d) & set(r))}
    rec["uncrashed_statuses"] = {s: sum(v[0] == s for v in want.values())
                                 for s in ("ok", "shed", "deadline",
                                           "poisoned")}
    return rec, caps


def _flip_bit_index(leaf, elem, within):
    """The bit index, in the leaf's logical C order, of bit ``within`` of
    element ``elem`` (a tuple index)."""
    import numpy as np
    flat = int(np.ravel_multi_index(elem, tuple(leaf.shape)))
    return flat * 8 * leaf.element_size() + within


def _on(tree, device):
    """``tree`` with every tensor on ``device`` (the K-major head keeps its
    layout)."""
    return {k: _on(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def _res_integrity(cfg, params, master, make_qp, make_fp32, calm32, device,
                   rehearse, tmp, clock):
    """Case 6: a bit flipped at tick 6 in a served 3-bit field of layer 0's
    down-projection container (qp bf16, integrity_every=4, golden_dir): the
    probe at tick 8 finds it, the heal reloads the leaf in place, the
    manifest is clean, every request finishes; on the fp32 master (a
    mantissa bit of the same projection) the tokens equal the clean run's;
    with no probe the flip changes the K/V that the next replayed tick
    writes against a clean engine's. Prints the probe's ms beside its
    bound."""
    import os

    import torch
    from repro_torch.checkpoint import integrity
    from repro_torch.core.treeutil import tree_get
    from repro_torch.serving.resilience import FaultPlan
    reqs = _res_prompts(cfg.vocab_size, 8)
    leaf = tree_get(params, RES_FLIP)
    kp, n = leaf.shape[1:]
    # the sign bit of field 4 of a word in layer 0: a served level moves
    bit = _flip_bit_index(leaf, (0, kp // 2, n // 3), 4 * 3 + 2)
    rec, caps = {"leaf": RES_FLIP, "bit": bit}, []
    probe_ms = {}

    def drive(mk):
        eng = mk(integrity_every=4,
                 golden_dir=f"{tmp}/golden{len(os.listdir(tmp))}",
                 fault_plan=FaultPlan(flip_bits=[(6, RES_FLIP, bit)]))
        for p in reqs:
            eng.submit(p, max_new=16)
        run = _res_record(eng, eng.run_all(max_ticks=100))
        clean = integrity.verify_manifest(eng.params, eng._manifest) == []
        if eng.graphs.capture or device.type != "cuda":
            work = lambda: eng.graphs.run("probe", eng._probe_work)  # noqa
            probe_ms.update(ms=clock(work), device_ms=clock.device_ms(work))
        probe_ms["bytes"] = sum(tree_get(eng.params, p).numel()
                                * tree_get(eng.params, p).element_size()
                                for p in eng._probe_paths)
        return {"run": run, "manifest_clean": clean}
    runs = _res_twins("integrity qp", make_qp, drive, device, rehearse)
    caps.append(runs["captured"])
    run = runs["captured"]["out"]["run"]
    if (run["heal_count"] != 1
            or run["fallback_events"] != [[8, f"heal:{RES_FLIP}"]]
            or not runs["captured"]["out"]["manifest_clean"]
            or any(s != "ok" or len(o) != 16
                   for _, s, o, _ in run["requests"])):
        fail(f"resilience integrity qp: {run}")
    rec["qp_bf16"] = {"heal_count": 1, "integrity_probes":
                      run["integrity_probes"],
                      "fallback_events": run["fallback_events"],
                      "manifest_clean_after_heal": True}
    bound, _ = bound_ms(probe_ms["bytes"], 0, "bfloat16")
    rec["probe"] = {"protected_bytes": probe_ms["bytes"],
                    "ms": probe_ms.get("ms"),
                    "device_ms": probe_ms.get("device_ms"),
                    "bound_ms": bound, "bound_by": "bytes"}
    # the fp32 master: a mantissa bit of the same projection's weight
    w = tree_get(master, "layers/mlp/down/w")
    bit32 = _flip_bit_index(w, (0, w.shape[1] // 2, w.shape[2] // 3), 22)
    reqs32 = _res_prompts(cfg.vocab_size, 12)

    def drive32(mk):
        eng = mk(integrity_every=4,
                 fault_plan=FaultPlan(flip_bits=[(6, "layers/mlp/down/w",
                                                   bit32)]))
        for p in reqs32:
            eng.submit(p, max_new=12)
        return {"run": _res_record(eng, eng.run_all(max_ticks=100))}
    runs = _res_twins("integrity fp32", make_fp32, drive32, device,
                      rehearse)
    caps.append(runs["captured"])
    run = runs["captured"]["out"]["run"]
    got = {u: o for u, _, o, _ in run["requests"]}
    if run["heal_count"] != 1 or got != calm32:
        fail(f"resilience integrity fp32: heal_count {run['heal_count']}, "
             f"tokens {got} vs the clean run's {calm32}")
    rec["fp32"] = {"heal_count": 1, "tokens_equal_clean_run": True}
    # no probe: the flip reaches the K/V the next replayed tick writes.
    # Layer 0's down projection runs after its attention, so layer 0's K/V
    # stay equal; every later layer reads the flipped output
    for name, capture in (("captured", None), ("eager", False)):
        engines = [make_qp(capture, fault_plan=plan)
                   for plan in (None, FaultPlan(
                       flip_bits=[(3, RES_FLIP, bit)]))]
        for eng in engines:
            for p in reqs:
                eng.submit(p, max_new=16)
        diffs, layers = [], []
        for _ in range(4):
            for eng in engines:
                eng.step()
            a, b = (torch.stack([e.cache["k"], e.cache["v"]]).float()
                    for e in engines)
            d = (a - b).abs().flatten(2).amax(dim=(0, 2))     # per layer
            diffs.append(float(d.max()))
            layers.append(d.nonzero().flatten().tolist())
        rec[f"no_probe_{name}"] = {
            "max_abs_kv_change_by_tick": diffs,
            "kv_layers_changed_at_tick_3": layers[3]}
        if any(diffs[:3]) or not diffs[3] > 0:
            fail(f"resilience integrity: with no probe the flip did not "
                 f"reach the {name} tick's K/V: {rec[f'no_probe_{name}']}")
        del engines, a, b
    return rec, caps


def resilience_phase(cfg, master, params, device, rehearse):
    """Overload hardening and durability on the full-width qwen2-1.5b:
    every case captured and as its capture=False twin, under the same
    FaultPlan. Returns the captured runs' summed launches and variants."""
    import gc
    import tempfile

    import torch
    from repro_torch.core.precision import FLOAT, W3A8
    from repro_torch.serving.engine import ServingEngine
    clock = Clock(device, reps=3 if rehearse else 20)
    t_start = time.perf_counter()

    def make_qp(capture, **kw):
        return ServingEngine(params, cfg, policy=W3A8, slots=8, max_len=512,
                             dtype=torch.bfloat16, capture=capture,
                             device=device, **kw)

    def make_fp32(capture, **kw):
        return ServingEngine(master, cfg, policy=FLOAT, slots=8,
                             max_len=512, dtype=torch.float32,
                             capture=capture, device=device, **kw)
    (ROOT / "build").mkdir(exist_ok=True)
    out = {"phase": "resilience",
           "engines": "ServingEngine(slots=8, max_len=512): W3A8 qp export "
                      "in bf16 (bf16 KV), the fp32 master (FLOAT); each "
                      "case captured and as its capture=False twin"}
    runs, timing = [], {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        for name, case in (
                ("admission", lambda: _res_admission(
                    cfg, make_qp, device, rehearse)),
                ("deadlines_preemption", lambda: _res_deadlines(
                    cfg, make_qp, make_fp32, device, rehearse)),
                ("ladder", lambda: _res_ladder(cfg, master, params, device,
                                               rehearse)),
                ("watchdog", lambda: _res_watchdog(cfg, make_qp, device,
                                                   rehearse)),
                ("snapshot", lambda: _res_snapshot(cfg, make_qp, device,
                                                   rehearse, tmp)),
                ("crash_recovery", lambda: _res_crash(
                    cfg, make_fp32, device, rehearse, tmp)),
                ("integrity", lambda: _res_integrity(
                    cfg, params, master, make_qp, make_fp32, calm32, device,
                    rehearse, tmp, clock))):
            t0 = time.perf_counter()
            res = case()
            if name == "deadlines_preemption":
                rec, got, calm32 = res
            else:
                rec, got = res
            out[name] = rec
            runs += got
            timing[name] = round(time.perf_counter() - t0, 2)
            gc.collect()
    launches = {k: sum(r["launches"][k] for r in runs)
                for k in runs[0]["launches"]}
    variants = {n: {v: sum(r["variants"][n][v] for r in runs)
                    for v in d} for n, d in runs[0]["variants"].items()}
    out.update(launches=launches, launches_by_variant=variants,
               seconds_by_case=timing,
               seconds=round(time.perf_counter() - t_start, 2))
    emit(out)
    if not rehearse and min(launches[k] for k in ENGINE_KERNELS) <= 0:
        fail(f"resilience: a serving kernel never launched: {launches}")
    return launches, variants


# --- phase 12 ---------------------------------------------------------------------

TRAIN_TOKENS = (8, 256)        # batch x seq of every training step on the card
TRAIN_STEPS = 12               # (a): captured steps, and its eager twin's
TRAIN_100M_STEPS = 200         # (b): steps of each 100M run
TRAIN_SERVE = (8, 16, 32)      # (b): requests, prompt tokens, new tokens
# (c): (arch, layers kept on the card or None for all, the rehearsal's
# reduced() sizes); a depth cut keeps the step's peak near 60 GB (fp32
# params, grads and AdamW moments, 16 B a parameter, plus the 12 B a
# parameter the capture's warm-ups keep): phi3.5-moe 1 of 32 layers (1.56
# B parameters), mamba2-2.7b 32 of 64 (1.42 B)
TRAIN_OTHERS = (("phi3.5-moe-42b-a6.6b", 1, {}), ("mamba2-2.7b", 32, {}),
                ("zamba2-1.2b", None, dict(layers=5)))


def _train_batches(vocab, n, device, rehearse, seed=0):
    """``n`` batches of the LM stream (``lm_batch``, steps 0 .. n - 1) on
    ``device``."""
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.data.synthetic import lm_batch
    b, t = (2, 16) if rehearse else TRAIN_TOKENS
    return [shard_batch(lm_batch(seed, i, batch=b, seq=t, vocab=vocab),
                        device) for i in range(n)]


def _train_state(cfg, device, seed, policy, tcfg, capture, frozen=True):
    """A seeded fp32 master on ``device`` and (its train step, its state);
    under a quantizing policy with ``frozen`` the state holds its
    ``fit_deltas_stacked`` deltas, else they are refitted every step."""
    import torch
    from repro_torch.core import quant_dense
    from repro_torch.models import get_model
    from repro_torch.training.loop import make_train_step
    gen = torch.Generator(device=device).manual_seed(seed)
    params = get_model(cfg).init(gen, cfg, device=device)
    extra = None
    if frozen and policy.mode != "float":
        extra = {"deltas": quant_dense.fit_deltas_stacked(params, policy)}
    step, init = make_train_step(cfg, tcfg, policy, capture=capture)
    return step, init(params, extra)


def _train_run(step, state, batches, device):
    """Every batch through ``step``: (state, the per-step metrics as lists,
    read on the host once at the end, the first call's seconds (on the
    card: its warm-ups and capture), and the host ms a step over the
    others, synchronised)."""
    import torch

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    sync()
    t0 = time.perf_counter()
    state, m = step(state, batches[0])
    sync()
    first = time.perf_counter() - t0
    out = [m]
    t0 = time.perf_counter()
    for b in batches[1:]:
        state, m = step(state, b)
        out.append(m)
    sync()
    ms = (time.perf_counter() - t0) * 1e3 / max(len(batches) - 1, 1)
    rows = {k: [float(x[k]) for x in out] for k in out[0]}
    return state, rows, first, ms


def _peak_gb(device):
    import torch
    if device.type != "cuda":
        return None
    return round(torch.cuda.max_memory_allocated() / 1e9, 2)


def _fresh(device):
    import gc

    import torch
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def _n_params(state) -> int:
    from repro_torch.core.treeutil import flatten_with_path
    return sum(t.numel() for t in flatten_with_path(state["params"]).values())


def _twin_runs(cfg, device, seed, policy, tcfg, batches, frozen=True):
    """The same steps from the same seeded state, captured and as the
    capture=False twin (each state built anew and freed after its run)."""
    runs = {}
    for name, capture in (("captured", None), ("eager", False)):
        _fresh(device)
        step, state = _train_state(cfg, device, seed, policy, tcfg, capture,
                                   frozen)
        n = _n_params(state)
        state, rows, first, ms = _train_run(step, state, batches, device)
        runs[name] = {"rows": rows, "first_call_s": round(first, 3),
                      "ms_per_step": round(ms, 3),
                      "captures": len(step.captures),
                      "peak_gb": _peak_gb(device), "params": n}
        del step, state
    _fresh(device)
    return runs


def _twin_train_gate(runs, what, device, keys=("loss",)):
    """Finite losses; the captured steps give the eager twin's ``keys``
    bit for bit (the step is deterministic: no atomics, the same kernels
    in the same order); on the card the captured run captured once."""
    import math
    a, b = runs["captured"]["rows"], runs["eager"]["rows"]
    if not all(math.isfinite(x) for x in a["loss"] + b["loss"]):
        fail(f"{what}: non-finite training loss: {a['loss']} / {b['loss']}")
    for k in keys:
        if a[k] != b[k]:
            d = max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a[k], b[k]))
            fail(f"{what}: captured {k} differs from the eager twin's (max "
                 f"relative difference {d}): {a[k]} vs {b[k]}")
    want = 1 if device.type == "cuda" else 0
    if runs["captured"]["captures"] != want or runs["eager"]["captures"]:
        fail(f"{what}: captures {runs['captured']['captures']} / "
             f"{runs['eager']['captures']}, want {want} / 0")


def _train_full(device, seed, rehearse):
    """(a) qwen2-1.5b at full width and depth under W3A8 with frozen
    per-layer deltas: TRAIN_STEPS steps captured and as the eager twin."""
    from repro_torch.configs import TrainConfig, get_config, reduced
    from repro_torch.core.precision import W3A8
    cfg = get_config("qwen2-1.5b")
    if rehearse:
        cfg = reduced(cfg)
    steps = 4 if rehearse else TRAIN_STEPS
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=2, total_steps=steps,
                       grad_clip=1.0, optimizer="adamw", remat="layer")
    batches = _train_batches(cfg.vocab_size, steps, device, rehearse)
    runs = _twin_runs(cfg, device, seed, W3A8, tcfg, batches)
    what = f"train {cfg.name}"
    _twin_train_gate(runs, what, device, keys=("loss", "gnorm", "lr"))
    cap, rows = runs["captured"], runs["captured"]["rows"]
    loss = rows["loss"]
    if len(set(rows["lr"])) != steps:
        fail(f"{what}: the lr did not change at every replayed step: "
             f"{rows['lr']}")
    first4, last4 = sum(loss[:4]) / 4, sum(loss[-4:]) / 4
    if not rehearse and not last4 < first4:
        fail(f"{what}: the loss did not fall: first 4 average {first4}, last "
             f"4 {last4}")
    b, t = batches[0]["tokens"].shape
    tokens = b * t
    # 6 N per token is the step's own work; remat's recomputed forward
    # (+ 2 N) is this implementation's choice, so it is reported beside
    # the bound and not in it
    bound = 6 * cap["params"] * tokens / PEAK_OPS["bfloat16"] * 1e3
    bound_remat = bound * (6 + 2) / 6
    return {"arch": cfg.name, "layers": cfg.num_layers,
            "d_model": cfg.d_model, "vocab": cfg.vocab_size,
            "params": cap["params"], "cut": "none" if not rehearse
            else "CPU rehearsal: reduced()",
            "policy": "W3A8, frozen fit_deltas_stacked deltas (act 8-bit)",
            "compute": "bf16 over fp32 masters", "remat": "layer",
            "optimizer": "AdamW, warmup_cosine 3e-4 (2 warm-up steps), "
                         "clip 1.0", "batch": [b, t], "steps": steps,
            "loss": loss, "eager_loss": runs["eager"]["rows"]["loss"],
            "gnorm": rows["gnorm"], "lr": rows["lr"],
            "loss_first4_avg": first4, "loss_last4_avg": last4,
            "captured_eager_identical": ["loss", "gnorm", "lr"],
            "ms_per_step": cap["ms_per_step"],
            "eager_ms_per_step": runs["eager"]["ms_per_step"],
            "first_call_s": cap["first_call_s"],
            "tokens_per_s": round(tokens / cap["ms_per_step"] * 1e3, 1),
            "bound_ms": round(bound, 3),
            "bound": "6 x params x tokens at 989 TFLOP/s (bf16)",
            "share_of_bound": round(bound / cap["ms_per_step"], 4),
            "bound_with_remat_ms": round(bound_remat, 3),
            "share_of_bound_with_remat": round(bound_remat
                                               / cap["ms_per_step"], 4),
            "peak_gb": cap["peak_gb"],
            "eager_peak_gb": runs["eager"]["peak_gb"]}


def _in_window(prompts, done, vocab):
    """The share of served transitions (last prompt token -> first new
    token, then new -> new) that fall inside the LM stream's window:
    (next - 31 x - 17) % vocab < max(vocab // 16, 2)."""
    inside = total = 0
    window = max(vocab // 16, 2)
    for p, r in zip(prompts, done):
        seq = [p[-1]] + list(r.out)
        for x, y in zip(seq, seq[1:]):
            inside += (y - 31 * x - 17) % vocab < window
            total += 1
    return inside / max(total, 1)


def _train_100m(device, seed, rehearse):
    """(b) the 100M config trained float and W3A8 (deltas refitted each
    step, as ``launch/train_lm_100m.py``), then the W3A8-trained master
    exported to containers and served, captured and as its eager twin,
    with the engine phase's launch gates and the path check."""
    import math

    import torch
    from repro_torch.configs import reduced
    from repro_torch.core import quant_dense
    from repro_torch.core.precision import FLOAT, W3A8
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.launch.train_lm_100m import make_100m_cfg, train_config
    from repro_torch.serving.engine import ServingEngine
    cfg = make_100m_cfg()
    if rehearse:
        cfg = reduced(cfg)
    steps = 20 if rehearse else TRAIN_100M_STEPS
    batches = _train_batches(cfg.vocab_size, steps, device, rehearse)
    rec = {"arch": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size, "steps": steps,
           "optimizer": "AdamW, warmup_cosine 3e-4 (20 warm-up steps), "
                        "clip 1.0", "remat": "layer",
           "batch": list(batches[0]["tokens"].shape), "runs": {}}
    master = None
    for name, policy in (("float", FLOAT), ("w3a8", W3A8)):
        _fresh(device)
        step, state = _train_state(cfg, device, seed, policy,
                                   train_config(steps), None, frozen=False)
        state, rows, first, ms = _train_run(step, state, batches, device)
        loss = rows["loss"]
        if not all(math.isfinite(x) for x in loss):
            fail(f"train {cfg.name} {name}: non-finite loss {loss}")
        rec["runs"][name] = {
            "loss_first": loss[0], "loss_last": loss[-1],
            "loss_first10_avg": sum(loss[:10]) / len(loss[:10]),
            "loss_last10_avg": sum(loss[-10:]) / len(loss[-10:]),
            "ms_per_step": round(ms, 3), "first_call_s": round(first, 3),
            "captures": len(step.captures), "peak_gb": _peak_gb(device)}
        if name == "w3a8":
            master = state["params"]
        del step, state
    _fresh(device)
    params = quant_dense.export_container(master, W3A8)
    del master
    n_req, plen, new = TRAIN_SERVE
    reqs = [lm_batch(seed + 1, i, batch=1, seq=plen,
                     vocab=cfg.vocab_size)["tokens"][0].tolist()
            for i in range(n_req)]
    what = f"train {cfg.name} serve"

    def make(capture):
        return ServingEngine(params, cfg, policy=W3A8, slots=8, max_len=512,
                             dtype=torch.bfloat16, capture=capture,
                             device=device)
    engines = {"captured": _warmed(make(None), reqs),
               "eager": _warmed(make(False), reqs)}
    runs = {name: _serve(eng, reqs, device, max_new=new)
            for name, eng in engines.items()}
    run = runs["captured"]
    done = run["done"]
    if len(done) != n_req or any(len(r.out) != new for r in done):
        fail(f"{what}: not every request got its {new} tokens")
    _twin_gate(runs, what)
    if not rehearse:
        for name, eng in engines.items():
            _engine_launch_gate(eng, cfg, runs[name], f"{what} {name}")
    del engines
    rec["serve"] = {
        "engine": "ServingEngine(slots=8, max_len=512, bf16, greedy), "
                  "W3A8 qp export of the W3A8-trained master",
        "requests": f"{n_req} x {new} new tokens after {plen}-token prompts "
                    f"of the stream", **_run_line(run),
        "eager_twin": _run_line(runs["eager"]),
        "captured_eager_token_identical": True,
        "launches": run["launches"], "launches_by_variant": run["variants"],
        "plain_calls": run["plain"],
        "in_window_share": _in_window(reqs, done, cfg.vocab_size),
        "chance": 1 / 16}
    rec["serve"]["path"] = _path_check(cfg, params, device)
    del params
    _fresh(device)
    return rec, run["launches"], run["variants"]


def _train_families(device, seed, rehearse):
    """(c) one W3A8 step (frozen deltas) of each model of TRAIN_OTHERS at
    full width, captured and as its eager twin."""
    import dataclasses

    from repro_torch.configs import TrainConfig, get_config, reduced
    from repro_torch.core.precision import W3A8
    out = []
    for arch, layers, small in TRAIN_OTHERS:
        cfg = get_config(arch)
        full = cfg.num_layers
        if rehearse:
            cfg = reduced(cfg, **small)
        elif layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=2,
                           total_steps=TRAIN_STEPS, grad_clip=1.0,
                           optimizer="adamw", remat="layer")
        batches = _train_batches(cfg.vocab_size, 1, device, rehearse)
        runs = _twin_runs(cfg, device, seed, W3A8, tcfg, batches)
        _twin_train_gate(runs, f"train {arch}", device,
                         keys=("loss", "gnorm"))
        cap = runs["captured"]
        cut = (f"depth {cfg.num_layers} of {full}; widths as published"
               if cfg.num_layers < full else "none")
        out.append({"arch": arch, "family": cfg.family,
                    "layers": cfg.num_layers, "full_layers": full,
                    "cut": f"CPU rehearsal: reduced({small})" if rehearse
                    else cut, "params": cap["params"],
                    "loss": cap["rows"]["loss"][0],
                    "gnorm": cap["rows"]["gnorm"][0],
                    "aux": cap["rows"]["aux"][0],
                    "captured_eager_identical": ["loss", "gnorm"],
                    "first_call_s": cap["first_call_s"],
                    "eager_first_call_s": runs["eager"]["first_call_s"],
                    "peak_gb": cap["peak_gb"]})
    return out


def train_phase(device, seed, rehearse):
    """LM training on the card: (a) qwen2-1.5b full size, (b) the 100M
    config trained and its W3A8 export served, (c) the MoE, SSM and hybrid
    families' step. Returns (b)'s captured serve's launches and
    variants."""
    t0 = time.perf_counter()
    rec = {"phase": "train", "tokens_per_step": list(TRAIN_TOKENS)}
    rec["full"] = _train_full(device, seed, rehearse)
    rec["lm_100m"], launches, variants = _train_100m(device, seed, rehearse)
    rec["families"] = _train_families(device, seed, rehearse)
    rec["seconds"] = round(time.perf_counter() - t0, 1)
    emit(rec)
    return launches, variants


# --- phase 13 ---------------------------------------------------------------------

DIST_TRAIN_STEPS = 6           # the mesh train cell's steps, and the one-device
DIST_COMPRESSED_STEPS = 3      # then steps with the int8 gradient compressor
DIST_DECODE = (8, 4096, 16)    # batch, cache length, decode steps
DIST_DECODE_FILLED = 4000      # cache entries filled before the decode steps
DIST_PREFILL = (8, 512)        # batch, prompt length
DIST_PIPELINE = (6, 2, 8)      # microbatches, rows, width (one stage)


def _whole(t):
    from repro_torch.distributed.shards import whole
    return whole(t)


def _bit_diff(got, want, what):
    """Fails unless ``got`` (a DTensor or a tensor) equals ``want`` bit for
    bit, in shape and dtype."""
    import torch
    g = _whole(got)
    if g.dtype != want.dtype or g.shape != want.shape \
            or not torch.equal(g, want):
        d = (g.double() - want.double()).abs().max().item() \
            if g.shape == want.shape else None
        fail(f"dist: {what} differs from the one-device path (max |diff| "
             f"{d}, {g.dtype}{tuple(g.shape)} vs "
             f"{want.dtype}{tuple(want.shape)})")


def _placements_of(tree):
    from repro_torch.core.treeutil import flatten_with_path
    return {k: [repr(p) for p in v.placements]
            for k, v in flatten_with_path(tree).items()
            if hasattr(v, "placements")}


def _dist_train(cfg, mesh, device, seed, rehearse):
    """(a) the mesh train cell beside training.loop's one-device step, then
    steps with the compressor and the compressor's arithmetic against the
    CPU; returns (record, the cell's state)."""
    import math

    import torch
    from repro_torch.configs import ShapeConfig, TrainConfig
    from repro_torch.core.precision import W3A8
    from repro_torch.core.treeutil import flatten_with_path
    from repro_torch.distributed import compression
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps
    b, t = (2, 16) if rehearse else TRAIN_TOKENS
    n = DIST_TRAIN_STEPS
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=2, total_steps=n,
                       grad_clip=1.0, optimizer="adamw", remat="layer")
    batches = _train_batches(cfg.vocab_size, n + DIST_COMPRESSED_STEPS,
                             device, rehearse)
    _fresh(device)
    step, state = _train_state(cfg, device, seed, W3A8, tcfg, None)
    state, ref, ref_first, ref_ms = _train_run(step, state, batches[:n],
                                               device)
    del step, state
    _fresh(device)
    shape = ShapeConfig("train", t, b, "train")
    cell = steps.build_cell(cfg, shape, mesh, quant="w3", tcfg=tcfg)
    _, state = _train_state(cfg, device, seed, W3A8, tcfg, False)
    state = steps.place(state, cell.in_shardings[0])
    placed = [steps.place(x, cell.in_shardings[1]) for x in batches]
    state, rows, first, ms = _train_run(cell.fn, state, placed[:n], device)
    for k in ("loss", "gnorm", "lr"):
        if rows[k] != ref[k]:
            fail(f"dist: the mesh train cell's {k} differs from the "
                 f"one-device step's: {rows[k]} vs {ref[k]}")
    want = 1 if device.type == "cuda" else 0
    if len(cell.fn.captures) != want:
        fail(f"dist: the mesh train cell captured "
             f"{len(cell.fn.captures)} times, want {want}")
    peak = _peak_gb(device)
    del cell
    _fresh(device)
    # the compressor as grad_transform, from the cell's state: "ef" (made
    # before the first call, as a captured step needs) takes the params'
    # specs; these steps run eagerly (capture=False): the warm-ups of a
    # capture would keep another copy of the 31 GB the steps write
    state["ef"] = compression.init_error_feedback(state["params"])
    ccell = steps.build_cell(cfg, shape, mesh, quant="w3", tcfg=tcfg,
                             grad_transform=compression.make_grad_compressor(),
                             capture=False)
    state, crows, _, cms = _train_run(ccell.fn, state, placed[n:], device)
    if not all(math.isfinite(x) for x in crows["loss"]):
        fail(f"dist: non-finite loss under the compressor: {crows['loss']}")
    # the compressor on the card against the CPU on the last step's
    # gradients (the step's fp32 buffers) and carried residuals
    grads = ccell.fn.step.grads
    ef = flatten_with_path(state["ef"])
    checked = 0
    for path, g in grads.items():
        gc, ec = _whole(g), _whole(ef[path])
        x = gc.to(torch.float32) + ec
        q, s = compression.quantize_grad(x)
        r = x - compression.dequantize_grad(q, s)
        xh = gc.cpu().to(torch.float32) + ec.cpu()
        qh, sh = compression.quantize_grad(xh)
        rh = xh - compression.dequantize_grad(qh, sh)
        for got, want_, what in ((q, qh, "q"), (s, sh, "scale"),
                                 (r, rh, "residual")):
            if not torch.equal(got.cpu(), want_):
                fail(f"dist: the compressor's {what} of {path} on the card "
                     f"differs from the CPU's")
        checked += 1
    tokens = b * t
    rec = {"arch": cfg.name, "layers": cfg.num_layers, "batch": [b, t],
           "policy": "W3A8, frozen fit_deltas_stacked deltas",
           "steps": n, "loss": rows["loss"], "gnorm": rows["gnorm"],
           "lr": rows["lr"],
           "equal_to_one_device": "loss, gnorm and lr bit for bit",
           "ms_per_step": round(ms, 3),
           "one_device_ms_per_step": round(ref_ms, 3),
           "tokens_per_s": round(tokens / ms * 1e3, 1),
           "one_device_tokens_per_s": round(tokens / ref_ms * 1e3, 1),
           "first_call_s": round(first, 3),
           "one_device_first_call_s": round(ref_first, 3), "captures": want,
           "peak_gb": peak,
           "compressed": {"steps": DIST_COMPRESSED_STEPS, "capture": False,
                          "loss": crows["loss"], "gnorm": crows["gnorm"],
                          "ms_per_step": round(cms, 3),
                          "leaves_checked_against_cpu": checked},
           "state_placements": {k: v for k, v in _placements_of(
               state["params"]).items() if k.startswith("layers/attn")}}
    del ccell
    _fresh(device)
    return rec, state


def _dist_restore(state, mesh, cfg, device):
    """(d) the cell's params, step and deltas saved, restored with
    ``shardings=``: bit-identical leaves on the asked placements."""
    import shutil
    import tempfile

    from repro_torch import checkpoint
    from repro_torch.core.treeutil import flatten_with_path
    from repro_torch.distributed import sharding as shd
    part = {k: state[k] for k in ("params", "step", "deltas")}
    sh = shd.tree_shardings(mesh, {k: v for k, v in shd.state_specs(
        cfg, part, mesh).items() if k in part})
    td = tempfile.mkdtemp(prefix="dist_ckpt_")
    try:
        t0 = time.perf_counter()
        checkpoint.save(td, int(_whole(state["step"])), part)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tree, meta = checkpoint.restore(td, shardings=sh)
        restore_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(td, ignore_errors=True)
    want_sh = flatten_with_path(sh)
    got, old = flatten_with_path(tree), flatten_with_path(part)
    if sorted(got) != sorted(old):
        fail("dist: the restore's leaves differ from the saved tree's")
    nbytes = 0
    for k, v in old.items():
        _bit_diff(got[k], _whole(v).to(got[k].device), f"restored {k}")
        if list(got[k].placements) != want_sh[k][1]:
            fail(f"dist: restored {k} on {got[k].placements}, asked for "
                 f"{want_sh[k][1]}")
        nbytes += v.numel() * v.element_size()
    del tree
    return {"saved": "params, step and deltas of the train cell's state "
                     "(not the AdamW moments or the residual)",
            "gb": round(nbytes / 1e9, 3), "step": meta["step"],
            "save_s": round(save_s, 3), "restore_s": round(restore_s, 3),
            "bit_identical": True, "placements_as_asked": True}


def _dist_serve(cfg, mesh, device, seed, rehearse):
    """(b) the decode cell (qp, bf16 cache) and (c) the prefill cell (q)
    beside transformer.decode_step / prefill without a mesh: logits and
    caches bit for bit; the launches of the cells' runs alone."""
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.core import quant_dense
    from repro_torch.core.precision import W3A8
    from repro_torch.distributed import shards
    from repro_torch.launch import steps
    from repro_torch.models import get_model
    from repro_torch.models.api import init_cache
    mod = get_model(cfg)
    b, s, n = (2, 64, 4) if rehearse else DIST_DECODE
    filled = 48 if rehearse else DIST_DECODE_FILLED
    pb, pt = (2, 16) if rehearse else DIST_PREFILL
    _fresh(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    master = mod.init(gen, cfg, device=device)
    words = quant_dense.export_container(master, W3A8)
    levels = quant_dense.export_levels(master, W3A8)
    del master
    _fresh(device)
    g = torch.Generator(device=device).manual_seed(seed + 7)
    cache0 = init_cache(cfg, b, s, torch.bfloat16, device=device)
    for name in ("k", "v"):
        cache0[name][:, :, :filled] = torch.randn(
            cache0[name][:, :, :filled].shape, generator=g, device=device
        ).to(torch.bfloat16)
    cache0["len"].fill_(filled)
    toks = torch.randint(0, cfg.vocab_size, (n, b, 1), generator=g,
                         device=device, dtype=torch.int32)
    prompt = torch.randint(0, cfg.vocab_size, (pb, pt), generator=g,
                           device=device, dtype=torch.int32)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # one device
    ref_cache = {k: v.clone() for k, v in cache0.items()}
    ref_logits = []
    sync()
    t0 = time.perf_counter()
    for i in range(n):
        lg, ref_cache = mod.decode_step(words, ref_cache, toks[i], cfg,
                                        policy=W3A8, dtype=torch.bfloat16)
        ref_logits.append(lg)
    sync()
    ref_dec_ms = (time.perf_counter() - t0) * 1e3 / n
    t0 = time.perf_counter()
    ref_pl, ref_pc = mod.prefill(levels, {"tokens": prompt}, cfg,
                                 policy=W3A8, dtype=torch.bfloat16,
                                 max_len=pt)
    sync()
    ref_pre_ms = (time.perf_counter() - t0) * 1e3
    # the cells on the mesh
    dcell = steps.build_cell(cfg, ShapeConfig("decode", s, b, "decode"),
                             mesh, quant="w3")
    pcell = steps.build_cell(cfg, ShapeConfig("prefill", pt, pb, "prefill"),
                             mesh, quant="w3")
    dparams = steps.place(words, dcell.in_shardings[0])
    dcache = steps.place({k: v.clone() for k, v in cache0.items()},
                         dcell.in_shardings[1])
    pparams = steps.place(levels, pcell.in_shardings[0])
    shards.gathers.clear()
    reset_counts()
    sync()
    t0 = time.perf_counter()
    logits = []
    for i in range(n):
        lg, dcache = dcell.fn(dparams, dcache, steps.place(
            {"tokens": toks[i]}, dcell.in_shardings[2]))
        logits.append(lg)
    sync()
    dec_ms = (time.perf_counter() - t0) * 1e3 / n
    t0 = time.perf_counter()
    pl, pc = pcell.fn(pparams, steps.place({"tokens": prompt},
                                           pcell.in_shardings[1]))
    sync()
    pre_ms = (time.perf_counter() - t0) * 1e3
    launches, plain = read_counts()
    variants = read_variants()
    gathers = dict(shards.gathers)
    for i, (got, want) in enumerate(zip(logits, ref_logits)):
        _bit_diff(got, want, f"decode step {i}'s logits")
    for name in ("k", "v", "len"):
        _bit_diff(dcache[name], ref_cache[name], f"decode cache {name}")
        _bit_diff(pc[name], ref_pc[name], f"prefill cache {name}")
    _bit_diff(pl, ref_pl, "prefill logits")
    if not rehearse:
        routes = {"qmatvec": launches["qmatvec"],
                  "qmatmul k_lanes": variants["qmatmul"]["k_lanes"],
                  "attn_decode": launches["attn_decode"],
                  "qmatmul n_lanes": variants["qmatmul"]["n_lanes"],
                  "attn_prefill": launches["attn_prefill"]}
        idle = [k for k, v in routes.items() if v <= 0]
        if idle:
            fail(f"dist: no launch of {idle} in the mesh cells")
        if any(plain.values()):
            fail(f"dist: plain versions ran in the mesh cells: {plain}")
    rec = {"decode": {"form": "qp", "batch": b, "cache": s,
                      "filled": filled, "steps": n,
                      "kv": "bf16", "ms_per_step": round(dec_ms, 3),
                      "one_device_ms_per_step": round(ref_dec_ms, 3),
                      "equal_to_one_device": "logits and cache bit for bit",
                      "cache_placements": [repr(p) for p in
                                           dcache["k"].placements]},
           "prefill": {"form": "q", "batch": pb, "tokens": pt,
                       "ms": round(pre_ms, 3),
                       "one_device_ms": round(ref_pre_ms, 3),
                       "equal_to_one_device": "logits and cache bit for bit"},
           "launches": launches, "plain_calls": plain,
           "launches_by_variant": {k: variants[k] for k in
                                   ("qmatvec", "qmatmul", "attn_prefill")},
           "gathers": gathers, "peak_gb": _peak_gb(device)}
    del dparams, dcache, pparams, words, levels
    _fresh(device)
    return rec, launches, variants


def _dist_pipeline(device):
    """(e) pipeline_apply over a one-rank stage mesh against each
    microbatch through the stage: forward and gradient."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed.pipeline import pipeline_apply
    m, b, d = DIST_PIPELINE
    g = torch.Generator(device=device).manual_seed(5)
    w = (torch.randn(1, d, d, generator=g, device=device) * 0.3) \
        .requires_grad_(True)
    bias = torch.randn(1, d, generator=g, device=device) * 0.1
    x = torch.randn(m, b, d, generator=g, device=device)
    mesh = init_device_mesh(device.type, (1,), mesh_dim_names=("stage",))
    fn = lambda p, h: torch.tanh(h @ p["w"] + p["b"])
    out = pipeline_apply(fn, {"w": w, "b": bias}, x, mesh)
    (out ** 2).sum().backward()
    w2 = w.detach().clone().requires_grad_(True)
    seq = torch.stack([fn({"w": w2[0], "b": bias[0]}, x[i])
                       for i in range(m)])
    (seq ** 2).sum().backward()
    _bit_diff(out.detach(), seq.detach(), "pipeline forward")
    # the gradient sums the microbatches' terms in the backward's order
    err = float((w.grad - w2.grad).abs().max() / w2.grad.abs().max())
    if not err <= 1e-6:
        fail(f"dist: the pipeline's gradient is {err} x max|grad| from "
             f"sequential application's (tolerance 1e-6)")
    return {"stages": 1, "microbatches": m, "rows": b, "width": d,
            "forward": "bit for bit", "grad_rel_err": err,
            "grad_tolerance": 1e-6}


def dist_phase(device, seed, rehearse, smi):
    """The distributed layer on a one-process group (NCCL on the card,
    gloo in the rehearsal) and a (1, 1) (data, model) mesh: (a) the train
    cell, (b) the decode cell, (c) the prefill cell, (d) the elastic
    restore, (e) the pipeline. Returns the serve cells' launches and
    variants and the train cell's peak GB."""
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.mesh import init_single_process, make_host_mesh
    t0 = time.perf_counter()
    backend = init_single_process(device)
    mesh = make_host_mesh(1, 1, device=device)
    cfg = get_config("qwen2-1.5b")
    if rehearse:
        cfg = reduced(cfg)
    rec = {"phase": "dist", "card": smi, "backend": backend,
           "mesh": {"data": 1, "model": 1}, "arch": cfg.name,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size}
    rec["train"], state = _dist_train(cfg, mesh, device, seed, rehearse)
    rec["restore"] = _dist_restore(state, mesh, cfg, device)
    del state
    _fresh(device)
    rec["serve"], launches, variants = _dist_serve(cfg, mesh, device, seed,
                                                   rehearse)
    rec["pipeline"] = _dist_pipeline(device)
    peaks = [rec["train"]["peak_gb"], rec["serve"]["peak_gb"]]
    rec["peak_gb"] = None if None in peaks else max(peaks)
    rec["seconds"] = round(time.perf_counter() - t0, 1)
    emit(rec)
    import torch.distributed as dist
    dist.destroy_process_group()
    return launches, variants, rec["train"]["peak_gb"]


# --- phase 14 ---------------------------------------------------------------------

ANALYSIS_BUCKET = 256          # (b): the admission round traced and launched
# (e): the dry-run cells on the fake 16 x 16 mesh, run as subprocesses
DRYRUN_CELLS = ("decode_32k", "train_4k")
ANALYSIS_TIMEOUT = 600         # seconds the subprocesses may take, at most


def _analysis_procs(device, rehearse):
    """(a) and (e) in the background, each a subprocess of its own (fake
    tensors on the host's cores; nothing runs on the card): the contract
    sweep, one process a family, and the dry runs of DRYRUN_CELLS.
    Returns {name: (process, log path, report path)}."""
    import os
    import subprocess
    out = ROOT / "build" / "analysis"
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    dev = "cpu" if rehearse else "cuda"
    cmds = {}
    from repro_torch.analysis.contracts import FAMILIES
    for fam in FAMILIES:
        rep = out / f"sweep_{fam}.json"
        cmds[f"sweep/{fam}"] = ([sys.executable, "-m", "repro_torch.analysis",
                                 "--families", fam, "--out", str(rep)], rep)
    for shape in DRYRUN_CELLS:
        rep = (ROOT / "build" / "dryrun"
               / f"qwen2-1.5b__{shape}__single__w3.json")
        cmds[f"dryrun/{shape}"] = ([sys.executable, "-m",
                                    "repro_torch.launch.dryrun", "--arch",
                                    "qwen2-1.5b", "--shape", shape, "--mesh",
                                    "single", "--no-aux", "--force",
                                    "--device", dev], rep)
    procs = {}
    for name, (cmd, rep) in cmds.items():
        rep.unlink(missing_ok=True)          # no report of an earlier run
        log = out / (name.replace("/", "_") + ".log")
        procs[name] = (subprocess.Popen(cmd, stdout=open(log, "w"),
                                        stderr=subprocess.STDOUT, env=env,
                                        cwd=ROOT), log, rep)
    return procs


def _analysis_wait(procs):
    """Wait for the background subprocesses; a failed or late one fails
    the phase (every one is stopped first). Returns {name: report}."""
    deadline = time.perf_counter() + ANALYSIS_TIMEOUT
    try:
        for name, (p, log, _) in procs.items():
            rc = p.wait(timeout=max(1.0, deadline - time.perf_counter()))
            if name.startswith("sweep") and rc != 0:
                fail(f"analysis {name}: rc {rc}\n"
                     f"{log.read_text()[-3000:]}")
    except Exception:
        for p, _, _ in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        raise
    reports = {}
    for name, (_, log, rep) in procs.items():
        if not rep.exists():
            fail(f"analysis {name}: no report\n{log.read_text()[-3000:]}")
        reports[name] = json.loads(rep.read_text())
    return reports


def _launch_counts():
    """Every kernel's launch counters by the names a trace gives its kernel
    ops (``analysis.contracts.kernel_op_counts(by_variant=True)``); a
    call's launches are the difference of two readings."""
    c = _counters()
    qmv, qmm, dec, pf, sig = (c[k][0] for k in (
        "qmatvec", "qmatmul", "attn_decode", "attn_prefill", "sigmoid_pw"))
    out = {f"qmatvec/{v}": n for v, n in qmv.launches_by_variant.items()}
    out.update({f"qmatmul/n_lanes/{v}": n
                for v, n in qmm.launches_by_variant.items()})
    out.update({f"qmatmul/k_lanes/{o}": n
                for o, n in qmm.launches_by_orientation.items()})
    out.update({f"attn_prefill/{v}": n
                for v, n in pf.launches_by_variant.items()})
    out.update({"attn_decode": dec.launches, "sigmoid_pw": sig.launches,
                "sigmoid_pw_bwd": sig.bwd_launches})
    return out


def _analysis_trace_gate(cfg, params, device, rehearse):
    """(b) The decode tick and one bucket-256 admission of the qp engine
    (8 slots, max_len 512) traced on fake tensors: their kernel ops by
    name and variant equal the launch counters of the same calls run
    eagerly on the card, and the tick's structure (7 projections a layer
    in qmatvec's decode variant, an attn_decode a layer, one k_lanes
    readout; the admission's in qmatvec's prefill variant and the wgmma
    attn_prefill)."""
    import torch
    from repro_torch.analysis.contracts import kernel_op_counts
    from repro_torch.analysis.trace import fake_mode, fake_tree, trace
    from repro_torch.core.precision import W3A8
    from repro_torch.serving.engine import ServingEngine
    kw = dict(policy=W3A8, slots=8, max_len=512, dtype=torch.bfloat16,
              capture=False)
    t0 = time.perf_counter()
    fm = fake_mode()
    # fake CUDA tensors, in the CPU rehearsal too (a CPU tensor takes the
    # plain versions, so its graph has no kernel op)
    cuda0 = torch.device("cuda", 0)
    fparams = fake_tree(params, fm, None if device.type == "cuda" else cuda0)
    with fm:
        feng = ServingEngine(fparams, cfg, device=cuda0, **kw)
        pts = {p["name"]: p for p in feng.contract_points(ANALYSIS_BUCKET)}
    traced = {}
    for name in ("decode_tick", "prefill_bucketed"):
        p = pts[name]
        tr = trace(p["fn"], inputs=p["inputs"], carry=p["carry"], mode=fm)
        traced[name] = kernel_op_counts(tr, by_variant=True)
    trace_s = time.perf_counter() - t0
    L = cfg.num_layers
    want = {"decode_tick": {"qmatvec/decode": 7 * L, "attn_decode": L,
                            "qmatmul/k_lanes/k_major": 1},
            "prefill_bucketed": {"qmatvec/prefill": 7 * L,
                                 "attn_prefill/wgmma": L,
                                 "qmatmul/k_lanes/k_major": 1}}
    out = {"traced": traced, "trace_s": round(trace_s, 3)}
    for name, counts in traced.items():
        if counts != want[name]:
            fail(f"analysis (b): the traced {name} runs {counts}, the "
                 f"engine's structure {want[name]}")
    if rehearse:
        return out
    eng = ServingEngine(params, cfg, device=device, **kw)
    buf = torch.zeros((8, ANALYSIS_BUCKET), dtype=torch.int32, device=device)
    launched = {}
    with torch.no_grad():
        for name, fn in (("decode_tick", eng._tick),
                         ("prefill_bucketed", lambda: eng._admit(buf))):
            before = _launch_counts()
            fn()
            torch.cuda.synchronize()
            after = _launch_counts()
            launched[name] = {k: n - before.get(k, 0)
                              for k, n in after.items()
                              if n != before.get(k, 0)}
    del eng
    out["launched"] = launched
    for name in traced:
        if traced[name] != launched[name]:
            fail(f"analysis (b): {name} traced {traced[name]} but launched "
                 f"{launched[name]}")
    return out


def _route_cases(device):
    """One launch of every kernel route at its main shape (PERF.md's
    kernel table): (label, call)."""
    import torch
    from repro_torch.kernels.attn_decode import ops as dec_ops
    from repro_torch.kernels.attn_prefill import ops as pf_ops
    from repro_torch.kernels.qmatmul import ops as qmm_ops
    from repro_torch.kernels.qmatvec import ops as qmv_ops
    from repro_torch.kernels.sigmoid_pw import kernel as sig_k
    g = torch.Generator(device=device).manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32

    def rn(*shape, dtype=bf):
        return torch.randn(shape, generator=g, device=device).to(dtype)

    def ri(lo, hi, *shape, dtype):
        return torch.randint(lo, hi, shape, generator=g, device=device,
                             dtype=dtype)
    words = ri(-2 ** 31, 2 ** 31 - 1, 154, 8960, dtype=torch.int32)
    delta = rn(8960, dtype=f32).abs()
    lv = ri(-127, 128, 1536, 8960, dtype=torch.int8)
    table = ri(-127, 128, 151936, 1536, dtype=torch.int8)
    router = ri(-127, 128, 4096, 16, dtype=torch.int8)
    q1, kc = rn(8, 1, 12, 128), rn(8, 512, 2, 128)
    lens = torch.full((8,), 400, dtype=torch.int32, device=device)
    qp, kp = rn(8, 256, 12, 128), rn(8, 256, 2, 128)
    hi = torch.minimum(torch.arange(256, device=device, dtype=torch.int32)
                       [None] + 1, torch.full((8, 1), 256, device=device,
                                              dtype=torch.int32))
    x1 = rn(100, 1022, dtype=f32)
    return (
        ("qmatvec decode M=8 K=1536 N=8960",
         lambda: qmv_ops.qmatvec(rn(8, 1536), words, delta, k=1536)),
        ("qmatvec prefill M=512 K=1536 N=8960",
         lambda: qmv_ops.qmatvec(rn(512, 1536), words, delta, k=1536)),
        ("qmatmul k_lanes k_major readout M=8 K=1536 N=151936",
         lambda: qmm_ops.qmatmul(rn(8, 1536), table.T, 1.0)),
        ("qmatmul k_lanes row_major router M=8 K=4096 N=16",
         lambda: qmm_ops.qmatmul(rn(8, 4096), router, delta[:16],
                                 out_dtype=f32)),
        ("qmatmul n_lanes decode M=8 K=1536 N=8960",
         lambda: qmm_ops.qmatmul(rn(8, 1536), lv, delta)),
        ("qmatmul n_lanes prefill M=512 K=1536 N=8960",
         lambda: qmm_ops.qmatmul(rn(512, 1536), lv, delta)),
        ("attn_decode B=8 S=512 KV=2 G=6 D=128",
         lambda: dec_ops.attn_decode(q1, kc, kc, lens)),
        ("attn_prefill wgmma B=8 T=S=256 KV=2 G=6 D=128",
         lambda: pf_ops.attn_prefill(qp, kp, kp, hi)),
        ("attn_prefill simt B=8 T=S=256 KV=2 G=6 D=128 fp32",
         lambda: pf_ops.attn_prefill(qp.float(), kp.float(), kp.float(),
                                     hi)),
        ("sigmoid_pw (100, 1022) fp32", lambda: sig_k.sigmoid_pw_cuda(x1)),
        ("sigmoid_pw_bwd (100, 1022) fp32",
         lambda: sig_k.sigmoid_pw_bwd_cuda(x1, x1)))


def _analysis_smem_table(device, rehearse):
    """(c) Every kernel route's launch at its main shape: the plan's
    dynamic shared memory, the static bytes of analysis.smem (checked
    against ptxas for every compiled function), registers, spill bytes and
    blocks per SM by shared memory; every function within the 227 KiB a
    block may use."""
    import types

    import torch
    from repro_torch.analysis import smem
    from repro_torch.kernels import _build, _ops
    entries = {}
    for log in _build.build_log.values():
        for e in smem.ptxas_entries(log):
            entries.setdefault(e["function"], []).append(e)
    bad = sorted({(fn, e["smem"]) for fn, es in entries.items() for e in es
                  if e["smem"] != smem.STATIC_SMEM.get(fn, 0)})
    if bad:
        fail(f"analysis (c): ptxas's static shared memory differs from "
             f"analysis.smem.STATIC_SMEM: {bad}")
    if not rehearse:
        missing = set(smem.STATIC_SMEM) - set(entries)
        if missing or not entries:
            fail(f"analysis (c): ptxas reported no {sorted(missing)}")
    rows = []
    if rehearse:
        return {"routes": rows, "ptxas_functions": len(entries)}
    for label, call in _route_cases(device):
        with torch.no_grad(), _ops.recording() as notes:
            call()
        torch.cuda.synchronize()
        note = notes[-1]
        est = smem.kernel_smem_estimate(types.SimpleNamespace(kernel=note))
        for fn, dyn, static in est["functions"]:
            es = entries.get(fn, [])
            regs = sorted({e["registers"] for e in es})
            spill = max((sum(e["spill"] or (0, 0)) for e in es), default=None)
            if dyn + static > smem.DEFAULT_SMEM_BUDGET:
                fail(f"analysis (c): {label} {fn} asks for {dyn + static} B "
                     f"of shared memory, over {smem.DEFAULT_SMEM_BUDGET}")
            rows.append({"route": label, "variant": est["variant"],
                         "function": fn, "grid": list(note["grid"])
                         if fn == est["function"] else None,
                         "dynamic_smem": dyn, "static_smem": static,
                         "registers": f"{regs[0]}-{regs[-1]}" if regs
                         else None,
                         "spill_bytes_max": spill,
                         "blocks_per_sm_by_smem": smem.blocks_per_sm(
                             dyn + static)})
    return {"routes": rows, "ptxas_functions": len(entries)}


def _analysis_host_dryrun(device, rehearse, dist_peak):
    """(e) The dist phase's train cell (qwen2-1.5b, W3A8, 8 x 256, its
    TrainConfig) dry-run on a (1, 1) mesh of a fake group: its peak
    estimate beside the peak the dist phase measured."""
    from repro_torch.configs import ShapeConfig, TrainConfig, get_config, \
        reduced
    from repro_torch.launch import dryrun
    cfg = get_config("qwen2-1.5b")
    b, t = (2, 16) if rehearse else TRAIN_TOKENS
    if rehearse:
        cfg = reduced(cfg)
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=2,
                       total_steps=DIST_TRAIN_STEPS, grad_clip=1.0,
                       optimizer="adamw", remat="layer")
    name = f"train_{b}x{t}"
    rec = dryrun.run_cell(cfg.name, name, "host", "w3", force=True,
                          device=device.type, cfg=cfg,
                          shape=ShapeConfig(name, t, b, "train"), tcfg=tcfg,
                          with_aux=False)
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    if rec["status"] != "ok":
        fail(f"analysis (e): the (1, 1) train cell's dry run: {rec['error']}"
             f"\n{rec.get('traceback', '')}")
    return {"cell": dryrun.cell_id(cfg.name, name, "host", "w3"),
            "peak_bytes_est_gb": round(
                rec["full"]["memory"]["peak_bytes_est"] / 1e9, 3),
            "memory": rec["full"]["memory"],
            "measured_peak_gb": dist_peak, "trace_s": rec["full"]["compile_s"]}


def analysis_phase(cfg, params, device, rehearse, dist_peak):
    """14. The contract linter and the dry run: (a) the sweep, 4 families
    x 2 forms x 2 modes on fake "cuda" tensors, 0 violations; (b) the
    traced tick and admission equal the launch counters; (c) the on-chip
    table; (d) the capture budgets of --exercise; (e) the dry runs on the
    fake 16 x 16 mesh, status ok, and the (1, 1) train cell's peak
    estimate beside the dist phase's measured peak."""
    t0 = time.perf_counter()
    procs = _analysis_procs(device, rehearse)
    try:
        rec = {"phase": "analysis"}
        rec["trace_vs_launches"] = _analysis_trace_gate(cfg, params, device,
                                                        rehearse)
        rec["smem"] = _analysis_smem_table(device, rehearse)
        if not rehearse:
            from repro_torch.analysis.__main__ import _exercise_captures
            cap = _exercise_captures()
            if cap["violations"] or cap["counts"].get("tick") != 1:
                fail(f"analysis (d): capture budgets: {cap}")
            rec["captures"] = cap
        rec["host_dryrun"] = _analysis_host_dryrun(device, rehearse,
                                                   dist_peak)
        reports = _analysis_wait(procs)
    except BaseException:
        for p, _, _ in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        raise
    sweeps = [r for n, r in reports.items() if n.startswith("sweep")]
    rec["sweep"] = {"checks": sum(r["checks"] for r in sweeps),
                    "violations": sum(r["violations"] for r in sweeps),
                    "combos": sum(len(r["combos"]) for r in sweeps)}
    if rec["sweep"]["violations"] or rec["sweep"]["combos"] != 16:
        fail(f"analysis (a): {rec['sweep']}")
    rec["dryrun"] = {}
    for shape in DRYRUN_CELLS:
        r = reports[f"dryrun/{shape}"]
        if r["status"] != "ok":
            fail(f"analysis (e): dry run {shape}: {r.get('error')}\n"
                 f"{r.get('traceback', '')}")
        rec["dryrun"][shape] = {
            "collectives": r["full"]["collectives"],
            "peak_bytes_est_gb": round(
                r["full"]["memory"]["peak_bytes_est"] / 1e9, 3),
            "flops": r["full"]["cost"]["flops"],
            "trace_s": r["full"]["compile_s"]}
    rec["seconds"] = round(time.perf_counter() - t0, 1)
    emit(rec)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU rehearsal at reduced size through the plain "
                         "versions; prints no result line")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phase", choices=["dist", "analysis"],
                    help="build the kernels and run this phase alone (no "
                         "kernels line, no result line)")
    args = ap.parse_args(argv)

    t_script = time.perf_counter()
    import torch
    if not args.rehearse and not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "false); use --rehearse for the CPU rehearsal", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config, reduced

    device = torch.device("cpu" if args.rehearse else "cuda")
    cfg = get_config("qwen2-1.5b")
    if args.rehearse:
        cfg = reduced(cfg)
    smi = card_phase(device, args.rehearse)
    if args.phase == "dist":
        dist_phase(device, args.seed, args.rehearse, smi)
        print(smi, flush=True)
        return 0
    if args.phase == "analysis":
        _, params, _ = build_model(cfg, device, args.seed)
        analysis_phase(cfg, params, device, args.rehearse, None)
        print(smi, flush=True)
        return 0
    headline, routes = parity_phase(cfg, device, args.rehearse)
    master, params, build_s = build_model(cfg, device, args.seed)
    emit({"phase": "model", "arch": cfg.name, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "vocab": cfg.vocab_size,
          "form": "qp (W3A8 export_container)", "init_export_s":
          round(build_s, 3)})
    launches, variants, qp_tok_s = engine_phase(cfg, params, device, None,
                                                args.rehearse)
    launches8, variants8, _ = engine_phase(cfg, params, device, 8,
                                           args.rehearse)
    q_launches, q_variants, _ = q_engine_phase(cfg, master, device,
                                               args.rehearse)
    quarantine_phase(cfg, params, device, args.rehearse)
    path_phase(cfg, params, device)
    spec_launches, spec_variants = spec_phase(cfg, master, params, device,
                                              qp_tok_s, args.rehearse)
    # parked on the host while the paper, deploy and dense phases hold the
    # card, back for the resilience phase
    master, params = _on(master, "cpu"), _on(params, "cpu")
    if device.type == "cuda":
        torch.cuda.empty_cache()
    digit, metrics, paper_launches = paper_phase(device, args.rehearse)
    deploy_launches, deploy_variants = deploy_phase(
        digit, metrics["w3a8_mcr"], device, args.seed, args.rehearse)
    dense_launches, dense_variants = dense_phase(device, args.seed,
                                                 args.rehearse)
    moe_launches, moe_variants = moe_phase(device, args.seed, args.rehearse)
    ssm_launches, ssm_variants = ssm_phase(device, args.seed, args.rehearse)
    train_launches, train_variants = train_phase(device, args.seed,
                                                 args.rehearse)
    dist_launches, dist_variants, dist_peak = dist_phase(device, args.seed,
                                              args.rehearse, smi)
    master, params = _on(master, device), _on(params, device)
    res_launches, res_variants = resilience_phase(cfg, master, params,
                                                  device, args.rehearse)
    del master
    _fresh(device)
    analysis_phase(cfg, params, device, args.rehearse, dist_peak)
    del params
    kernels = []
    for name, (src, replaces) in KERNEL_META.items():
        c = headline[name]
        by_path = {"engine_bf16_kv": launches[name],
                   "engine_int8_kv": launches8[name],
                   "q_engine": q_launches[name]}
        if name in ENGINE_KERNELS:
            by_path["spec"] = spec_launches[name]
        by_path.update(paper=paper_launches[name],
                       deploy=deploy_launches[name],
                       dense=dense_launches[name],
                       moe=moe_launches[name],
                       ssm=ssm_launches[name],
                       train=train_launches[name],
                       dist=dist_launches[name],
                       resilience=res_launches[name])
        entry = {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": by_path["engine_bf16_kv" if name in ENGINE_KERNELS
                                else "deploy"],
            "launches_by_path": by_path,
            "max_abs_err": c["err"], "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"], "device_ms": c["device_ms"],
            "library_device_ms": c["library_device_ms"], "shape": c["shape"],
            "dtype": c["dtype"]}
        if name in VARIANTS:
            entry.update(
                variant=c["variant"], variant_sources=VARIANTS[name][1],
                launches_by_variant={"engine_bf16_kv": variants[name],
                                     "engine_int8_kv": variants8[name],
                                     "q_engine": q_variants[name],
                                     "spec": spec_variants[name],
                                     "deploy": deploy_variants[name],
                                     "dense": dense_variants[name],
                                     "moe": moe_variants[name],
                                     "ssm": ssm_variants[name],
                                     "train": train_variants[name],
                                     "dist": dist_variants[name],
                                     "resilience": res_variants[name]})
        kernels.append(entry)
    # the redesigned routes: their headline case, their launches on the
    # path that runs them (n_lanes: the q engine; simt: the fp32 engines of
    # the resilience phase), and every shape the parity phase held
    route_paths = {"n_lanes": ("q_engine", q_variants[N_LANES],
                               q_variants["qmatmul"]["n_lanes"]),
                   "simt": ("resilience", {
                       "simt": res_variants["attn_prefill"]["simt"],
                       "merge": res_variants[SIMT_MERGE]["merge"]},
                       res_variants["attn_prefill"]["simt"])}
    for name, variant, src in ROUTES:
        cases = routes[variant]
        c = next(c for c in cases if c.get("summary_headline"))
        path, split, count = route_paths[variant]
        if not args.rehearse and count <= 0:
            fail(f"{name} {variant}: no launch on the {path} path")
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": KERNEL_META[name][1], "variant": variant,
            "launches": count, "launches_path": path,
            "launches_by_variant": split,
            "max_abs_err": c["err"], "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"], "device_ms": c["device_ms"],
            "library_device_ms": c["library_device_ms"], "shape": c["shape"],
            "dtype": c["dtype"],
            "cases": [{k: c_[k] for k in (
                "shape", "dtype", "variant", "err", "ms", "device_ms",
                "plain_ms", "library_ms", "library_device_ms", "bound_ms",
                "bound_by") if k in c_} for c_ in cases]})
    emit({"phase": "script", "seconds": round(time.perf_counter() - t_script,
                                              1)})
    emit({"kernels": kernels})
    print(smi, flush=True)
    if args.rehearse:
        print("chip_smoke: CPU rehearsal passed (no device result)",
              flush=True)
        return 0
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
