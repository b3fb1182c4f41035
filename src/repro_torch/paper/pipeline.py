"""The paper's experiment, end to end (§2.1):

  step 0  greedy RBM pretraining   (CD-1, lr = backprop lr / 10)
  step 1  float training           (SGD, momentum 0.9 — paper's recipe)
  step 2  optimal uniform quantization of the weights (L2, per layer)
  step 3  retraining with fixed-point weights in the forward path (STE)

applied to the digit net (784-1022-1022-1022-10) and the phoneme net
(429-1022x4-61), with the paper's W3(hidden)/W8(output)/A8(signals) policy,
on the synthetic tasks of ``data.synthetic`` (same dims as MNIST/TIMIT).
The reproduced quantity is the float -> W3A8 *gap*.

Port of the reference's ``paper/pipeline.py``. Its two jitted functions,
the training step (forward, gradients, SGD-momentum update) and the
evaluation forward, are CUDA graphs on a CUDA device (``core.graphs``),
each captured once per batch shape and replayed for every batch;
``capture=False`` runs them eagerly, as a CPU run always does. The step
copies the optimizer's new parameters and momentum into its own, so a
replay reads and writes the same tensors; the loss is read on the host
once per epoch. Training matmuls are plain ``x @ w`` (the reference leaves
them to XLA). Also validates the deployment path: ``export_packed`` ->
packed inference == fake-quant inference.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

import torch

from repro_torch import optim as optim_lib
from repro_torch.core import qat, quant_dense
from repro_torch.core.graphs import Graphs, kept
from repro_torch.core.precision import FLOAT, QuantPolicy
from repro_torch.core.treeutil import flatten_with_path, unflatten
from repro_torch.data.synthetic import ClassificationTask, digit_task, phoneme_task
from repro_torch.models import dnn
from repro_torch.training.losses import accuracy, softmax_xent

__all__ = ["PaperRunConfig", "run_paper_experiment", "train_mlp", "evaluate"]


@dataclasses.dataclass(frozen=True)
class PaperRunConfig:
    task: str = "digit"              # digit | phoneme
    hidden: Optional[tuple] = None   # None => paper's exact sizes
    pretrain_epochs: int = 50        # paper: 50 epochs CD-1 RBM per layer
    float_epochs: int = 100          # paper: 100
    retrain_epochs: int = 100        # paper: 100 ("same training parameters")
    batch: int = 100                 # paper: 100 (digit) / 128 (phoneme)
    lr: float = 0.1                  # paper: 0.1 (digit) / 0.05 (phoneme)
    momentum: float = 0.9            # paper: 0.9
    seed: int = 0
    act_bits: int = 8                # paper: 8-bit signals
    hidden_bits: int = 3             # paper: 3-bit hidden weights
    output_bits: int = 8             # paper: 8-bit output layer

    def resolved(self) -> Tuple[ClassificationTask, tuple, float, int]:
        if self.task == "digit":
            t = digit_task(seed=self.seed)
            hidden = self.hidden or (1022, 1022, 1022)
            return t, hidden, self.lr, self.batch
        t = phoneme_task(seed=self.seed)
        hidden = self.hidden or (1022, 1022, 1022, 1022)
        return t, hidden, 0.05 if self.lr == 0.1 else self.lr, 128


def _policy(rc: PaperRunConfig, mode: str) -> QuantPolicy:
    return QuantPolicy(mode=mode, act_bits=rc.act_bits if mode != "float" else None,
                       bits={"hidden": rc.hidden_bits, "output": rc.output_bits,
                             "embed": 8, "router": 8})


def _device_of(params) -> torch.device:
    return next(iter(flatten_with_path(params).values())).device


def _staged(bufs: Dict, x: torch.Tensor, y: torch.Tensor):
    """``x`` and ``y`` copied into the fixed buffers of their shape, which
    that shape's graph reads."""
    if x.shape not in bufs:
        bufs[x.shape] = (torch.empty_like(x), torch.empty_like(y))
    xb, yb = bufs[x.shape]
    xb.copy_(x)
    yb.copy_(y)
    return xb, yb


def train_mlp(params, task: ClassificationTask, *, policy: QuantPolicy,
              deltas=None, epochs: int, batch: int, lr: float,
              momentum: float, seed: int = 0, log=None,
              capture: Optional[bool] = None) -> Tuple[dict, Dict]:
    """SGD-momentum training of the paper MLP under a policy, on the
    params' device: one step per batch, replayed from one CUDA graph where
    ``capture`` (default: on a CUDA device). Returns new params (the inputs
    are left as they were)."""
    dev = _device_of(params)
    graphs = Graphs(dev, capture=capture)
    opt = optim_lib.sgd(momentum=momentum)
    # the step's fixed tensors: its own parameters and momentum, updated in
    # place, the batches it reads and the loss it writes
    params = optim_lib.tree_map(
        lambda p: p.detach().clone().requires_grad_(True), params)
    opt_state = opt.init(params)
    flat = flatten_with_path(params)
    state = list(flat.values()) + list(flatten_with_path(opt_state).values())
    loss = torch.zeros((), dtype=torch.float32, device=dev)

    def step(x, y):
        out = softmax_xent(dnn.forward(params, x, policy=policy,
                                       deltas=deltas), y)
        grads = torch.autograd.grad(out, list(flat.values()))
        with torch.no_grad():
            updates, new_state = opt.update(unflatten(dict(zip(flat, grads))),
                                            opt_state, params, lr)
            new = optim_lib.apply_updates(params, updates)
            for dst, src in zip(state, list(flatten_with_path(new).values())
                                + list(flatten_with_path(new_state).values())):
                dst.copy_(src)
            loss.copy_(out)

    t0 = time.time()
    losses = []
    batches: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}
    for ep in range(epochs):
        stepped = False
        for x, y in task.batches("train", batch, seed=seed + ep, device=dev):
            xb, yb = _staged(batches, x, y)
            # warm-ups leave the parameters and the momentum as they were
            graphs.run(("step", tuple(x.shape)), lambda: step(xb, yb),
                       idle=lambda: kept(*state))
            stepped = True
        if stepped:
            losses.append(float(loss))
            if log:
                log(f"  epoch {ep + 1}/{epochs} loss {losses[-1]:.4f}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    params = optim_lib.tree_map(torch.Tensor.detach, params)
    return params, {"final_loss": losses[-1] if losses else float("nan"),
                    "train_time_s": time.time() - t0,
                    "captures": sum(graphs.captures.values())}


@torch.no_grad()
def evaluate(params, task: ClassificationTask, *, policy: QuantPolicy,
             deltas=None, batch: int = 500,
             capture: Optional[bool] = None) -> float:
    """Returns miss-classification rate (MCR, %) on the test split; the
    forward of a batch replayed from one CUDA graph where ``capture``
    (default: on a CUDA device)."""
    dev = _device_of(params)
    graphs = Graphs(dev, capture=capture)
    acc = torch.zeros((), dtype=torch.float32, device=dev)

    def forward(x, y):
        acc.copy_(accuracy(dnn.forward(params, x, policy=policy,
                                       deltas=deltas), y))

    accs = []
    batches: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}
    for x, y in task.batches("test", batch, device=dev):
        xb, yb = _staged(batches, x, y)
        graphs.run(("eval", tuple(x.shape)), lambda: forward(xb, yb))
        accs.append(acc.clone())
    return 100.0 * (1.0 - sum(torch.stack(accs).tolist()) / len(accs))


def run_paper_experiment(rc: PaperRunConfig, *, log=print,
                         device="cuda", capture: Optional[bool] = None) -> Dict:
    """Full 3-step pipeline on ``device``. Returns the reference's metrics,
    the final loss of each training run, the seconds of the steps the
    training times do not cover, the training steps' graph captures, and
    ``params``: the retrained float master tree, which
    ``quant_dense.export_container`` turns into the deployed W3A8 form.
    ``capture`` is the training steps' and evaluations' (default: on a
    CUDA device)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_paper_experiment: device 'cuda' asked for but "
                           "no CUDA card is available; pass device='cpu'")
    task, hidden, lr, batch = rc.resolved()
    gen = torch.Generator(device=dev).manual_seed(rc.seed)
    params0 = dnn.init(gen, task.input_dim, hidden, task.num_classes,
                       device=dev)
    n_params = dnn.num_params(params0)
    log(f"[{rc.task}] net {task.input_dim}-{'-'.join(map(str, hidden))}-"
        f"{task.num_classes} ({n_params / 1e6:.2f}M params) on {dev}")
    secs = {}

    # -- step 0 (paper §2.1): greedy RBM pretraining -----------------------------
    # CD-1 lr = backprop lr / 10 (+ Hinton weight decay in rbm.py)
    t0 = time.time()
    if rc.pretrain_epochs:
        from repro_torch.paper.rbm import pretrain_rbm_stack
        log(f"[{rc.task}] step 0: RBM pretraining ({rc.pretrain_epochs} epochs/layer)")
        params0 = pretrain_rbm_stack(params0, task.train[0],
                                     epochs=rc.pretrain_epochs, batch=batch,
                                     lr=lr * 0.1, momentum=rc.momentum,
                                     seed=rc.seed, log=log)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    secs["pretrain_s"] = time.time() - t0

    # -- step 1: float training ------------------------------------------------
    log(f"[{rc.task}] step 1: float training ({rc.float_epochs} epochs)")
    fparams, fstats = train_mlp(params0, task, policy=FLOAT, epochs=rc.float_epochs,
                                batch=batch, lr=lr, momentum=rc.momentum,
                                seed=rc.seed, log=log, capture=capture)
    float_mcr = evaluate(fparams, task, policy=FLOAT, capture=capture)
    log(f"[{rc.task}] float MCR {float_mcr:.2f}%")

    # -- step 2: optimal uniform quantization ----------------------------------
    t0 = time.time()
    policy_q = _policy(rc, "fake")
    deltas = quant_dense.fit_deltas(fparams, policy_q)
    direct_mcr = evaluate(fparams, task, policy=policy_q, deltas=deltas,
                          capture=capture)
    secs["quantize_s"] = time.time() - t0
    log(f"[{rc.task}] step 2: direct quantization (no retrain) MCR {direct_mcr:.2f}%")

    # -- step 3: retraining with quantized forward ------------------------------
    log(f"[{rc.task}] step 3: QAT retraining ({rc.retrain_epochs} epochs)")
    qparams, qstats = train_mlp(fparams, task, policy=policy_q, deltas=None,
                                epochs=rc.retrain_epochs, batch=batch, lr=lr,
                                momentum=rc.momentum, seed=rc.seed + 100, log=log,
                                capture=capture)
    retrained_mcr = evaluate(qparams, task, policy=policy_q, deltas=None,
                             capture=capture)
    log(f"[{rc.task}] W3A8 (retrained) MCR {retrained_mcr:.2f}%")

    # -- deployment: packed inference == fake-quant inference -------------------
    t0 = time.time()
    with torch.no_grad():
        packed = quant_dense.export_packed(qparams, policy_q)
        x0, _ = next(task.batches("test", 128, device=dev))
        ref_logits = dnn.forward(qparams, x0, policy=policy_q)
        pk_logits = _packed_forward(packed, x0, rc)
        packed_err = float((ref_logits - pk_logits).abs().max())
    secs["deploy_check_s"] = time.time() - t0
    log(f"[{rc.task}] packed-vs-fakequant max |dlogit| {packed_err:.3e}")

    return {
        "task": rc.task, "params_M": n_params / 1e6,
        "float_mcr": float_mcr, "direct_quant_mcr": direct_mcr,
        "w3a8_mcr": retrained_mcr, "gap_pp": retrained_mcr - float_mcr,
        "packed_max_err": packed_err,
        "float_train_s": fstats["train_time_s"],
        "retrain_s": qstats["train_time_s"],
        "float_final_loss": fstats["final_loss"],
        "retrain_final_loss": qstats["final_loss"],
        "train_step_captures": fstats["captures"] + qstats["captures"],
        **secs,
        "weight_bytes_float": int(n_params * 4),
        "weight_bytes_packed": _packed_bytes(packed),
        "params": qparams,
    }


def _packed_forward(packed, x, rc: PaperRunConfig):
    """Inference through packed leaves (the unpack path, exact sigmoid, as
    the reference's check). Mirrors dnn.forward's layer structure."""
    n = len(packed)
    names = [f"fc{i}" for i in range(n - 1)] + ["head"]
    h = x
    for i, name in enumerate(names):
        leaf = packed[name]
        h = quant_dense.packed_apply(leaf["w"], h, use_kernel=False)
        h = h + leaf["b"]
        if i < n - 1:
            h = torch.sigmoid(h)
            h = qat.fake_quant_act(h, rc.act_bits, signed=False)
    return h


def _packed_bytes(packed) -> int:
    return int(sum(t.numel() * t.element_size()
                   for t in flatten_with_path(packed).values()))
