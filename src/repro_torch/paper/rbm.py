"""Greedy layer-wise RBM pretraining (paper §2.1: "the network is pre-trained
with unsupervised greedy RBM learning... 50 epochs of 1-step contrastive
divergence, mini-batch 100, lr 0.1, momentum 0.9").

Port of the reference's ``paper/rbm.py``. Layers are Bernoulli-Bernoulli on
inputs in [0, 1] and on the previous layer's hidden probabilities. CD-1
updates: dW = <v h>_data - <v' h'>_recon. The random draws (the epoch
permutation and the uniform numbers that sample the hidden units) come
from a ``torch.Generator``; ``_cd1_step`` takes its uniform draw as an
argument, so a test can feed it any draw.
"""
from __future__ import annotations

import torch

__all__ = ["pretrain_rbm_stack"]


def _cd1_step(w, vb, hb, mw, mvb, mhb, v0, u, lr, momentum,
              gaussian_visible: bool):
    """One CD-1 update. ``u``: uniform [0, 1) draws of ``ph0``'s shape that
    sample the hidden units. Returns the new (w, vb, hb, mw, mvb, mhb) and
    the positive-phase hidden probabilities."""
    # positive phase
    ph0 = torch.sigmoid(v0 @ w + hb)
    h0 = (u < ph0).to(torch.float32)
    # negative phase (one Gibbs step)
    if gaussian_visible:
        v1 = h0 @ w.T + vb                       # mean-field real visible
    else:
        v1 = torch.sigmoid(h0 @ w.T + vb)
    ph1 = torch.sigmoid(v1 @ w + hb)
    n = v0.shape[0]
    # Hinton's practical-guide weight decay keeps wide RBMs out of saturation
    gw = (v0.T @ ph0 - v1.T @ ph1) / n - 2e-4 * w
    gvb = torch.mean(v0 - v1, dim=0)
    ghb = torch.mean(ph0 - ph1, dim=0)
    mw = momentum * mw + gw
    mvb = momentum * mvb + gvb
    mhb = momentum * mhb + ghb
    return (w + lr * mw, vb + lr * mvb, hb + lr * mhb, mw, mvb, mhb, ph0)


@torch.no_grad()
def pretrain_rbm_stack(params: dict, x_train, *, epochs: int = 50,
                       batch: int = 100, lr: float = 0.1,
                       momentum: float = 0.9, seed: int = 0, log=None) -> dict:
    """Pretrain every hidden layer of the paper MLP (params from
    ``dnn.init``); 'head' stays at its random init. ``x_train``: numpy or
    tensor inputs, moved to the params' device. Returns params with
    pretrained w and hidden biases b."""
    names = sorted(n for n in params if n != "head")
    dev = params[names[0]]["w"].device
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    data = torch.as_tensor(x_train, dtype=torch.float32).to(dev)
    out = {k: dict(v) for k, v in params.items()}
    for name in names:
        w = out[name]["w"]
        vb = torch.zeros((w.shape[0],), dtype=torch.float32, device=dev)
        hb = torch.zeros((w.shape[1],), dtype=torch.float32, device=dev)
        mw, mvb, mhb = torch.zeros_like(w), torch.zeros_like(vb), torch.zeros_like(hb)
        # inputs live in [0,1] -> Bernoulli everywhere (the paper's MNIST
        # recipe; Gaussian-visible CD-1 at lr 0.1 diverges)
        n = data.shape[0]
        steps = max(n // batch, 1)
        for ep in range(epochs):
            perm = torch.randperm(n, generator=gen, device=dev)
            for s in range(steps):
                v0 = data[perm[s * batch:(s + 1) * batch]]
                u = torch.rand((v0.shape[0], w.shape[1]), generator=gen,
                               device=dev)
                w, vb, hb, mw, mvb, mhb, _ = _cd1_step(
                    w, vb, hb, mw, mvb, mhb, v0, u, lr, momentum, False)
            if log and (ep + 1) % 10 == 0:
                log(f"  rbm[{name}] epoch {ep + 1}/{epochs}")
        out[name]["w"] = w
        out[name]["b"] = hb                       # hidden biases seed the MLP
        # propagate data through the trained layer for the next RBM
        data = torch.sigmoid(data @ w + hb)
    return out
