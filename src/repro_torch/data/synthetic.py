"""Deterministic synthetic datasets — port of the reference's
``data/synthetic.py``.

LM stream (``lm_batch``): Markov-ish token sequences with local structure
so the loss has real signal, ``x[t+1] = (31 x[t] + 17 + n) % vocab`` with
noise ``n < max(vocab // 16, 2)``. A pure function of ``(seed, step)``
through an explicit ``torch.Generator``, so any batch can be regenerated
anywhere and the input pipeline restarts from a step counter alone. Its
stream is not ``jax.random``'s (the two generators differ), so parity
tests feed both packages the same numpy batches.

Classification (digit 784 -> 10, phoneme 429 -> 61), standing in for
MNIST/TIMIT: the numpy generation is a verbatim copy, so the
``train``/``test`` arrays and the ``batches`` order are bit-identical to
the reference's; ``batches`` yields torch tensors on the device the caller
names (the split is moved there once per call and each batch is gathered
there).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

__all__ = ["lm_batch", "ClassificationTask", "digit_task", "phoneme_task"]


# --- LM stream -----------------------------------------------------------------

def lm_batch(seed: int, step: int, *, batch: int, seq: int,
             vocab: int) -> Dict[str, torch.Tensor]:
    """(B, S) int32 ``tokens`` and their next tokens ``labels`` on the host:
    ``x0`` uniform over the vocabulary, then ``x[t+1] = (31 x[t] + 17 +
    n[t]) % vocab``; ``labels`` is the stream shifted by one."""
    # the generator keeps 32 bits of its seed: mix (seed, step) into them
    mixed = np.random.SeedSequence([int(seed), int(step)]).generate_state(1)
    gen = torch.Generator().manual_seed(int(mixed[0]))
    x0 = torch.randint(0, vocab, (batch,), generator=gen)
    noise = torch.randint(0, max(vocab // 16, 2), (batch, seq),
                          generator=gen)
    xs = torch.empty((batch, seq + 1), dtype=torch.int64)
    xs[:, 0] = x0
    for t in range(seq):
        xs[:, t + 1] = (xs[:, t] * 31 + 17 + noise[:, t]) % vocab
    xs = xs.to(torch.int32)
    return {"tokens": xs[:, :-1].contiguous(),
            "labels": xs[:, 1:].contiguous()}


class ClassificationTask:
    """Prototype-based synthetic classification with train/test splits."""

    def __init__(self, input_dim: int, num_classes: int, *, seed: int = 0,
                 noise: float = 0.5, sparsity: float = 0.2,
                 n_train: int = 10_000, n_test: int = 2_000):
        """MNIST-like statistics: sparse smooth nonnegative prototypes, inputs
        clipped to [0,1] (the paper's 8-bit gray pixels)."""
        rng = np.random.RandomState(seed)
        self.input_dim, self.num_classes = input_dim, num_classes
        base = rng.randn(num_classes, input_dim)
        kernel = np.exp(-0.5 * (np.arange(-8, 9) / 3.0) ** 2)
        smooth = np.stack([np.convolve(b, kernel, mode="same") for b in base])
        thresh = np.quantile(smooth, 1 - sparsity, axis=1, keepdims=True)
        self.prototypes = (smooth >= thresh).astype(np.float32)  # sparse blobs
        self.noise = noise
        self.train = self._draw(rng, n_train)
        self.test = self._draw(rng, n_test)

    def _draw(self, rng, n) -> Tuple[np.ndarray, np.ndarray]:
        y = rng.randint(0, self.num_classes, size=n)
        x = self.prototypes[y] + rng.randn(n, self.input_dim) * self.noise
        return np.clip(x, 0.0, 1.0).astype(np.float32), y.astype(np.int32)

    def batches(self, split: str, batch: int, *, seed: int = 0,
                epochs: int = 1, device="cpu"):
        x, y = (torch.from_numpy(a).to(device)
                for a in (self.train if split == "train" else self.test))
        rng = np.random.RandomState(seed)
        for _ in range(epochs):
            idx = torch.from_numpy(rng.permutation(len(x))).to(device)
            for i in range(0, len(x) - batch + 1, batch):
                j = idx[i:i + batch]
                yield x[j], y[j]


def digit_task(**kw) -> ClassificationTask:
    """Paper's digit net input space: 784 -> 10 (28x28 8-bit gray analogue)."""
    kw.setdefault("noise", 2.5)
    return ClassificationTask(784, 10, **kw)


def phoneme_task(**kw) -> ClassificationTask:
    """Paper's phoneme net input space: 429 -> 61 (11 frames of MFCC)."""
    kw.setdefault("noise", 2.3)
    return ClassificationTask(429, 61, **kw)
