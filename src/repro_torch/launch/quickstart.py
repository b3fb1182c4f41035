"""Quickstart: the paper's technique on one layer, through ``repro_torch``
alone (the reference's ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.launch.quickstart              # the card
    PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu

One 784 x 1022 layer of the paper's 784-1022-1022-1022-10 network, made
from seed 0: fit to 3 bits (the optimal uniform quantizer, levels -3..3,
paper step 2), seen through the STE fake-quant (step 3), packed 10 weights
a 32-bit container word (the on-chip image), then multiplied by the
paper's batch of 100 through ``qmatmul`` (int8 levels) and ``qmatvec``
(the packed containers): on the card by the hand-written kernels, on the
CPU by their plain versions. Both are held against the fp32 product with
the dequantized matrix; the run fails if either is off by more than
1e-4 x max|product| (the fp32 parity tolerance of ``chip_smoke.py``).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import QuantSpec, fake_quant, pack_matrix, quantize
from repro_torch.kernels.qmatmul.ops import qmatmul
from repro_torch.kernels.qmatvec.ops import qmatvec

TOL = 1e-4


def run(w: torch.Tensor, x: torch.Tensor) -> dict:
    """Steps 2-5 on a (784, 1022) fp32 weight ``w`` and a (100, 784) batch
    ``x``: the levels, delta, fake-quant view, container words, both
    kernels' products and their errors against ``x @ (q * delta)``."""
    # 2. optimal uniform 3-bit quantization: levels in {-3..3}
    spec = QuantSpec(bits=3)
    q, delta = quantize(w, spec)
    deq = q.to(torch.float32) * delta
    print(f"delta={float(delta):.4f}  levels {int(q.min())}..{int(q.max())}")
    print(f"quant MSE: {float(torch.mean((w - deq) ** 2)):.2e}")

    # 3. the STE fake-quant view, what the retraining forward pass sees
    wq = fake_quant(w, spec)
    print(f"fake-quant unique levels: {len(torch.unique(wq))} (<= 7)")

    # 4. packed into the on-chip container format: 10 weights a word
    words = pack_matrix(q, 3)
    fp32_mb = w.numel() * 4 / 2 ** 20
    packed_mb = words.numel() * 4 / 2 ** 20
    print(f"packed: {fp32_mb:.2f} MB fp32 -> {packed_mb:.3f} MB "
          f"({fp32_mb / packed_mb:.1f}x smaller, the paper's BRAM image)")

    # 5. the paper's batch of 100 through the kernels
    d = delta.reshape(1).expand(w.shape[1]).to(torch.float32)
    y_ref = x @ deq
    ys = {"qmatmul": qmatmul(x, q, d),
          "qmatvec": qmatvec(x, words, d, k=w.shape[0])}
    scale = float(y_ref.abs().max())
    errs = {name: float((y - y_ref).abs().max()) for name, y in ys.items()}
    for name, err in errs.items():
        print(f"{name}  vs ref: {err:.2e} (max|ref| {scale:.2f})")
    return {"q": q, "delta": delta, "fake_quant": wq, "words": words,
            "outputs": ys, "errors": errs, "max_ref": scale}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = torch.device(ap.parse_args(argv).device)
    gen = torch.Generator(device=dev).manual_seed(0)
    # 1. a weight matrix, like one layer of the paper's network
    w = torch.randn((784, 1022), generator=gen, device=dev) * 0.1
    x = torch.randn((100, 784), generator=gen, device=dev)
    res = run(w, x)
    print(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else dev}")
    bad = {k: e for k, e in res["errors"].items()
           if e > TOL * res["max_ref"]}
    if bad:
        raise SystemExit(f"quickstart: {bad} past {TOL} x max|ref| "
                         f"({res['max_ref']:.3f})")
    return res


if __name__ == "__main__":
    main()
