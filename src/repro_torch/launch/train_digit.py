"""The paper's digit (or phoneme) experiment end to end (§2.1): RBM
pretrain -> float train -> optimal 3-bit quantization -> STE retrain ->
packed deployment check, on the card.

    PYTHONPATH=src python -m repro_torch.launch.train_digit            # quick
    PYTHONPATH=src python -m repro_torch.launch.train_digit --full     # paper recipe
    PYTHONPATH=src python -m repro_torch.launch.train_digit --device cpu

The same flags as the reference's ``examples/train_digit.py``, plus
``--device`` (default ``cuda``; without a card it raises).
"""
import argparse
import json

from repro_torch.paper.pipeline import PaperRunConfig, run_paper_experiment


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="paper's full recipe: 1022-wide, 50+100+100 epochs")
    ap.add_argument("--task", default="digit", choices=["digit", "phoneme"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.full:
        rc = PaperRunConfig(task=args.task)
    else:
        rc = PaperRunConfig(task=args.task, hidden=(256, 256, 256),
                            pretrain_epochs=8, float_epochs=15,
                            retrain_epochs=10)
    metrics = run_paper_experiment(rc, log=print, device=args.device)
    metrics.pop("params")
    print(json.dumps({k: round(v, 4) if isinstance(v, float) else v
                      for k, v in metrics.items()}, indent=2))


if __name__ == "__main__":
    main()
