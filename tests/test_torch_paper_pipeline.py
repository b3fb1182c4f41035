"""The port's paper pipeline end to end on the CPU, at the reduced size of
the reference's ``tests/test_paper_pipeline.py`` and held to the same four
invariants. The port draws its init and noise from ``torch.Generator``s,
so its numbers are its own; the invariants are what must hold."""
import pytest
import torch

from repro_torch.paper.pipeline import PaperRunConfig, run_paper_experiment


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: these small eager ops only lose to thread
    hand-offs when the suite's workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def digit_result():
    rc = PaperRunConfig(task="digit", hidden=(64, 64, 64), pretrain_epochs=3,
                        float_epochs=6, retrain_epochs=4)
    return run_paper_experiment(rc, log=lambda s: None, device="cpu")


def test_pipeline_trains(digit_result):
    assert digit_result["float_mcr"] < 35.0


def test_retraining_recovers_quantization_loss(digit_result):
    m = digit_result
    assert m["w3a8_mcr"] <= m["direct_quant_mcr"] + 1e-9
    assert m["w3a8_mcr"] - m["float_mcr"] < 15.0   # reduced-size loose bound


def test_packed_deployment_exact(digit_result):
    assert digit_result["packed_max_err"] < 1e-4


def test_onchip_compression_ratio(digit_result):
    ratio = digit_result["weight_bytes_float"] / digit_result["weight_bytes_packed"]
    assert ratio > 8.0
