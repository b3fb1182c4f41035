"""The two quickstart examples of the port (``repro_torch.launch.quickstart``
and ``repro_torch.launch.serve_quantized``, the counterparts of the
reference's ``examples/quickstart.py`` and ``examples/serve_quantized.py``)
run end to end on the CPU, through the kernels' plain versions, at the
reference examples' sizes (the serve example at ``reduced`` size), and on
the same inputs agree with what the reference examples compute in JAX."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, reduced as jreduced
from repro.core import QuantSpec as JQuantSpec
from repro.core import fake_quant as jfake_quant
from repro.core import pack_matrix as jpack_matrix
from repro.core import quant_dense as jqd
from repro.core import quantizer as jqz
from repro.core.precision import W3A8 as JW3A8
from repro.kernels.qmatmul.ops import qmatmul as jqmatmul
from repro.kernels.qmatvec.ops import qmatvec as jqmatvec
from repro.models import get_model as jget_model
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.engine import generate as jgenerate

from repro_torch import bridge
from repro_torch.configs import get_config, reduced
from repro_torch.launch import quickstart, serve_quantized


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: these small eager ops only lose to thread
    hand-offs when the suite's workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quickstart_runs_on_cpu(capsys):
    """Quantize, fake-quant, pack, then qmatmul and qmatvec against the
    dequantized product: within the example's own 1e-4 x max|ref|."""
    res = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "levels -3..3" in out and "fake-quant unique levels: 7" in out
    assert max(res["errors"].values()) <= 1e-4 * res["max_ref"]


def test_quickstart_matches_jax():
    """The quickstart's steps on one seeded (784, 1022) weight and batch of
    100, against the reference's ``repro.core`` and Pallas kernels
    (interpret mode): delta within rtol 1e-6 (the frameworks sum the
    least-squares terms in other orders, so an independent fit may round
    a weight lying on a level boundary the other way), the levels equal
    to JAX's from the same delta, the fake-quant view within 1e-7
    absolute, the container words bit for bit, and both products within
    1e-5 x max|JAX product| of the reference kernels on the same levels."""
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((784, 1022)) * 0.1).astype(np.float32)
    x = rng.standard_normal((100, 784)).astype(np.float32)
    res = quickstart.run(torch.from_numpy(w), torch.from_numpy(x))
    spec = JQuantSpec(bits=3)
    _, jd = jqz.quantize(jnp.asarray(w), spec)
    np.testing.assert_allclose(float(res["delta"]), float(jd), rtol=1e-6)
    d = jnp.asarray(res["delta"].numpy())
    q = res["q"].numpy()
    np.testing.assert_array_equal(
        q, np.asarray(jqz.quantize_levels(jnp.asarray(w), d, spec)))
    np.testing.assert_allclose(
        res["fake_quant"].numpy(),
        np.asarray(jfake_quant(jnp.asarray(w), spec, delta=d)), atol=1e-7,
        rtol=0)
    words = np.asarray(jpack_matrix(jnp.asarray(q), 3))
    np.testing.assert_array_equal(res["words"].numpy(), words)
    dn = jnp.broadcast_to(d, (1022,))
    ref = {"qmatmul": jqmatmul(jnp.asarray(x), jnp.asarray(q), dn),
           "qmatvec": jqmatvec(jnp.asarray(x), jnp.asarray(words), dn,
                               k=784)}
    for name, y in ref.items():
        y = np.asarray(y)
        np.testing.assert_allclose(res["outputs"][name].numpy(), y,
                                   atol=1e-5 * np.abs(y).max(), rtol=0)


def test_serve_quantized_runs_on_cpu(capsys):
    """Export to qp containers, generate a batch of 4, serve 6 mixed-length
    requests in two bucketed admissions: every row and request full
    length."""
    res = serve_quantized.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "batch generate: (4, 24)" in out
    assert res["requests"] == 6 and res["tokens"] == 48
    assert res["generate"].shape == (4, 24) and res["prefill_calls"] == 2
    assert "on cpu" in out and torch.is_tensor(res["generate"])


def test_serve_quantized_matches_jax():
    """The serve example's ``generate`` and continuous batching on the
    reference example's reduced qwen2-1.5b (seed-0 JAX weights exported
    to W3A8 containers, bridged) and a seeded batch of 4 prompts, against
    the reference's ``generate`` and ``ServingEngine`` on the same
    weights, prompts and requests: token for token, with the same decode
    ticks and prefill calls. Both in fp32: in bf16 these random weights
    give top-2 logits within one bf16 ulp (0.627 / 0.626 at a request's
    fifth token), which the frameworks round apart."""
    jcfg = jreduced(jget_config("qwen2-1.5b"), layers=4, d_model=128,
                    vocab=512)
    cfg = reduced(get_config("qwen2-1.5b"), layers=4, d_model=128, vocab=512)
    jp = jqd.export_container(jget_model(jcfg).init(jax.random.PRNGKey(0),
                                                    jcfg), JW3A8)
    tp = bridge.to_torch(jax.device_get(jp))
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 8)).astype(np.int32)
    got = serve_quantized.serve(tp, cfg, torch.from_numpy(prompts),
                                torch.device("cpu"), dtype=torch.float32)
    ref = jgenerate(jp, jnp.asarray(prompts), jcfg, policy=JW3A8,
                    max_new_tokens=serve_quantized.MAX_NEW,
                    dtype=jnp.float32)
    np.testing.assert_array_equal(got["generate"].numpy(), np.asarray(ref))
    jeng = JServingEngine(jp, jcfg, policy=JW3A8, slots=4, max_len=64,
                          dtype=jnp.float32)
    for p in serve_quantized.REQUESTS:
        jeng.submit(p, max_new=serve_quantized.REQUEST_NEW)
    done = sorted(jeng.run_all(), key=lambda r: r.uid)
    assert got["outs"] == [list(r.out) for r in done]
    assert (got["ticks"], got["prefill_calls"]) == (jeng.decode_calls,
                                                    jeng.prefill_calls)
