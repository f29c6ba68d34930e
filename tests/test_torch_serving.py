"""The port's InferenceEngine against the JAX InferenceEngine.

Parity: on converted weights, both engines serve the same stream — two
slots, five requests over two prompt buckets with mixed budgets and one
EOS id, decode_ahead=1 — and every request's greedy tokens are identical.
Both sides run float32 on the CPU (the port's flash attention through its
plain version, JAX's in Pallas interpret mode).

Lifecycle (port only): bounded-queue backpressure, deadline cancels of
queued and running requests, callback-failure isolation, and refusal of
the knobs later slices port (and of bad values of the ported ones).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_ibm_mnist_tpu.models import get_model as jax_get_model
from distributed_tensorflow_ibm_mnist_tpu.serving import InferenceEngine as JaxEngine
from distributed_tensorflow_ibm_mnist_tpu_torch.convert import load_causal_lm
from distributed_tensorflow_ibm_mnist_tpu_torch.core.generate import make_generator
from distributed_tensorflow_ibm_mnist_tpu_torch.serving import (
    FIFOScheduler,
    InferenceEngine,
    QueueFull,
    SamplingParams,
)

torch.set_num_threads(1)

KW = dict(num_classes=48, dim=64, depth=2, heads=4, attn="flash")
# (prompt length, max_new): prompts over buckets 8 and 16
STREAM = [(5, 6), (12, 9), (3, 4), (14, 7), (8, 10)]


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _pair(seed=0):
    jm = jax_get_model("causal_lm", **KW, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    tm = load_causal_lm(jax.tree.map(np.asarray, params), device="cpu", **KW,
                        dtype=torch.float32)
    return jm, params, tm


def _prompts(seed=1):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, KW["num_classes"], n).tolist(), m) for n, m in STREAM]


def test_engine_streams_token_identical_to_jax_engine():
    jm, params, tm = _pair()
    prompts = _prompts()
    # an EOS the model really emits: request 3's third greedy token
    free = make_generator(tm, 32, 8)(torch.tensor([prompts[3][0]]))
    eos_id = int(free[0, len(prompts[3][0]) + 2])
    streams = {}
    for name, eng in (
            ("torch", InferenceEngine(tm, slots=2, max_len=32, buckets=(8, 16),
                                      eos_id=eos_id, device="cpu")),
            ("jax", JaxEngine(jm, params, slots=2, max_len=32, buckets=(8, 16),
                              eos_id=eos_id, decode_ahead=1))):
        for prompt, max_new in prompts:
            eng.submit(prompt, max_new)
        done = eng.run()
        assert len(done) == len(STREAM) and all(r.status == "done" for r in done)
        streams[name] = {r.id: list(r.generated) for r in done}
    assert streams["torch"] == streams["jax"]
    stopped = [g for g in streams["torch"].values() if g[-1] == eos_id]
    budget = [g for i, g in streams["torch"].items() if len(g) == STREAM[i][1]]
    assert stopped and budget  # both retirement paths ran


def test_stats_record_the_run():
    _, _, tm = _pair()
    eng = InferenceEngine(tm, slots=2, max_len=32, buckets=(8, 16), device="cpu")
    for prompt, max_new in _prompts():
        eng.submit(prompt, max_new)
    done = eng.run()
    s = eng.stats.summary()
    assert s["n_requests"] == s["n_done"] == 5
    assert s["tokens_generated"] == sum(m for _, m in STREAM) == sum(
        len(r.generated) for r in done)
    assert s["ttft_s_p50"] is not None and s["latency_s_p99"] is not None
    assert 0 < s["slot_occupancy"] <= 1 and s["decode_steps"] > 0
    assert all(len(r.logprobs) == len(r.generated) for r in done)


def test_queue_full_backpressure():
    _, _, tm = _pair()
    sched = FIFOScheduler(max_len=32, buckets=(8, 16), max_queue=2)
    eng = InferenceEngine(tm, slots=1, max_len=32, scheduler=sched, device="cpu")
    eng.submit([1, 2], 2)
    eng.submit([3, 4], 2)
    with pytest.raises(QueueFull):
        eng.submit([5, 6], 2)
    assert len(eng.run()) == 2
    eng.submit([5, 6], 2)  # capacity is back once the queue drained


def test_deadline_cancels_running_and_queued_requests():
    _, _, tm = _pair()
    clock = _FakeClock()
    eng = InferenceEngine(tm, slots=1, max_len=32, buckets=(8, 16), clock=clock,
                          device="cpu")
    running = eng.submit([1, 2, 3], 20, deadline_s=1.0)
    queued = eng.submit([4, 5], 4, deadline_s=1.0)
    eng.step()  # admits `running`; `queued` waits for the only slot
    assert running.status == "running" and queued.status == "queued"
    clock.t = 5.0
    done = eng.run()
    assert running.status == "cancelled" and 0 < len(running.generated) < 20
    assert queued.status == "cancelled" and queued.generated == []
    assert {r.id for r in done} == {running.id, queued.id}
    assert eng.stats.summary()["n_cancelled"] == 2
    assert not eng.cache["block_0"]["index"].any()  # the row was reset


def test_callback_failure_is_isolated():
    _, _, tm = _pair()
    eng = InferenceEngine(tm, slots=2, max_len=32, buckets=(8, 16), device="cpu")

    def boom(req, tok):
        if len(req.generated) == 2:
            raise RuntimeError("client went away")

    bad = eng.submit([1, 2, 3], 6, callback=boom)
    good = eng.submit([4, 5, 6], 6)
    eng.run()
    assert bad.status == "failed" and "client went away" in bad.error
    assert good.status == "done" and len(good.generated) == 6


# decode_ahead, prefix_cache_bytes, kv_page_size, speculative,
# prefill_chunk and quant are ported: their cases now hold the refusals of
# bad values that the JAX engine makes too.  chaos, tracer and telemetry are
# ported too (tests/test_torch_router.py holds them against JAX's), and so
# is role (tests/test_torch_disagg.py): its cases hold JAX's refusals.  tp is
# ported (tests/test_torch_tp_serving.py): outside a spawned world it asks for
# the launcher, as the Trainer's tp does; cp is ported too
# (tests/test_torch_cp_serving.py): on the dense layout it takes JAX's refusal
@pytest.mark.parametrize("knob, error, match", [
    pytest.param(dict(decode_ahead=0), ValueError, "decode_ahead", id="decode_ahead"),
    pytest.param(dict(speculative="beam"), ValueError, "speculative", id="speculative"),
    pytest.param(dict(prefix_cache_bytes=-1), ValueError, "prefix_cache_bytes", id="prefix_cache_bytes"),
    pytest.param(dict(kv_page_size=7), ValueError, "multiple of kv_page_size", id="kv_page_size"),
    pytest.param(dict(prefill_chunk=8), ValueError, "kv_page_size", id="prefill_chunk"),
    pytest.param(dict(tp=2), ValueError, "launch.torchrun", id="tp"),
    pytest.param(dict(cp=2), ValueError, "needs the paged cache", id="cp"),
    pytest.param(dict(quant="int4"), ValueError, "quant", id="quant"),
    pytest.param(dict(role="prefill"), ValueError, "needs the paged cache", id="role"),
    pytest.param(dict(role="decode", kv_page_size=8, speculative="ngram"), ValueError,
                 "speculative decoding does not compose with disaggregated", id="role_spec"),
])
def test_later_slice_knobs_refuse(knob, error, match):
    _, _, tm = _pair()
    with pytest.raises(error, match=match):
        InferenceEngine(tm, slots=1, max_len=32, device="cpu", **knob)


def test_sampled_requests_refuse_and_lifecycle_guards():
    _, _, tm = _pair()
    # sampling is ported: what still refuses is engine-level sampling
    # without a key, and a filter without sampling
    with pytest.raises(ValueError, match="rng"):
        InferenceEngine(tm, slots=1, max_len=32, device="cpu", temperature=0.8)
    with pytest.raises(ValueError, match="temperature > 0"):
        InferenceEngine(tm, slots=1, max_len=32, device="cpu", top_k=4)
    eng = InferenceEngine(tm, slots=1, max_len=32, buckets=(8, 16), device="cpu")
    eng.submit([1, 2], 4, sampling=SamplingParams(temperature=0.8, seed=1))
    eng.submit([1, 2], 4, sampling=SamplingParams())  # greedy is fine
    eng.close()
    assert [r.status for r in eng.completed] == ["cancelled"] * 2
    assert all(r.engine_fault for r in eng.completed)
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit([1, 2], 4)
    with pytest.raises(RuntimeError, match="closed"):
        eng.step()
