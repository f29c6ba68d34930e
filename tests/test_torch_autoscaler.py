"""The port's elastic capacity (``Router.add_replica`` / ``begin_retire`` /
``finish_retires``, the daemon's ``add_replica`` / ``restart_replica`` /
``retire_replica``) and ``serving/autoscaler.py`` against the JAX
package's, on the CPU.

* CONTROL LOOP: on the same scripted signals (stub daemons, an injected
  clock) the port's ``Autoscaler`` makes JAX's decision tick for tick —
  the same actions, victims, warm flags, streaks, events, capacity log
  and chip-seconds, exactly; hysteresis, the floor and the ceiling, the
  freeze while a retire drains and shed-as-up-pressure hold as in JAX.
* MECHANISM, on the port's threaded tier (tiny CausalLM on converted JAX
  weights): a retire drains first (zero drops, the replica ``retired``,
  not failed), refuses the last capacity, and a restart re-serves
  (builds and loads after the prewarm are gated on the card, where the
  kernels build); ``add_replica`` grows the live
  tier; conservation (``submitted == done + cancelled + failed +
  outstanding``) holds after every cancel, retire and scale step; the
  streams equal JAX's engine on the same weights.
* The threaded runner scales a live tier up under a backlog.

Every wait carries its own timeout; every daemon is closed in ``finally``.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_ibm_mnist_tpu.models import get_model as jax_get_model
from distributed_tensorflow_ibm_mnist_tpu.serving import FIFOScheduler as JaxScheduler
from distributed_tensorflow_ibm_mnist_tpu.serving import InferenceEngine as JaxEngine
from distributed_tensorflow_ibm_mnist_tpu.serving.autoscaler import Autoscaler as JaxAutoscaler
from distributed_tensorflow_ibm_mnist_tpu_torch.convert import causal_lm_state_dict
from distributed_tensorflow_ibm_mnist_tpu_torch.models import CausalLM
from distributed_tensorflow_ibm_mnist_tpu_torch.serving import (
    Autoscaler,
    FIFOScheduler,
    InferenceEngine,
    Router,
    ServingDaemon,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.replica import (
    DRAINING,
    FAILED,
    HEALTHY,
)

torch.set_num_threads(1)

KW = dict(num_classes=16, dim=32, depth=1, heads=2)
PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [2, 4, 6], [9, 1], [3, 3]]
WAIT_S = 60.0


@pytest.fixture(scope="module")
def weights():
    jm = jax_get_model("causal_lm", **KW, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    sd = causal_lm_state_dict(jax.tree.map(np.asarray, params), KW)
    jeng = JaxEngine(jm, params, slots=2, max_len=16, kv_page_size=4,
                     scheduler=JaxScheduler(max_len=16, buckets=(8,)))
    reqs = [jeng.submit(p, max_new=6) for p in PROMPTS]
    jeng.run()
    jeng.close()
    return sd, [list(r.generated) for r in reqs]


def _factory(sd, **kw):
    def make_engine(tid):
        return InferenceEngine(
            CausalLM(device="cpu", dtype=torch.float32, **KW), sd, slots=2, max_len=16,
            kv_page_size=4,
            scheduler=FIFOScheduler(max_len=16, buckets=(8,), max_queue=16),
            trace_tid=tid, device="cpu", **kw)
    return make_engine


def _conserved(daemon) -> bool:
    c = daemon.conservation()
    return c["conserved"] and c["submitted"] == (
        c["done"] + c["cancelled"] + c["failed"] + c["outstanding"])


# ----------------------------------------------------------------- stubs


class _StubEngine:
    def __init__(self, slots=2):
        self.slots = slots
        self.occupied = 0
        self._closed = False


class _StubReplica:
    def __init__(self, index):
        self.index = index
        self.state = HEALTHY
        self.engine = _StubEngine()
        self.retired = False
        self.spawn_s = 0.01
        self.load = 0.0

    @property
    def alive(self):
        return not self.engine._closed


class _StubPolicy:
    def __init__(self):
        self.shed = 0


class _StubDaemon:
    """The daemon surface the autoscaler reads and steers."""

    def __init__(self, n=2):
        class _R:
            pass
        self.router = _R()
        self.router.replicas = [_StubReplica(i) for i in range(n)]
        self.router._retiring = set()
        self._adm_cv = threading.Lock()
        self._admission = []
        self._inflight = {}
        self.policy = _StubPolicy()
        self._telemetry = None
        self.retired_calls = []
        self.added = 0

    def retire_replica(self, index):
        rep = self.router.replicas[index]
        rep.state = DRAINING
        rep.engine._closed = True
        rep.retired = True
        self.retired_calls.append(index)
        return True

    def restart_replica(self, index):
        rep = self.router.replicas[index]
        rep.state = HEALTHY
        rep.engine = _StubEngine()
        rep.retired = False
        return 0.005

    def add_replica(self, role="both"):
        rep = _StubReplica(len(self.router.replicas))
        self.router.replicas.append(rep)
        self.added += 1
        return rep


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _script(stub, step):
    """Signal script: backlog bursts, busy stretches, sheds, lulls, retire
    freezes and drained retirements, a function of the tick number."""
    stub._admission = list(range([0, 20, 20, 0, 20, 20, 20, 0, 0, 0, 0, 0, 50,
                                  0, 0, 0, 3, 0, 0, 0][step % 20]))
    for i, rep in enumerate(stub.router.replicas):
        rep.engine.occupied = rep.engine.slots if step % 7 == 3 else (i + step) % 2
        rep.load = float((i * 3 + step) % 5)
    if step == 9:
        stub.policy.shed += 2
    if step % 11 == 5:
        stub.router._retiring.add(0)
    elif step % 11 == 6:
        stub.router._retiring.clear()


@pytest.mark.parametrize("cfg", [
    dict(min_replicas=1, max_replicas=4, hysteresis_up=2, hysteresis_down=2,
         down_occupancy=0.6),
    dict(min_replicas=2, max_replicas=3, hysteresis_up=1, hysteresis_down=3,
         down_occupancy=0.9, up_backlog_per_slot=2.0),
    dict(min_replicas=1, max_replicas=None, hysteresis_up=3, hysteresis_down=1,
         down_occupancy=0.4),
], ids=["1-4", "2-3", "unbounded"])
def test_decisions_equal_jax_tick_for_tick(cfg):
    runs = []
    for cls in (Autoscaler, JaxAutoscaler):
        stub, clock = _StubDaemon(n=2), _Clock()
        asc = cls(stub, clock=clock, **cfg)
        decisions, streaks = [], []
        for step in range(60):
            clock.t += 0.25
            _script(stub, step)
            decisions.append(asc.tick())
            streaks.append((asc._up_streak, asc._down_streak))
        clock.t += 1.0
        runs.append((decisions, streaks, asc.events, asc._capacity_log,
                     asc.chip_seconds(), asc.summary(), stub.retired_calls, stub.added))
    assert runs[0] == runs[1]
    decisions = runs[0][0]
    assert "up" in decisions and "down" in decisions


def test_hysteresis_streaks_and_reset():
    stub = _StubDaemon(n=2)
    asc = Autoscaler(stub, min_replicas=1, max_replicas=4, hysteresis_up=3,
                     hysteresis_down=3, down_occupancy=0.5)
    stub._admission = list(range(20))     # heavy backlog: up-pressure
    assert asc.tick() is None
    assert asc.tick() is None
    stub._admission = []
    for rep in stub.router.replicas:
        rep.engine.occupied = rep.engine.slots   # busy: no down either
    assert asc.tick() is None                    # contrary evidence resets
    stub._admission = list(range(20))
    assert asc.tick() is None
    assert asc.tick() is None
    assert asc.tick() == "up"
    assert stub.added == 1
    assert asc.events[-1]["action"] == "up" and not asc.events[-1]["warm"]


def test_shed_ceiling_floor_freeze_and_victims():
    stub = _StubDaemon(n=1)
    asc = Autoscaler(stub, min_replicas=1, max_replicas=2, hysteresis_up=1,
                     hysteresis_down=10)
    stub.policy.shed = 3
    assert asc.tick() == "up"                    # a shed is up-pressure at once
    stub = _StubDaemon(n=2)
    asc = Autoscaler(stub, min_replicas=2, max_replicas=2, hysteresis_up=1,
                     hysteresis_down=1, down_occupancy=0.9)
    stub._admission = list(range(50))
    assert asc.tick() is None                    # the ceiling vetoes up
    stub._admission = []
    assert asc.tick() is None                    # the floor vetoes down
    stub.router._retiring.add(1)
    stub._admission = list(range(50))
    assert asc.tick() is None                    # frozen while a retire drains
    stub = _StubDaemon(n=3)
    for i, load in enumerate((0.5, 3.0, 0.5)):
        stub.router.replicas[i].load = load
    asc = Autoscaler(stub, min_replicas=1, max_replicas=3, hysteresis_up=1,
                     hysteresis_down=1, down_occupancy=0.9)
    assert asc.tick() == "down" and stub.retired_calls == [2]
    stub.router._retiring.clear()
    stub._admission = list(range(50))
    assert asc.tick() == "up" and stub.added == 0   # the retired one comes back
    ev = asc.events[-1]
    assert ev["warm"] and ev["replica"] == 2
    s = asc.summary()
    assert s["scale_ups"] == 1 and s["scale_downs"] == 1 and s["warm_ups"] == 1
    for bad in (dict(min_replicas=0), dict(min_replicas=3, max_replicas=2),
                dict(hysteresis_up=0)):
        with pytest.raises(ValueError):
            Autoscaler(_StubDaemon(), **bad)


# ------------------------------------------------------------ live tier


def test_retire_drains_zero_drops_then_warm_restart(weights):
    sd, want = weights
    router = Router(_factory(sd), 2)
    daemon = ServingDaemon(router, max_queue=64).start()
    try:
        wave = [daemon.submit(p, 6) for p in PROMPTS]
        assert daemon.retire_replica(1)
        assert _conserved(daemon)
        assert router.replicas[1].state in (DRAINING, FAILED)
        for dr in wave:
            assert dr.wait(timeout=WAIT_S) and dr.status == "done", (dr.id, dr.error)
        assert [dr.tokens for dr in wave] == want
        deadline = time.monotonic() + WAIT_S
        while time.monotonic() < deadline and router._retiring:
            time.sleep(0.02)
        rep = router.replicas[1]
        assert rep.state == FAILED and rep.retired and not rep.alive
        assert router.retires == 1
        summ = router.summary()
        assert summ["replicas_failed"] == 0 and summ["replicas_retired"] == 1
        assert _conserved(daemon)
        assert daemon.retire_replica(0) is False      # the last capacity stays
        spawn_s = daemon.restart_replica(1)
        assert spawn_s >= 0.0 and rep.state == HEALTHY and not rep.retired
        wave2 = [daemon.submit(p, 6) for p in PROMPTS]
        for dr in wave2:
            assert dr.wait(timeout=WAIT_S) and dr.status == "done"
        assert [dr.tokens for dr in wave2] == want
        assert _conserved(daemon) and daemon.conservation()["failed"] == 0
        assert daemon.drain(timeout=WAIT_S)
    finally:
        daemon.close()


def test_add_replica_and_cancel_keep_conservation(weights):
    sd, want = weights
    router = Router(_factory(sd), 1)
    daemon = ServingDaemon(router, max_queue=64).start()
    try:
        wave = [daemon.submit(p, 6) for p in PROMPTS[:3]]
        rep = daemon.add_replica()
        assert rep.index == 1 and rep.state == HEALTHY and router.scale_ups == 1
        assert _conserved(daemon)
        wave += [daemon.submit(p, 6) for p in PROMPTS]
        doomed = daemon.submit([5, 5, 5], 6)
        assert daemon.cancel(doomed)
        assert _conserved(daemon)
        assert doomed.wait(timeout=WAIT_S) and doomed.status in ("cancelled", "done")
        for dr in wave:
            assert dr.wait(timeout=WAIT_S) and dr.status == "done"
        assert [dr.tokens for dr in wave] == want[:3] + want
        assert daemon.cancel(wave[0]) is False             # terminal already
        served = sum(r.engine.stats.summary()["n_done"]
                     for r in router.replicas if r.alive)
        assert served == len(wave) + (doomed.status == "done")
        assert daemon.drain(timeout=WAIT_S)
        assert _conserved(daemon)
    finally:
        daemon.close()


def test_threaded_runner_scales_a_live_tier(weights):
    sd, want = weights
    router = Router(_factory(sd), 1)
    daemon = ServingDaemon(router, max_queue=64).start()
    asc = Autoscaler(daemon, min_replicas=1, max_replicas=2, hysteresis_up=1,
                     hysteresis_down=1000, up_backlog_per_slot=1.5, interval_s=0.02)
    try:
        with asc:
            wave = [daemon.submit(p, 6) for p in PROMPTS * 3]
            for dr in wave:
                assert dr.wait(timeout=WAIT_S)
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline and not asc.events:
                time.sleep(0.02)
        assert all(dr.status == "done" for dr in wave)
        assert [dr.tokens for dr in wave] == want * 3
        assert asc.summary()["scale_ups"] >= 1
        assert _conserved(daemon)
        assert daemon.drain(timeout=WAIT_S)
    finally:
        asc.stop()
        daemon.close()
