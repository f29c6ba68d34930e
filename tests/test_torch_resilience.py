"""Fault tolerance of the port: chaos (``utils/chaos.py``), recovery and
preemption (``utils/elastic.py``), the numeric-health checks
(``utils/debug.py``) and profiling (``utils/profiling.py``), on the CPU.

* CHAOS: the port's ``FaultInjector`` fires on the same event indices as
  the JAX package's for the same seeded plans (pinned, probabilistic,
  capped, several sites), with the same ``SITES`` and the same refusals.
* RECOVERY SCHEDULE: ``run_with_recovery``'s backoff sequence, restart
  count and window accounting equal JAX's under the same fake clock and
  sleep (the jitter is the same function of (seed, attempt)).
* THE TRAINER UNDER FAULTS: a ``train-step`` NaN under ``run_with_recovery``
  restores the previous durable step and finishes BIT-equal to the
  fault-free run; a ``data-batch`` I/O fault in stream mode restarts, with
  a strict-JSON ``restart`` record; a budget too small re-raises;
  preemption checkpoints and returns ``preempted``; a real SIGTERM flips a
  ``PreemptionHandler``, which degrades off the main thread.
* DEBUG: ``all_finite`` (one fused reduction), ``find_nonfinite``,
  ``check_state``, ``inject_nan`` as JAX's, on modules and train states.
* PROFILING: ``StepTimer`` and ``profile_fn`` (fenced, warm-up excluded,
  strict-JSON with no post-warm-up sample), ``TraceSession`` (idempotent
  stop; a Chrome trace), ``profile_dir`` on a fit, the CLI's
  ``--profile`` and ``--resume``.
"""

import json
import os
import signal
import threading
import warnings

import pytest
import torch

from distributed_tensorflow_ibm_mnist_tpu.utils import chaos as jax_chaos
from distributed_tensorflow_ibm_mnist_tpu.utils import elastic as jax_elastic
from distributed_tensorflow_ibm_mnist_tpu_torch.core.trainer import Trainer
from distributed_tensorflow_ibm_mnist_tpu_torch.launch.cli import build_config
from distributed_tensorflow_ibm_mnist_tpu_torch.models import get_model
from distributed_tensorflow_ibm_mnist_tpu_torch.utils import chaos, debug, elastic
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.config import RunConfig
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.profiling import (
    StepTimer,
    TraceSession,
    profile_fn,
)

torch.set_num_threads(1)


# ---------------------------------------------------------------- chaos

PLANS = {
    "pinned": (3, (("train-step", "nan", (2, 5), 0.0, None),)),
    "coin-capped": (3, (("data-batch", "io", (), 0.25, 3),)),
    "mixed-sites": (11, (("checkpoint-write", "torn", (1,), 0.1, None),
                         ("checkpoint-read", "io", (), 0.3, 2),
                         ("data-batch", "io", (4,), 0.05, None),
                         ("train-step", "raise", (), 0.2, 1))),
    "shadowed": (5, (("data-batch", "io", (0, 1, 2), 0.0, 2),
                     ("data-batch", "slow", (), 0.5, None))),
}


def _fired(module, seed, specs, events=64):
    plan = module.FaultPlan(seed=seed, faults=tuple(
        module.FaultSpec(site=s, kind=k, at=at, prob=p, max_fires=m)
        for s, k, at, p, m in specs))
    inj = module.FaultInjector(plan)
    for site in ("data-batch", "train-step", "checkpoint-write", "checkpoint-read") * 2:
        for _ in range(events // 2):
            inj.fire(site)
    return [(f.site, f.event, f.kind, f.spec_idx) for f in inj.fired], inj.summary()


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_injector_fires_on_jax_event_indices(plan):
    seed, specs = PLANS[plan]
    got, got_summary = _fired(chaos, seed, specs)
    want, want_summary = _fired(jax_chaos, seed, specs)
    assert got and got == want and got_summary == want_summary


def test_sites_and_refusals_are_jaxs():
    assert chaos.SITES == jax_chaos.SITES and len(chaos.SITES) == 12
    with pytest.raises(ValueError, match="unknown chaos site"):
        chaos.FaultSpec(site="nope")
    with pytest.raises(ValueError, match="unknown chaos site"):
        chaos.FaultInjector(chaos.FaultPlan()).fire("nope")
    with pytest.raises(ValueError, match="prob"):
        chaos.FaultSpec(site="train-step", prob=1.5)
    inj = chaos.FaultInjector(chaos.FaultPlan(faults=(
        chaos.FaultSpec(site="checkpoint-read", kind="io", at=(0,)),
        chaos.FaultSpec(site="serving-admit", kind="poison", at=(0,)),
    )))
    with pytest.raises(OSError, match="chaos"):
        inj.raise_if_fired("checkpoint-read", OSError)
    with pytest.raises(chaos.ChaosFault, match="serving-admit"):
        inj.raise_if_fired("serving-admit")
    inj.raise_if_fired("checkpoint-read", OSError)  # event 1: no fire


# ---------------------------------------------------------------- recovery schedule


def _stub_trainer(module_config, outcomes):
    class Writer:
        records: list = []

        def write(self, kind, **k):
            Writer.records.append((kind, k))
            return {}

    class Stub:
        steps_per_epoch = 1
        _ckpt = None
        writer = Writer()

        def __init__(self):
            self.config = module_config(checkpoint_dir="/nonexistent-ck")

        def fit(self, preemption=None):
            out = outcomes.pop(0)
            if isinstance(out, BaseException):
                raise out
            return dict(out)

    return Stub, Writer


@pytest.mark.parametrize("window, max_restarts, gap", [
    (None, 3, 1.0), (10.0, 1, 100.0), (10.0, 2, 4.0), (None, 1, 100.0)])
def test_recovery_schedule_equals_jax(window, max_restarts, gap):
    """Backoffs, restart counts and the give-up point under one fake clock."""
    from distributed_tensorflow_ibm_mnist_tpu.utils.config import RunConfig as JaxRunConfig

    def run(module, cfg_cls):
        outcomes = [OSError("a"), FloatingPointError("b"), OSError("c"),
                    debug.TrainingDiverged("d"), {"ok": 1}]
        stub, writer = _stub_trainer(cfg_cls, outcomes)
        now, slept = [0.0], []

        def clock():
            now[0] += gap
            return now[0]

        if module is jax_elastic:  # the JAX set names the JAX exception class
            outcomes[3] = jax_elastic.TrainingDiverged("d")
        try:
            out = module.run_with_recovery(
                stub, max_restarts=max_restarts, restart_window_s=window,
                backoff_base_s=0.5, backoff_max_s=3.0, jitter_seed=4,
                sleep=slept.append, clock=clock)
            result = ("done", out["restarts"])
        except (OSError, FloatingPointError, RuntimeError) as e:
            result = ("raised", type(e).__name__)
        return result, slept, [r for r in writer.records if r[0] == "restart"]

    got, want = run(elastic, RunConfig), run(jax_elastic, JaxRunConfig)
    assert got == want


def test_jitter_and_retryable_set_are_jaxs():
    assert [elastic._jitter(s, a) for s in (0, 7) for a in range(1, 6)] == [
        jax_elastic._jitter(s, a) for s in (0, 7) for a in range(1, 6)]
    assert [c.__name__ for c in elastic.DEFAULT_RETRYABLE] == [
        c.__name__ for c in jax_elastic.DEFAULT_RETRYABLE]


# ---------------------------------------------------------------- the Trainer under faults


def _cfg(tmp_path=None, **kw):
    base = dict(model="mlp", model_kwargs={"hidden": (32,), "dtype": torch.float32},
                synthetic=True, n_train=512, n_test=128, batch_size=64, epochs=3,
                quiet=True, checkpoint_every=1, eval_every=1)
    if tmp_path is not None:
        base["checkpoint_dir"] = str(tmp_path / "ck")
    return RunConfig(**{**base, **kw})


def _state_equal(a, b) -> bool:
    sa, sb = a.model.state_dict(), b.model.state_dict()
    return (a.state.step == b.state.step and a.state.optimizer.count == b.state.optimizer.count
            and all(torch.equal(sa[k], sb[k]) for k in sa)
            and all(torch.equal(x, y) for x, y in zip(a.state.optimizer.mu + a.state.optimizer.nu,
                                                      b.state.optimizer.mu + b.state.optimizer.nu)))


def test_nan_step_recovery_is_bit_identical(tmp_path):
    free = Trainer(_cfg(tmp_path / "free"), device="cpu")
    free.fit()
    inj = chaos.FaultInjector(chaos.FaultPlan(seed=11, faults=(
        chaos.FaultSpec(site="train-step", kind="nan", at=(1,)),)))
    made = []

    def make():
        made.append(Trainer(_cfg(tmp_path / "chaos"), device="cpu", chaos=inj))
        return made[-1]

    summary = elastic.run_with_recovery(make, max_restarts=2, backoff_base_s=0.0)
    assert summary["restarts"] == 1 and len(made) == 2
    assert inj.summary()["by_site"] == {"train-step": 1}
    assert made[1].state.step == free.state.step == 3 * free.steps_per_epoch
    assert _state_equal(made[1], free)


def test_data_batch_fault_restarts_with_a_record(tmp_path):
    inj = chaos.FaultInjector(chaos.FaultPlan(faults=(
        chaos.FaultSpec(site="data-batch", kind="io", at=(3,)),)))
    path = tmp_path / "m.jsonl"
    cfg = _cfg(tmp_path, epochs=2, input_mode="stream", stream_chunk=2,
               metrics_path=str(path))
    summary = elastic.run_with_recovery(lambda: Trainer(cfg, device="cpu", chaos=inj),
                                        max_restarts=2, backoff_base_s=0.0)
    assert summary["restarts"] == 1 and inj.summary()["by_site"] == {"data-batch": 1}
    records = [json.loads(line, parse_constant=lambda s: pytest.fail(s))
               for line in path.read_text().splitlines()]
    restarts = [r for r in records if r["kind"] == "restart"]
    assert len(restarts) == 1 and restarts[0]["exception"] == "OSError"
    assert restarts[0]["attempt"] == 1 and restarts[0]["resume_step"] == 0


def test_recovery_gives_up_and_chaos_faults_propagate(tmp_path):
    def poisoned():
        t = Trainer(_cfg(tmp_path, epochs=2), device="cpu")
        debug.inject_nan(t.model, "dense_0.weight")
        return t

    with pytest.raises(debug.TrainingDiverged) as e:
        elastic.run_with_recovery(poisoned, max_restarts=1, backoff_base_s=0.0)
    assert "dense_0.weight" in e.value.bad_leaves
    inj = chaos.FaultInjector(chaos.FaultPlan(faults=(
        chaos.FaultSpec(site="train-step", kind="boom", at=(0,)),)))
    with pytest.raises(chaos.ChaosFault, match="'boom'"):  # not retryable
        elastic.run_with_recovery(lambda: Trainer(_cfg(tmp_path), device="cpu", chaos=inj))


def test_preemption_checkpoints_and_exits(tmp_path):
    t = Trainer(_cfg(tmp_path, epochs=5, checkpoint_every=0), device="cpu")
    with elastic.PreemptionHandler() as h:
        h.trigger()
        summary = t.fit(preemption=h)
    assert summary["preempted"] is True and summary["epochs_run"] == 1
    assert t._ckpt.all_steps() == [t.steps_per_epoch]  # the preemption save, no other
    t2 = Trainer(_cfg(tmp_path, epochs=5, resume=True), device="cpu")
    assert t2.restore_checkpoint() == t.steps_per_epoch


def test_real_sigterm_flips_the_handler_and_it_degrades_off_the_main_thread():
    before = signal.getsignal(signal.SIGTERM)
    with elastic.PreemptionHandler() as h:
        assert h.installed and not h.triggered
        os.kill(os.getpid(), signal.SIGTERM)
        assert h.triggered
    assert signal.getsignal(signal.SIGTERM) == before
    res = {}

    def target():
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            with elastic.PreemptionHandler() as h2:
                res["installed"], res["pre"] = h2.installed, h2.triggered
                h2.trigger()
                res["post"] = h2.triggered
            res["warned"] = any("main thread" in str(x.message) for x in w)

    th = threading.Thread(target=target)
    th.start()
    th.join(timeout=30)
    assert res == {"installed": False, "pre": False, "post": True, "warned": True}


CHILD = """
import sys, json, torch
torch.set_num_threads(1)
from distributed_tensorflow_ibm_mnist_tpu_torch.core.trainer import Trainer
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.config import RunConfig
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.elastic import PreemptionHandler
cfg = RunConfig(model="mlp", model_kwargs={"hidden": (32,)}, synthetic=True, n_train=4096,
                n_test=64, batch_size=16, epochs=50, checkpoint_dir=sys.argv[1])
with PreemptionHandler() as h, Trainer(cfg, device="cpu") as t:
    s = t.fit(preemption=h)
    print(json.dumps({"kind": "child", "preempted": s.get("preempted"),
                      "step": t.state.step, "steps": t._ckpt.all_steps()}), flush=True)
"""


def test_a_real_sigterm_preempts_a_training_child_process(tmp_path):
    """chip_smoke's (b) on the CPU: SIGTERM after the child's first epoch
    record; the child checkpoints once and exits 0, preempted."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    child = subprocess.Popen([sys.executable, "-c", CHILD, str(tmp_path / "ck")], cwd=root,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    lines = []
    try:
        for line in child.stdout:
            lines.append(json.loads(line))
            if lines[-1]["kind"] == "epoch" and len(lines) == 1:
                child.send_signal(signal.SIGTERM)
        assert child.wait(timeout=120) == 0, child.stderr.read()
    finally:
        if child.poll() is None:
            child.kill()
        child.stdout.close()
        child.stderr.close()
    final = lines[-1]
    assert final["kind"] == "child" and final["preempted"] is True
    assert final["steps"] == [final["step"]] and final["step"] % 256 == 0
    assert [r["kind"] for r in lines].count("preempted") == 1


# ---------------------------------------------------------------- debug


def test_all_finite_find_check_and_inject():
    model = get_model("mlp", num_classes=10, in_features=8, hidden=(4,), device="cpu")
    assert bool(debug.all_finite(model)) and bool(debug.all_finite({"a": [torch.ones(3)]}))
    debug.check_state(model, step=7)
    assert debug.inject_nan(model, "logits.weight") is model
    assert not bool(debug.all_finite(model))
    assert debug.find_nonfinite(model) == ["logits.weight"]
    with pytest.raises(debug.TrainingDiverged) as e:
        debug.check_state(model, step=7)
    assert e.value.step == 7 and e.value.bad_leaves == ["logits.weight"]
    with pytest.raises(KeyError):
        debug.inject_nan(model, "nope")
    assert not bool(debug.all_finite([torch.tensor([1.0, float("inf")])]))
    assert bool(debug.all_finite([torch.arange(3), torch.zeros(0)]))  # no float to check


# ---------------------------------------------------------------- profiling


def test_step_timer_and_profile_fn():
    x = torch.arange(1024.0)
    stats = profile_fn(lambda t: (t * t).sum(), x, iters=5, warmup=1)
    assert stats["steps"] == 5 and 0 < stats["mean_s"] < 5.0
    assert stats["p90_s"] >= stats["p50_s"] >= 0
    timer = StepTimer(warmup=2)
    for _ in range(6):
        with timer.step() as t:
            t.set_fence((x * x).sum())
    s = timer.summary(items_per_step=128)
    assert len(timer.times) == 4 and s["steps"] == 6 and s["items_per_sec"] > 0
    assert s["max_s"] >= s["p90_s"] >= s["p50_s"] > 0
    for warmup, n_steps in ((2, 1), (1, 1), (5, 0)):
        timer = StepTimer(warmup=warmup)
        for _ in range(n_steps):
            with timer.step():
                pass
        s = timer.summary(items_per_step=8)
        assert s["steps"] == n_steps and s["mean_s"] is None and s["items_per_sec"] is None
        json.dumps(s, allow_nan=False)
    assert "items_per_sec" not in StepTimer(warmup=3).summary()


def test_trace_session_stop_is_idempotent_and_writes_a_chrome_trace(tmp_path):
    sess = TraceSession(str(tmp_path / "never"))
    sess.stop()
    assert not sess.active and not os.path.exists(tmp_path / "never")
    sess = TraceSession(str(tmp_path / "t"))
    sess.start()
    assert sess.active
    (torch.arange(64.0) * 2).sum()
    sess.stop()
    sess.stop()
    assert not sess.active
    trace = json.loads((tmp_path / "t" / "trace.json").read_text())
    assert trace["traceEvents"]


def test_profile_dir_captures_the_fit_after_the_first_epoch(tmp_path):
    t = Trainer(_cfg(epochs=2, profile_dir=str(tmp_path / "prof")), device="cpu")
    t.fit()
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("addmm" in n or "linear" in n for n in names)


def test_cli_profile_and_resume_flags(tmp_path):
    cfg = build_config(["--profile", str(tmp_path / "p"), "--resume"])
    assert cfg.profile_dir == str(tmp_path / "p") and cfg.resume is True
    assert build_config(["--set", f"profile_dir={tmp_path / 'q'}"]).profile_dir == str(
        tmp_path / "q")
