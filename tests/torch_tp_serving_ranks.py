"""Rank bodies of the port's tensor-parallel serving tests: the engine at
``tp > 1`` (``serving/engine.py``'s leader and followers over a
``parallel/tensor_parallel.serving_mesh``) and the router over disjoint tp
groups.

Like ``torch_tp_ranks.py``, this module imports neither JAX nor the JAX
package: ``launch.torchrun.spawn`` imports it in every spawned rank, which
serves numpy weights the tests converted from JAX's and returns plain
results (streams, byte counts, scale blocks) for the tests to hold against
JAX's engines.  Every rank runs every job of its world in the same order
(each job's serving mesh is built on every rank: ``dist.new_group`` is a
collective over the world); a job's leader serves and returns its
streams, its followers ``follow()`` and return their summaries, and a rank
outside the job's mesh returns None.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from distributed_tensorflow_ibm_mnist_tpu_torch.models import get_model
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel import tensor_parallel as tpar
from distributed_tensorflow_ibm_mnist_tpu_torch.serving import (
    FIFOScheduler,
    InferenceEngine,
    Router,
    SamplingParams,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.serving import engine as engine_mod
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.chaos import (
    FaultInjector,
    FaultPlan,
    FaultSpec,
)
from torch_dp_ranks import forbidden_modules

MAX_LEN = 32


def _state(state_np: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in state_np.items()}


def _model(job: dict):
    return get_model("causal_lm", device="cpu", dtype=torch.float32, **job["model_kw"])


def _engine(job: dict, mesh, **extra) -> InferenceEngine:
    """The job's engine on this rank (the same arguments on every rank)."""
    ekw = dict(job.get("engine", {}))
    return InferenceEngine(
        _model(job), _state(job["state"]), slots=2, max_len=MAX_LEN, tp=mesh.model_size,
        tp_devices=mesh, device="cpu",
        scheduler=FIFOScheduler(max_len=MAX_LEN, buckets=(16,),
                                max_queue=len(job["prompts"])), **ekw, **extra)


def _submit(eng, job: dict) -> list:
    sampling = job.get("sampling")
    return [eng.submit(p, max_new=job.get("max_new", 6),
                       sampling=None if sampling is None else SamplingParams(**sampling[i]))
            for i, p in enumerate(job["prompts"])]


def _scales(eng) -> dict:
    """This rank's int8 blocks of block 0 (the column ``qkv`` / ``q_proj``
    and the row ``proj``) and their scales."""
    sd = eng.model.state_dict()
    return {k: v.numpy().copy() for k, v in sd.items()
            if k.startswith("blocks.0.") and (k.endswith(".scale") or k.endswith(".weight"))
            and any(m in k for m in ("qkv", "q_proj", "kv_proj", "proj"))}


def _stale_tokens(real):
    """A planted fault: a follower replays each window with the previous
    window's input tokens, never the tokens that window produced."""
    def window(self, tok, active, planes, pos, sampled, keep=True):
        prev = self._tok_dev if tok is None else torch.as_tensor(tok)
        out = real(self, tok, active, planes, pos, sampled, keep)
        if keep:
            self._tok_dev = prev
        return out
    return window


def _raise_at_second_window(real):
    """A planted fault: a follower whose second window raises."""
    seen = {"n": 0}

    def window(self, *a, **k):
        seen["n"] += 1
        if seen["n"] == 2:
            raise RuntimeError("follower window fault (planted)")
        return real(self, *a, **k)
    return window


def _logging(real, log: list):
    """Each window's tokens as this rank picked them, appended to ``log``."""
    def op(self, *a, **k):
        out = real(self, *a, **k)
        log.append(out[0].cpu().numpy())
        return out
    return op


@contextlib.contextmanager
def _patched(**ops):
    """``InferenceEngine``'s device calls ``_op_<name>`` replaced, each by
    ``wrap(real)``, for the block."""
    real = {name: getattr(InferenceEngine, f"_op_{name}") for name in ops}
    for name, wrap in ops.items():
        setattr(InferenceEngine, f"_op_{name}", wrap(real[name]))
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(InferenceEngine, f"_op_{name}", fn)


def serve(job: dict, mesh) -> dict:
    """One engine on the job's mesh: the leader prewarms (``prewarm``),
    serves the prompts, swaps (``swap``: a whole host state_dict) and serves
    again, and returns streams, bytes, stats, chaos counts and builds; a
    follower follows.  ``log``: every rank also returns each window's
    tokens as it picked them (``"windows"``)."""
    chaos = FaultInjector(FaultPlan(faults=())) if job.get("chaos") else None
    eng = _engine(job, mesh, **({"chaos": chaos} if chaos is not None else {}))
    base = {"kv_bytes": eng.kv_bytes_per_chip(), "weight_bytes": eng.weight_bytes_per_chip(),
            "scales": _scales(eng) if job.get("scales") else None}
    log: list = []
    ops = {"window": lambda real: _logging(real, log),
           "verify": lambda real: _logging(real, log)} if job.get("log") else {}
    if not eng.is_leader:
        fault = {"stale_tokens": _stale_tokens, "raise": _raise_at_second_window}.get(
            job.get("fault"))
        if fault is not None:
            ops["window"] = fault
        with _patched(**ops):
            return {**base, "follow": eng.follow(), "windows": log}
    with _patched(**ops):
        return {**_lead(job, eng, base, chaos), "windows": log}


def _lead(job: dict, eng, base: dict, chaos) -> dict:
    """The leader's part of :func:`serve`."""
    from distributed_tensorflow_ibm_mnist_tpu_torch.utils.tracing import CompileTracker

    out = dict(base)
    if job.get("prewarm"):
        out["prewarm"] = eng.prewarm()["programs"]
    tracker = CompileTracker.install()
    before = tracker.snapshot()
    reqs = _submit(eng, job)
    t0 = time.monotonic()
    try:
        eng.run()
    except Exception as e:  # a follower's fault, surfacing here
        out["error"] = f"{type(e).__name__}: {e}"
        out["error_s"] = time.monotonic() - t0
        eng.close()  # the queued requests too: cancelled, as engine faults
        out["statuses"] = [(r.status, r.engine_fault) for r in reqs]
        return out
    out["streams"] = [list(r.generated) for r in reqs]
    if job.get("swap") is not None:
        eng.swap_params(_state(job["swap"]))
        if job.get("scales"):
            out["swapped_scales"] = _scales(eng)
        reqs = _submit(eng, job)
        eng.run()
        out["swapped"] = [list(r.generated) for r in reqs]
    out["builds_after_prewarm"] = CompileTracker.delta(tracker.snapshot(),
                                                       before)["n_compiled_programs"]
    out["summary"] = {k: eng.stats.summary()[k] for k in (
        "tp", "kv_bytes_per_chip", "weight_bytes_per_chip", "quant", "prefix_hits",
        "radix_hits", "radix_hit_tokens", "n_prefill_chunks")}
    out["prefix_bytes"] = None if eng._prefix is None else eng._prefix.bytes
    if chaos is not None:
        out["chaos"] = (chaos.events("serving-admit"), chaos.events("serving-step"))
    eng.close()
    return out


def router(job: dict, meshes: list) -> dict:
    """Two replicas over disjoint tp groups (``job["groups"]``, model rank 0
    of each in this process): a transient ``serving-step`` fault at event 1
    kills one replica mid-wave; the wave finishes on the survivor.  The
    followers of replica ``i`` loop ``follow_engines`` until released.
    ``fault="raise"``: instead, replica 0's follower raises at its second
    window (its group's collective then times out on the leader); after
    the wave the leader restarts replica 0, which must refuse."""
    rank = torch.distributed.get_rank()
    follower_fault = job.get("fault") == "raise"
    inj = FaultInjector(FaultPlan(faults=() if follower_fault else (
        FaultSpec(site="serving-step", kind="transient", at=(1,)),)))

    def make_engine(tid, index):
        return _engine(job, meshes[index], trace_tid=tid, chaos=inj, stall_timeout_s=None)

    if rank != job["groups"][0][0]:
        for index, g in enumerate(job["groups"]):
            if rank not in g:
                continue
            follow = lambda index=index: engine_mod.follow_engines(  # noqa: E731
                lambda: make_engine(0, index), meshes[index])
            if not (follower_fault and index == 0):
                return {"follow": follow()}
            try:
                with _patched(window=_raise_at_second_window):
                    follow()
                return {"raised": None}
            except RuntimeError as e:
                return {"raised": str(e), "mesh_failed": bool(meshes[index].failed)}
        return None
    with Router(make_engine, len(meshes)) as r:
        rrs = [r.submit(p, max_new=job.get("max_new", 6)) for p in job["prompts"]]
        r.run_until_done()
        summ = r.summary()
        out = {"streams": [list(rr.generated) for rr in rrs],
               "statuses": [rr.status for rr in rrs], "failovers": r.failovers,
               "summary": {k: summ[k] for k in ("tp", "kv_bytes_cluster", "quant",
                                                 "kv_bytes_per_chip")}}
        if follower_fault:
            try:
                r.restart(0)
                out["restart"] = None
            except RuntimeError as e:
                out["restart"] = str(e)
            out["states"] = [rep.state for rep in r.replicas]
    for m in meshes:
        engine_mod.release_followers(m)
    return out


def from_trainer(job: dict) -> dict:
    """A tp=2 Trainer's fit served by ``InferenceEngine.from_trainer`` on
    the run's model group (a collective: every rank builds), against the
    run's own ``generate`` (whole weights, one device) on the same prompt."""
    from distributed_tensorflow_ibm_mnist_tpu_torch.core.trainer import Trainer
    from distributed_tensorflow_ibm_mnist_tpu_torch.utils.config import RunConfig

    with Trainer(RunConfig(**job["config"]), device="cpu") as trainer:
        trainer.fit()
        want = trainer.generate(np.asarray(job["prompt"]), max_new=6, max_len=MAX_LEN)
        eng = InferenceEngine.from_trainer(trainer, slots=2, max_len=MAX_LEN)
        out = {"tp": eng.tp, "heads_kv_a_rank": int(eng.cache["block_0"]["k"].shape[2]),
               "want": want[0, len(job["prompt"]):].tolist()}
        if not eng.is_leader:
            return {**out, "follow": eng.follow()}
        req = eng.submit(job["prompt"], max_new=6)
        eng.run()
        eng.close()
        return {**out, "stream": list(req.generated)}


def run(rank: int, world: int, jobs: dict) -> dict:
    """Every job of one world, in order (``serve``, ``router`` or
    ``from_trainer``)."""
    torch.set_num_threads(1)
    out: dict = {"forbidden": forbidden_modules(), "rank": rank}
    meshes: dict = {}

    def mesh_of(ranks, timeout_s=tpar.SERVING_TIMEOUT_S):
        key = (tuple(ranks), timeout_s)
        if key not in meshes:  # every rank builds it, member or not
            meshes[key] = tpar.serving_mesh(len(ranks), ranks, timeout_s=timeout_s)
        return meshes[key]

    for name, job in jobs.items():
        try:
            if job["kind"] == "router":
                ms = [mesh_of(g, job.get("timeout_s", tpar.SERVING_TIMEOUT_S))
                      for g in job["groups"]]
                out[name] = router(job, ms)
            elif job["kind"] == "from_trainer":
                out[name] = from_trainer(job)
            else:
                mesh = mesh_of(job["ranks"], job.get("timeout_s", tpar.SERVING_TIMEOUT_S))
                if mesh is None:
                    out[name] = None
                elif job.get("fault") == "raise" and not mesh.rank == 0:
                    try:
                        serve(job, mesh)
                        out[name] = {"raised": None}
                    except RuntimeError as e:
                        out[name] = {"raised": str(e)}
                else:
                    out[name] = serve(job, mesh)
        except Exception as e:
            raise RuntimeError(f"job {name!r} failed on rank {rank}") from e
    return out
