"""Rank bodies of the port's context-parallel serving tests: the engine at
``cp > 1`` (a ``(cp, tp)`` ``parallel/tensor_parallel.serving_mesh``, the
paged pool split over its page axis, the ring prefill, the decode merge),
the three planted faults, and the disaggregated handoff across tp and cp.

Like ``torch_tp_serving_ranks.py``, this module imports neither JAX nor the
JAX package: ``launch.torchrun.spawn`` imports it in every spawned rank,
which serves numpy weights the tests converted from JAX's and returns plain
results (streams, byte counts, spans, page payloads).  Every rank runs every
job of its world in the same order and builds every job's meshes (a
collective over the world); a job's leader serves and returns its results,
its followers ``follow()``, and a rank outside the job returns None.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_tensorflow_ibm_mnist_tpu_torch.models import get_model
from distributed_tensorflow_ibm_mnist_tpu_torch.models import transformer
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel import tensor_parallel as tpar
from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.collectives import axis_index
from distributed_tensorflow_ibm_mnist_tpu_torch.serving import (
    FIFOScheduler,
    InferenceEngine,
    Router,
)
from distributed_tensorflow_ibm_mnist_tpu_torch.serving import engine as engine_mod
from distributed_tensorflow_ibm_mnist_tpu_torch.serving.kv_pool import make_paged_insert
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.chaos import FaultInjector, FaultPlan
from distributed_tensorflow_ibm_mnist_tpu_torch.utils.tracing import CompileTracker, Tracer
from torch_dp_ranks import forbidden_modules

MAX_LEN = 32
PAGE = 8


def _engine(job: dict, mesh, tp: int, cp: int, **extra) -> InferenceEngine:
    """The job's engine on this rank (the same arguments on every rank)."""
    ekw = {"kv_page_size": PAGE, **job.get("engine", {}), **extra}
    return InferenceEngine(
        get_model("causal_lm", device="cpu", dtype=torch.float32, **job["model_kw"]),
        {k: torch.from_numpy(np.array(v)) for k, v in job["state"].items()},
        slots=2, max_len=MAX_LEN, tp=tp, cp=cp, tp_devices=mesh, device="cpu",
        scheduler=FIFOScheduler(max_len=MAX_LEN, buckets=(16,),
                                max_queue=max(1, len(job.get("prompts", ())))), **ekw)


def _drop_rank1_partial(real):
    """A planted fault: the decode merge loses cp rank 1's partial (every
    rank weighs it at 0)."""
    def merge(out, lse, group):
        if axis_index(group) == 1:
            lse = torch.full_like(lse, -1e30)
        return real(out, lse, group)
    return merge


def _wrong_row_insert(eng: InferenceEngine):
    """An insert that writes each page of a prefilled row on the next cp
    row, not the one that holds it."""
    cp, n_local = eng.cp, eng._kv_pages // eng.cp
    return make_paged_insert(PAGE, MAX_LEN, shard=((eng._mesh.seq_index + 1) % cp, n_local))


def _wrong_page_rank(eng: InferenceEngine) -> None:
    """A planted fault: the insert writes each page of a prefilled row (K, V
    and any scales) on the next cp row."""
    eng._insert = _wrong_row_insert(eng)


def _wrong_scale_rank(eng: InferenceEngine) -> None:
    """A planted fault of the int8 cache: the insert writes K and V on the
    cp row that holds each page, and the scale pages on the next row."""
    right, wrong = eng._insert, _wrong_row_insert(eng)

    def leaves(cache, scales: bool) -> dict:  # the same tensors, written in place
        return {name: {k: v for k, v in entry.items()
                       if not k.startswith("pages_") or k.endswith("_scale") == scales}
                for name, entry in cache.items()}

    def insert(cache, row_cache, bt_row, slot):
        right(leaves(cache, False), row_cache, bt_row, slot)
        wrong(leaves(cache, True), row_cache, bt_row, slot)
        return cache

    eng._insert = insert


def serve(job: dict, mesh) -> dict:
    """One engine on the job's mesh: the leader prewarms (``prewarm``),
    serves the prompts and returns its streams, bytes, stats, chaos counts,
    ``ring_hop`` spans and builds after prewarm; a follower follows."""
    real_merge = transformer.merge_cp_partials
    if job.get("fault") == "drop_partial":
        transformer.merge_cp_partials = _drop_rank1_partial(real_merge)
    try:
        return _serve(job, mesh)
    finally:
        transformer.merge_cp_partials = real_merge


def _serve(job: dict, mesh) -> dict:
    chaos = FaultInjector(FaultPlan(faults=())) if job.get("chaos") else None
    tracer = Tracer() if job.get("trace") else None
    eng = _engine(job, mesh, job["tp"], job["cp"], chaos=chaos, tracer=tracer)
    if job.get("fault") == "wrong_page":
        _wrong_page_rank(eng)
    elif job.get("fault") == "wrong_scale_page":
        _wrong_scale_rank(eng)
    base = {"kv_bytes": eng.kv_bytes_per_chip(), "weight_bytes": eng.weight_bytes_per_chip(),
            "pool_pages": int(eng.cache["block_0"]["pages_k"].shape[0]),
            "grid": (mesh.seq_index, mesh.model_index, list(mesh.ranks))}
    if not eng.is_leader:
        return {**base, "follow": eng.follow()}
    out = dict(base)
    if job.get("prewarm"):
        sites, real = [], eng._compile.site
        eng._compile.site = lambda label: (sites.append(label), real(label))[1]
        try:
            eng.prewarm()
        finally:
            del eng._compile.site
        out["prewarm_sites"] = sorted(set(sites))
    tracker = CompileTracker.install()
    before = tracker.snapshot()
    reqs = [eng.submit(p, max_new=job.get("max_new", 6)) for p in job["prompts"]]
    eng.run()
    out["streams"] = [list(r.generated) for r in reqs]
    out["logprobs"] = [list(r.logprobs) for r in reqs]
    out["statuses"] = [r.status for r in reqs]
    out["builds_after_prewarm"] = CompileTracker.delta(tracker.snapshot(),
                                                       before)["n_compiled_programs"]
    summ = eng.stats.summary()
    out["summary"] = {k: summ[k] for k in ("tp", "cp", "kv_bytes_per_chip", "radix_hits",
                                           "n_prefill_chunks", "accept_rate")}
    if chaos is not None:
        out["chaos"] = (chaos.events("serving-admit"), chaos.events("serving-step"))
    if tracer is not None:
        out["hops"] = [(e["cat"], e["args"]) for e in tracer.events() if e["name"] == "ring_hop"]
    eng.close()
    return out


def packet(job: dict, mesh) -> dict:
    """A prefill-role engine on the job's mesh packages ``job["prompt"]``:
    the leader returns the packet's whole pages (``payloads``, the per-page
    trees) and its last logits."""
    eng = _engine(job, mesh, job["tp"], job["cp"], role="prefill")
    if not eng.is_leader:
        return {"follow": eng.follow()}
    eng.submit(job["prompt"], max_new=4)
    eng.step()
    (pk,) = list(eng._outbox)
    out = {"payloads": pk.payloads, "last_logits": pk.last_logits, "n_tok": pk.n_tok,
           "payload_bytes": pk.payload_bytes, "layout": [e[:2] + e[3:] for e in pk.layout]}
    eng.close()
    return out


def router(job: dict, meshes: list) -> dict:
    """A prefill replica on ``groups[0]`` hands every prompt off to a decode
    replica on ``groups[1]`` (each a ``(tp, cp)`` of ``shapes``; model rank
    0 of both in this process); the followers of replica ``i`` loop
    ``follow_engines`` until released."""
    rank = torch.distributed.get_rank()
    roles = ("prefill", "decode")

    def make_engine(tid, index):
        tp, cp = job["shapes"][index]
        return _engine(job, meshes[index], tp, cp, role=roles[index], trace_tid=tid)

    if rank != job["groups"][0][0]:
        for index, g in enumerate(job["groups"]):
            if rank in g:
                return {"follow": engine_mod.follow_engines(
                    lambda index=index: make_engine(0, index), meshes[index])}
        return None
    with Router(make_engine, 2, roles=list(roles)) as r:
        rrs = [r.submit(p, max_new=job.get("max_new", 6)) for p in job["prompts"]]
        r.run_until_done(max_steps=2000)
        out = {"streams": [list(rr.generated) for rr in rrs],
               "statuses": [rr.status for rr in rrs], "handoffs": r.handoffs,
               "failovers": r.failovers, "errors": [rr.error for rr in rrs]}
    for m in meshes:
        if m is not None and m.ranks[1:]:
            engine_mod.release_followers(m)
    return out


def on_mesh(job: dict) -> dict:
    """A Trainer on ``job["config"]`` holding the whole ``job["state"]`` (each
    rank its blocks, by the run's plan): ``generate(on_mesh=True)`` for each
    of ``job["calls"]``, then the default path for each; whether
    ``_decode_params`` ran or filled its cache during the on_mesh calls,
    each rank's K/V heads in the on_mesh cache, and whether the module's
    parameters are still the float32 masters (no decode copy was made)."""
    from distributed_tensorflow_ibm_mnist_tpu_torch.core import generate as gen_mod
    from distributed_tensorflow_ibm_mnist_tpu_torch.core.trainer import Trainer
    from distributed_tensorflow_ibm_mnist_tpu_torch.utils.config import RunConfig

    with Trainer(RunConfig(**job["config"]), device="cpu") as t:
        state = {k: torch.from_numpy(np.array(v)) for k, v in job["state"].items()}
        with torch.no_grad():
            if hasattr(t._plan, "load_whole_state_dict"):  # a TPPlan
                t._plan.load_whole_state_dict(t.model, state)
            else:  # a ShardPlan (fsdp, EP; over tp blocks under EP x tp)
                t._plan.load_whole(state)
        calls, heads = {"n": 0}, []
        real_params, real_sown = t._decode_params, gen_mod._cache_from_sown

        def spy_params():
            calls["n"] += 1
            return real_params()

        def spy_sown(kvs, *a, **k):
            cache = real_sown(kvs, *a, **k)
            heads.append(int(cache["block_0"]["k"].shape[2]))
            return cache

        t._decode_params, gen_mod._cache_from_sown = spy_params, spy_sown
        try:
            meshed = [t.generate(np.asarray(c["prompt"]), on_mesh=True, **c["kw"]).tolist()
                      for c in job["calls"]]
        finally:
            gen_mod._cache_from_sown = real_sown
        out = {"on_mesh": meshed, "decode_params_calls": calls["n"],
               "gen_params_empty": t._gen_params is None, "cache_heads": heads,
               "masters_float32": all(p.dtype == torch.float32 for p in t.model.parameters())}
        out["default"] = [t.generate(np.asarray(c["prompt"]), **c["kw"]).tolist()
                          for c in job["calls"]]
        return out


def on_mesh_refusals(job: dict) -> dict:
    """``generate(on_mesh=True)`` on runs that have no sharded layout to
    decode in, or sp or pp: each error's text."""
    from distributed_tensorflow_ibm_mnist_tpu_torch.core.trainer import Trainer
    from distributed_tensorflow_ibm_mnist_tpu_torch.utils.config import RunConfig

    out = {}
    for name, cfg in job["configs"].items():
        with Trainer(RunConfig(**cfg), device="cpu") as t:
            try:
                t.generate(np.asarray([[2, 9, 4, 7]]), max_new=2, on_mesh=True)
                out[name] = None
            except ValueError as e:
                out[name] = str(e)
    return out


def run(rank: int, world: int, jobs: dict) -> dict:
    """Every job of one world, in order (``serve``, ``packet``, ``router``,
    ``on_mesh`` or ``on_mesh_refusals``)."""
    torch.set_num_threads(1)
    out: dict = {"forbidden": forbidden_modules(), "rank": rank}
    meshes: dict = {}

    def mesh_of(ranks, tp, cp):
        key = (tuple(ranks), tp, cp)
        if key not in meshes:  # every rank builds it, member or not
            meshes[key] = tpar.serving_mesh(tp, ranks, cp=cp)
        return meshes[key]

    for name, job in jobs.items():
        try:
            if job["kind"] in ("on_mesh", "on_mesh_refusals"):
                out[name] = globals()[job["kind"]](job)
                continue
            if job["kind"] == "router":
                ms = [mesh_of(g, *shape) for g, shape in zip(job["groups"], job["shapes"])]
                out[name] = router(job, ms)
                continue
            mesh = mesh_of(job["ranks"], job["tp"], job["cp"])
            if mesh is None:
                out[name] = None
            else:
                out[name] = (packet if job["kind"] == "packet" else serve)(job, mesh)
        except Exception as e:
            raise RuntimeError(f"job {name!r} failed on rank {rank}") from e
    return out
