"""Process-group bootstrap of the port: one process per data-parallel rank.

The counterpart of the JAX package's ``launch/tpu_vm.py``.  JAX joins a
multi-host runtime once and then sees every device of the slice from one
program; PyTorch runs one process per rank, joined by
``torch.distributed``:

* :func:`bootstrap` joins a process group from explicit values or from
  what ``torchrun`` exports (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``MASTER_ADDR``, ``MASTER_PORT``), and skips the join when there is
  nothing to join.  The backend is NCCL on a card and gloo on the CPU; a
  caller may ask for gloo on a card (several ranks sharing one card, where
  NCCL refuses a second rank).  Each rank's card is ``cuda:{LOCAL_RANK}``
  unless the caller names one (``utils/device.rank_device``).
* :func:`spawn` starts ``world`` local ranks with the ``spawn`` start
  method over a ``file://`` store, runs ``fn(rank, *args)`` in each and
  returns what each returned.  A rank that raises fails the call with its
  traceback; a run that outlives ``timeout`` is killed and raises, so a
  rank stuck in a collective that another rank skipped cannot hang the
  caller.

Run a script under ``torchrun --nproc-per-node N`` and call
``bootstrap()``; the training CLI does (``launch/cli.py``).
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import time
import traceback
from pathlib import Path
from typing import Any, Callable

import torch
import torch.distributed as dist

from distributed_tensorflow_ibm_mnist_tpu_torch.utils.device import rank_device


def _summary(device: torch.device, backend: str | None) -> dict:
    joined = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if joined else 1
    return {"process_index": dist.get_rank() if joined else 0, "process_count": world,
            "local_devices": 1, "global_devices": world,
            "backend": dist.get_backend() if joined else backend, "device": str(device)}


def bootstrap(backend: str | None = None, init_method: str | None = None,
              world_size: int | None = None, rank: int | None = None,
              device: str | torch.device | None = None) -> dict:
    """Join (or skip, if single-process) a process group; return a summary
    dict for logging, with the JAX bootstrap's keys (``process_index``,
    ``process_count``, ``local_devices``, ``global_devices``) plus the
    backend and this rank's device.

    Unset arguments come from torchrun's environment.  The join happens
    when an ``init_method`` is given, when ``MASTER_ADDR`` and
    ``MASTER_PORT`` are set (``env://``), or when the world has more than
    one rank; a world of one with nothing to rendezvous with is skipped.
    ``device=None`` is ``cuda:{LOCAL_RANK}`` (raising without that card);
    ``backend=None`` is NCCL on a card and gloo on the CPU.  A second call
    in a process that has joined returns the summary and joins nothing."""
    env = os.environ
    dev = rank_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return _summary(dev, backend)
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if init_method is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        init_method = "env://"
    if init_method is None and (world_size or 1) == 1:
        return _summary(dev, None)
    if init_method is None:
        raise ValueError(
            f"world_size={world_size} needs a rendezvous: pass init_method "
            "(tcp://host:port or file://path) or set MASTER_ADDR and MASTER_PORT")
    if world_size is None or rank is None:
        raise ValueError(
            f"joining {init_method} needs world_size and rank (got {world_size}, "
            f"{rank}): pass them or set WORLD_SIZE and RANK")
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank)
    return _summary(dev, backend)


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _out_path(init_file: str, rank: int) -> Path:
    return Path(f"{init_file}.rank{rank}.out")


def _rank_main(fn: Callable, rank: int, world: int, backend: str,
               device: str | None, init_file: str, args: tuple) -> None:
    """Body of one spawned rank: join, run ``fn``, write ``("ok", result)``
    or ``("error", traceback)`` beside the store, leave."""
    os.environ["LOCAL_RANK"] = str(rank)
    try:
        bootstrap(backend, f"file://{init_file}", world, rank, device)
        out = ("ok", fn(rank, *args))
    except BaseException:  # reported to the parent, then the rank exits 1
        out = ("error", traceback.format_exc())
    _out_path(init_file, rank).write_bytes(pickle.dumps(out))
    if out[0] == "ok":
        shutdown()
    else:
        os._exit(1)  # leave without waiting on peers that may be stuck


def spawn(fn: Callable, world: int, backend: str, device: str | None,
          init_file: str | os.PathLike, args: tuple = (),
          timeout: float | None = 600.0) -> list[Any]:
    """Run ``fn(rank, *args)`` in ``world`` fresh local processes joined
    by ``backend`` over the ``file://`` store ``init_file`` (a path that
    must not exist yet); return the ranks' results, in rank order.

    ``fn``, ``args`` and the results cross processes by pickling, so ``fn``
    is a module-level function and its module is imported in each rank.
    ``device`` is each rank's device (``None``: ``cuda:{rank}``).  When a
    rank raises, the other ranks are killed and ``RuntimeError`` carries
    the rank's traceback; past ``timeout`` seconds (``None``: no limit)
    every rank is killed and ``TimeoutError`` raised."""
    init_file = str(init_file)
    if Path(init_file).exists():
        raise ValueError(f"the store {init_file} exists already: give each run a new path")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, backend, device, init_file, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + (float("inf") if timeout is None else timeout)
    timed_out = False
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            timed_out = time.monotonic() > deadline
            if timed_out:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
        Path(init_file).unlink(missing_ok=True)  # a killed run leaves its store
    results, errors = [], []
    for r in range(world):
        path = _out_path(init_file, r)
        if path.exists():
            status, value = pickle.loads(path.read_bytes())
            path.unlink()
            if status == "error":
                errors.append(f"rank {r}:\n{value}")
            results.append(value)
        else:
            errors.append(f"rank {r}: exit code {procs[r].exitcode}, no result")
    if errors:
        if timed_out:
            raise TimeoutError(f"spawned ranks ran past {timeout} s:\n" + "\n".join(errors))
        raise RuntimeError("a spawned rank failed:\n" + "\n".join(errors))
    return results
