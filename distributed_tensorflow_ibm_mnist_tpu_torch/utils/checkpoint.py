"""Checkpoint/resume with integrity manifests (the port's counterpart of the
JAX package's ``utils/checkpoint.py``).

The format is the port's own, not orbax's: one directory per step,
``<dir>/<step>/``, holding ``model.pt`` (parameters and buffers by name),
``optimizer.pt`` (count and moments) and ``meta.pt`` (step, generator
states and whatever else the caller put in the state's save form), each
written with ``torch.save`` and read with ``torch.load(weights_only=True)``.
A JAX orbax checkpoint reaches the port only as the tree the JAX package's
``restore_state`` returns, through ``convert.load_train_state``.

The integrity manifest follows the JAX design: ``manifest_<step>.json``
beside the step directory, with each file's size and sha256 and a tree
digest over them, computed from the ON-DISK bytes after they are durable.
A step is written under a temporary name, each file fsynced, then renamed
into place (and the directory fsynced); only then is its manifest written
(atomically).  A torn write (a crash mid-save, injected or real) therefore
leaves no step, or a step whose bytes no longer match its manifest, or a
step without a manifest.  :meth:`CheckpointManager.restore_latest_intact`
walks newest -> oldest past such steps in the JAX order: (1) the manifest
must verify ("no manifest" is unknown, not condemned); (2) the step must
load; (3) the state must be all finite; (4) its step must equal the
directory's.

``save(wait=False)`` returns once the state is COPIED, not written: the
port's optimizer and BatchNorm update their tensors in place, so a writer
that read the live tensors would write a mix of two steps (and the
manifest would certify it).  The copy is a device clone in stream order
(a snapshot of exactly this step), then a copy into pinned host memory
on a side stream, which the writer thread awaits (an event) before it
writes; the step loop never waits for the disk.  :attr:`timings` records,
per save, the seconds it blocked its caller and the seconds until its
manifest landed.

Chaos sites (utils/chaos.py): ``checkpoint-write`` (``kind="torn"``: the
write lands, then its largest file is truncated and no manifest is
written; other kinds raise ``OSError`` before the write) and
``checkpoint-read`` (``OSError`` before a restore).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any

import torch

from distributed_tensorflow_ibm_mnist_tpu_torch.utils.debug import all_finite

_MANIFEST_FMT = "manifest_{step}.json"
_DIGEST_CHUNK = 1 << 20  # 1 MiB read chunks: bounded memory at any file size
_FILES = {"model.pt": ("params", "buffers"), "optimizer.pt": ("optimizer",)}
_META = "meta.pt"  # every other key of the save form


def _digest_step_dir(root: str) -> dict:
    """Per-file {relpath: {size, sha256}} plus a tree digest over them, from
    the on-disk bytes of one step directory (sorted order: deterministic)."""
    files: dict[str, dict] = {}
    tree = hashlib.sha256()
    for dirpath, dirnames, filenames in sorted(os.walk(root)):
        dirnames.sort()
        for name in sorted(filenames):
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, root)
            h = hashlib.sha256()
            size = 0
            with open(path, "rb") as f:
                while chunk := f.read(_DIGEST_CHUNK):
                    h.update(chunk)
                    size += len(chunk)
            files[rel] = {"size": size, "sha256": h.hexdigest()}
            tree.update(f"{rel}:{files[rel]['sha256']}\n".encode())
    return {"files": files, "tree_digest": tree.hexdigest()}


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _map_tensors(tree: Any, fn) -> Any:
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return tree


@torch.no_grad()
def snapshot_to_host(tree: Any) -> tuple[Any, Any]:
    """Copy every tensor of ``tree`` (a save form) to host memory without
    blocking the caller on the copy; returns ``(host_tree, done)``, where
    ``done()`` blocks until the host copies are complete.

    CUDA tensors are cloned on the current stream first (in stream order:
    the clone is exactly this step's value, whatever in-place update the
    caller queues next), then copied into pinned host buffers on a side
    stream that waits for the clones; ``done`` synchronizes that stream's
    event.  CPU tensors are cloned at once."""
    cuda = [t for t in _flat(tree) if t.is_cuda]
    if not cuda:
        return _map_tensors(tree, lambda t: t.detach().clone()), lambda: None
    clones: list[torch.Tensor] = []

    def clone(t):
        if not t.is_cuda:
            return t.detach().clone()
        c = t.detach().clone()
        clones.append(c)
        return c

    cloned = _map_tensors(tree, clone)
    side = torch.cuda.Stream(device=cuda[0].device)
    side.wait_stream(torch.cuda.current_stream(cuda[0].device))
    with torch.cuda.stream(side):
        host = _map_tensors(cloned, lambda t: _pinned_copy(t) if t.is_cuda else t)
        event = torch.cuda.Event()
        event.record(side)

    def done():
        event.synchronize()
        clones.clear()  # the device clones may be freed: the copies are complete

    return host, done


def _pinned_copy(t: torch.Tensor) -> torch.Tensor:
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


def _flat(tree: Any) -> list[torch.Tensor]:
    out: list[torch.Tensor] = []
    _map_tensors(tree, lambda t: out.append(t) or t)
    return out


def _save_form(state: Any) -> dict:
    return state if isinstance(state, dict) else state.state_dict()


class CheckpointManager:
    """Numbered step checkpoints under one directory (module docstring).

    ``max_to_keep`` newest steps survive each save; ``chaos`` is a
    ``utils.chaos.FaultInjector`` (or None)."""

    def __init__(self, directory: str, max_to_keep: int = 3, chaos=None):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self._max_to_keep = max_to_keep
        self._chaos = chaos
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        self.timings: list[dict] = []  # per save: step, blocked_s, landed_s
        self.skipped: list[tuple[int, str]] = []  # the last walk's demotions

    # ------------------------------------------------------------------
    # layout

    def _manifest_path(self, step: int) -> str:
        return os.path.join(self._dir, _MANIFEST_FMT.format(step=step))

    def _step_path(self, step: int) -> str:
        return os.path.join(self._dir, str(step))

    def all_steps(self) -> list[int]:
        """Steps on disk (landed: renamed into place), ascending."""
        return sorted(int(n) for n in os.listdir(self._dir)
                      if n.isdigit() and os.path.isdir(os.path.join(self._dir, n)))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def reload(self) -> None:
        """Re-read the step listing from disk: a no-op, since every listing
        reads the directory (kept for the JAX manager's interface)."""

    # ------------------------------------------------------------------
    # integrity

    def verify_step(self, step: int) -> tuple[bool, str]:
        """Integrity verdict for one on-disk step: ``(ok, reason)``.
        ``(False, "no manifest")`` is the UNKNOWN verdict (a crash before
        the manifest landed): :meth:`restore_latest_intact` still tries such
        a step, guarded by its validation."""
        root = self._step_path(step)
        if not os.path.isdir(root):
            return False, "missing step dir"
        mpath = self._manifest_path(step)
        if not os.path.exists(mpath):
            return False, "no manifest"
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except (OSError, json.JSONDecodeError):
            return False, "unreadable manifest"
        if _digest_step_dir(root)["files"] != manifest.get("files"):
            return False, "manifest mismatch"
        return True, "ok"

    def _write_manifest(self, step: int) -> None:
        manifest = {"step": step, **_digest_step_dir(self._step_path(step))}
        tmp = self._manifest_path(step) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._manifest_path(step))  # atomic: no torn manifests

    def _delete_step(self, step: int) -> None:
        shutil.rmtree(self._step_path(step), ignore_errors=True)
        try:
            os.remove(self._manifest_path(step))
        except OSError:
            pass

    def _tear_step(self, step: int) -> None:
        """Truncate the largest file of the step to half (chaos only)."""
        root = self._step_path(step)
        victim, vsize = None, -1
        for dirpath, _dirs, filenames in os.walk(root):
            for name in filenames:
                path = os.path.join(dirpath, name)
                if os.path.getsize(path) > vsize:
                    victim, vsize = path, os.path.getsize(path)
        if victim is not None:
            with open(victim, "r+b") as f:
                f.truncate(vsize // 2)

    # ------------------------------------------------------------------
    # save

    def _write_step(self, step: int, form: dict) -> None:
        """Write ``form`` as step ``step``: files under a temporary name,
        each fsynced, the directory renamed into place and fsynced."""
        tmp = os.path.join(self._dir, f".{step}.tmp-{os.getpid()}-{threading.get_ident()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        parts = {name: {k: form[k] for k in keys} for name, keys in _FILES.items()}
        parts[_META] = {k: v for k, v in form.items()
                        if not any(k in keys for keys in _FILES.values())}
        for name, part in parts.items():
            path = os.path.join(tmp, name)
            with open(path, "wb") as f:
                torch.save(part, f)
                f.flush()
                os.fsync(f.fileno())
        _fsync_dir(tmp)
        os.replace(tmp, self._step_path(step))
        _fsync_dir(self._dir)

    def _gc(self) -> None:
        steps = self.all_steps()
        for step in steps[:max(0, len(steps) - self._max_to_keep)]:
            self._delete_step(step)

    def _land(self, step: int, host: dict, done, t0: float, record: dict) -> None:
        try:
            done()
            self._write_step(step, host)
            self._write_manifest(step)
            self._gc()
            record["landed_s"] = time.perf_counter() - t0
        except Exception as e:  # surfaced at the next wait/save/close
            self._error = e

    def _raise_pending(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, state: Any, wait: bool = False) -> int:
        """Save ``state`` (a ``TrainState``, or its save form as a dict) at
        its step; returns the step number.

        Returns once the state is copied (module docstring); with
        ``wait=True`` once the step and its manifest are durable.  Saves
        run one at a time, in call order."""
        t0 = time.perf_counter()
        form = _save_form(state)
        step = int(form["step"])
        torn = False
        if self._chaos is not None:
            spec = self._chaos.fire("checkpoint-write")
            if spec is not None:
                if spec.kind != "torn":
                    raise OSError(f"chaos: injected {spec.kind!r} checkpoint-write fault")
                torn = True  # let the write land, then corrupt it below
        self.wait()  # one save in flight at a time; a same-step overwrite waits too
        if step in self.all_steps():
            self._delete_step(step)
        host, done = snapshot_to_host(form)
        record = {"step": step, "blocked_s": None, "landed_s": None}
        self.timings.append(record)
        if torn:
            # the crash-mid-write signature, deterministically: the bytes
            # land, no manifest ever does, and the largest file is torn
            done()
            self._write_step(step, host)
            self._tear_step(step)
            record["blocked_s"] = time.perf_counter() - t0
            return step
        self._thread = threading.Thread(
            target=self._land, args=(step, host, done, t0, record),
            name=f"checkpoint-{step}", daemon=True)
        self._thread.start()
        record["blocked_s"] = time.perf_counter() - t0
        if wait:
            self.wait()
        return step

    def wait(self) -> None:
        """Block until the save in flight (if any) and its manifest land;
        re-raise its error, if it failed."""
        thread = self._thread
        if thread is not None:
            thread.join()
            self._thread = None
        self._raise_pending()

    def close(self) -> None:
        self.wait()

    # ------------------------------------------------------------------
    # restore

    def _load(self, step: int) -> dict:
        root = self._step_path(step)
        form: dict = {}
        for name in (*_FILES, _META):
            form.update(torch.load(os.path.join(root, name), map_location="cpu",
                                   weights_only=True))
        return form

    def restore(self, target=None, step: int | None = None):
        """Load step ``step`` (default: the latest).  With ``target`` (a
        ``TrainState``) the state is loaded into it, strictly, and ``target``
        returned; without, the save form (CPU tensors) is returned."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {self._dir}")
        if self._chaos is not None:
            self._chaos.raise_if_fired("checkpoint-read", OSError)
        form = self._load(step)
        if target is None:
            return form
        target.load_state_dict(form)
        return target

    def restore_latest_intact(self, target=None):
        """Restore the newest step that is intact AND valid, walking back
        (module docstring); :attr:`skipped` lists each demoted step and its
        reason.  Raises ``FileNotFoundError`` with the reasons when no step
        survives."""
        self.wait()
        steps = sorted(self.all_steps(), reverse=True)
        if not steps:
            raise FileNotFoundError(f"no checkpoint found in {self._dir}")
        tried: list[tuple[int, str]] = []
        self.skipped = tried
        for step in steps:
            ok, reason = self.verify_step(step)
            if not ok and reason != "no manifest":
                tried.append((step, reason))
                continue
            try:
                form = self.restore(step=step)
            except Exception as e:  # torn bytes surface as load or IO errors
                tried.append((step, f"restore failed: {type(e).__name__}: {e}"))
                continue
            if not bool(all_finite(form)):
                tried.append((step, "restored state non-finite"))
                continue
            if int(form["step"]) != step:
                tried.append((step, f"step mismatch: dir {step} != state {int(form['step'])}"))
                continue
            if target is None:
                return form
            target.load_state_dict(form)
            return target
        raise FileNotFoundError(
            f"no intact checkpoint in {self._dir}: "
            + "; ".join(f"step {s}: {r}" for s, r in tried))


def save_state(directory: str, state: Any) -> int:
    """One-shot save (blocks until written and manifested)."""
    mgr = CheckpointManager(directory)
    step = mgr.save(state, wait=True)
    mgr.close()
    return step


def restore_state(directory: str, target=None, step: int | None = None):
    """One-shot restore into ``target`` (or the save form, without one)."""
    return CheckpointManager(directory).restore(target, step=step)
