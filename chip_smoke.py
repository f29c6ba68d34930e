#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and hold its kernels to account.

Run from the repository root, with one GPU visible::

    python3 chip_smoke.py

It imports only the port (``distributed_tensorflow_ibm_mnist_tpu_torch``),
never JAX or the JAX package.  Phases, one JSON line each:

1. device — the card, its ``nvidia-smi`` name and power limit, and the
   seconds to build every CUDA source of the port with nvcc (one nvcc per
   source, all started together);
2. kernels — the flash-attention forward (K3) against its plain PyTorch
   version on the card, at the serving path's shapes and the edge cases,
   with the stated tolerances; at the path's shapes the kernel, the plain
   version and one PyTorch library call are timed with CUDA events;
3. serving — the full-width flash-prefill LM (causal_lm, vocab 256, dim
   512, depth 4, 8 heads, bf16, seeded random weights) serves 16 requests
   through ``InferenceEngine``; every request must finish with its whole
   budget, the flash kernel's launch count must equal depth x admissions
   (the path ran through the kernel), and the prefill logits must agree
   with the same weights under plain attention; then the same run once
   more under ``torch.profiler`` (device time by kernel, busy share);
4. xent kernels — the softmax cross-entropy forward (K1) and backward (K2)
   against their plain versions at the training path's shape and the edge
   cases, then timed at (128, 10) and (2048, 10) beside their bound and a
   PyTorch library call;
5. training — ``Trainer.fit()`` on the ``mnist_lenet_1chip`` preset with
   ``fused_xent=True`` (LeNet-5 at full width, batch 128, synthetic MNIST
   60k/10k, Adam 1e-3 with the cosine schedule, bf16, early stop at 0.99):
   the best test accuracy must reach 0.99, the loss stay finite, and K1
   and K2 must each launch once per step taken; then
   ``measure_throughput(epochs=2)`` and one epoch under ``torch.profiler``;
6. the ``kernels`` line: per kernel, its launches on its path's run
   (serving for K3, training for K1/K2), largest error, times and bound;
7. the last line: ``{"ok": true, "device": {...}}``.

Every launch counter is set to 0 just before a path is driven and read
just after; the launches made to compare or time a kernel are not counted.

Any failed check raises, so the exit code is nonzero and the last line is
never printed.  Without a CUDA card, or without the port beside this
script, it exits nonzero before printing any result.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

H100_BF16_FLOPS = 989e12   # dense bf16 tensor-core peak, H100 SXM data sheet
H100_F32_FLOPS = 67e12     # float32 outside the tensor cores, same sheet
H100_BYTES_PER_S = 3.35e12  # HBM3

SLICE_SEQS = (64, 128, 256, 512)  # the serving buckets the prefill runs at
DEPTH = 4
MODEL_KW = dict(num_classes=256, dim=512, depth=DEPTH, heads=8, attn="flash")


T0 = time.perf_counter()


def emit(record: dict) -> None:
    """One JSON line; ``t_s`` is the seconds since the script started."""
    print(json.dumps({**record, "t_s": round(time.perf_counter() - T0, 3)}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def reset_counts(fa, xent) -> None:
    """Zero every kernel's launch counter (just before a path is driven)."""
    fa.flash_attention_fwd.launches = 0
    xent.softmax_xent.fwd_launches = 0
    xent.softmax_xent.bwd_launches = 0


def read_counts(fa, xent) -> dict:
    return {"flash_fwd": fa.flash_attention_fwd.launches,
            "xent_fwd": xent.softmax_xent.fwd_launches,
            "xent_bwd": xent.softmax_xent.bwd_launches}


def bound(flops: float, nbytes: float, peak_flops: float) -> dict:
    """The least time for the work: the larger of its bytes over the HBM
    rate and its operations over the peak rate of their type."""
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def live_pairs(s: int, causal: bool, window: int) -> int:
    """(q, k) pairs the masks leave live in one (batch, head) row."""
    if not causal:
        return s * s
    if not window:
        return s * (s + 1) // 2
    return sum(min(q + 1, window) for q in range(s))


def gpu_ms(fn, torch, reps: int = 25, inner: int = 20, sleep: int = 2_000_000) -> float:
    """Median over ``reps`` of the mean device time of ``inner`` back-to-back
    calls, from CUDA events.  A sleep kernel of ``sleep`` cycles ahead of
    each batch keeps the host's enqueue off the clock, as long as enqueuing
    the batch takes less time than the sleep."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep)
        e0.record()
        for _ in range(inner):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / inner)
    return statistics.median(times)


def phase_device(torch, build) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    print(smi_line, flush=True)  # the card's name and power limit, raw
    t0 = time.perf_counter()
    libs = build.build_all()
    rec = {"phase": "device", "name": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(), "nvidia_smi": smi_line,
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "build_s": round(time.perf_counter() - t0, 3),
           "built": sorted(libs)}
    emit(rec)
    return rec


def phase_kernels(torch, fa) -> dict:
    """Flash forward (K3) against its plain version, then timed."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32

    def qkv(s, h=8, hkv=8, d=64, dtype=bf16):
        mk = lambda heads: torch.randn((1, s, heads, d), generator=gen,  # noqa: E731
                                       device="cuda").to(dtype)
        return mk(h), mk(hkv), mk(hkv)

    cases = [dict(s=s) for s in SLICE_SEQS] + [
        dict(s=1000),                 # padding masks: 1000 is no tile multiple
        dict(s=512, hkv=2),           # GQA
        dict(s=512, window=128),      # sliding window
        dict(s=512, causal=False),
        dict(s=512, dtype=f32),
        dict(s=512, d=128),
    ]
    max_err = 0.0
    for c in cases:
        s, causal, window = c["s"], c.get("causal", True), c.get("window", 0)
        dtype = c.get("dtype", bf16)
        q, k, v = qkv(s, hkv=c.get("hkv", 8), d=c.get("d", 64), dtype=dtype)
        out, lse = fa.flash_attention_fwd(q, k, v, causal, window)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_plain(q, k, v, causal, window)
        err = (out.float() - ref_out.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        # bf16: P enters PV rounded to bf16 (as on the TPU) while the plain
        # version keeps it f32, and both outputs round to bf16
        tol = 1e-4 if dtype == f32 else 2e-2
        rec = {"phase": "kernel_check", "kernel": "flash_fwd",
               "shape": [1, s, 8, c.get("d", 64)], "heads_kv": c.get("hkv", 8),
               "causal": causal, "window": window, "dtype": str(dtype),
               "max_abs_err": err, "lse_err": lse_err, "tol": tol,
               "lse_tol": 1e-3}
        emit(rec)
        check(bool(torch.isfinite(out.float()).all()), f"non-finite output {rec}")
        check(err <= tol and lse_err <= 1e-3, f"kernel disagrees: {rec}")
        max_err = max(max_err, err)

    timed = []
    for s in SLICE_SEQS:
        q, k, v = qkv(s)
        out, lse = fa.flash_attention_fwd(q, k, v, True)
        ms = gpu_ms(lambda: fa.flash_attention_fwd(q, k, v, True), torch)
        plain_ms = gpu_ms(lambda: fa.flash_attention_plain(q, k, v, True), torch)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = gpu_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True), torch)
        flops = 4 * q.shape[3] * q.shape[2] * live_pairs(s, True, 0)
        nbytes = sum(x.numel() * x.element_size() for x in (q, k, v, out, lse))
        rec = {"phase": "kernel_time", "kernel": "flash_fwd", "shape": [1, s, 8, 64],
               "causal": True, "dtype": "bf16", "ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms, **bound(flops, nbytes, H100_BF16_FLOPS)}
        emit(rec)
        timed.append(rec)
    return {"max_abs_err": max_err, "timed": timed}


def phase_serving(torch, fa, xent, port) -> dict:
    get_model, InferenceEngine, make_prefill, make_generator = port
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = get_model("causal_lm", dtype=torch.bfloat16, generator=gen, **MODEL_KW)
    rng = torch.Generator().manual_seed(1)
    lens = torch.randint(16, 513, (16,), generator=rng).tolist()
    prompts = [torch.randint(1, 256, (n,), generator=rng).tolist() for n in lens]

    def serve(reqs):
        eng = InferenceEngine(model, slots=8, max_len=1024,
                              buckets=(64, 128, 256, 512))
        for p in reqs:
            eng.submit(p, max_new=32)
        t0 = time.perf_counter()
        done = eng.run()
        torch.cuda.synchronize()
        return eng, done, time.perf_counter() - t0

    serve([p[:b] for p, b in zip(prompts, SLICE_SEQS)])  # warm-up: one per bucket
    reset_counts(fa, xent)
    eng, done, wall = serve(prompts)
    launches = read_counts(fa, xent)["flash_fwd"]
    admissions = sum(r.admit_t is not None for r in done)
    check(len(done) == 16 and all(r.status == "done" and len(r.generated) == 32
                                  for r in done),
          f"not every request finished with 32 tokens: "
          f"{[(r.status, len(r.generated)) for r in done]}")
    check(launches == DEPTH * admissions,
          f"flash kernel launched {launches} times, expected depth x "
          f"admissions = {DEPTH * admissions}")

    # the same weights with plain attention: prefill logits and greedy tokens
    vanilla = get_model("causal_lm", dtype=torch.bfloat16, generator=gen,
                        **{**MODEL_KW, "attn": "vanilla"})
    vanilla.load_state_dict(model.state_dict())
    logit_err, agree, total = 0.0, 0, 0
    for p in (prompts[0], prompts[1]):
        x = torch.tensor([p], device="cuda")
        _, a = make_prefill(model, 1024)(x)
        _, b = make_prefill(vanilla, 1024)(x)
        logit_err = max(logit_err, (a - b).abs().max().item())
        ta = make_generator(model, 1024, 32)(x)[0, len(p):]
        tb = make_generator(vanilla, 1024, 32)(x)[0, len(p):]
        agree += int((ta == tb).sum())
        total += ta.numel()
    check(logit_err <= 5e-2, f"flash vs vanilla prefill logits differ by {logit_err}")

    s = eng.stats.summary()
    decode_tokens = s["tokens_generated"] - admissions
    rec = {"phase": "serving", "model": MODEL_KW, "dtype": "bf16", "slots": 8,
           "max_len": 1024, "buckets": [64, 128, 256, 512], "requests": 16,
           "prompt_lens": lens, "max_new": 32, "wall_s": round(wall, 4),
           "ttft_s_p50": s["ttft_s_p50"], "ttft_s_p99": s["ttft_s_p99"],
           "latency_s_p50": s["latency_s_p50"], "tokens_per_sec": s["tokens_per_sec"],
           "prefill_s": s["prefill_s"], "decode_s": s["decode_s"],
           "prefill_share": round(s["prefill_s"] / (s["prefill_s"] + s["decode_s"]), 4),
           "decode_steps": s["decode_steps"],
           "decode_tokens_per_s": round(decode_tokens / s["decode_s"], 3),
           "slot_occupancy": s["slot_occupancy"], "admissions": admissions,
           "flash_launches": launches, "prefill_logit_err_vs_vanilla": logit_err,
           "greedy_token_agreement_vs_vanilla": round(agree / total, 4),
           "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 1e9, 3)}
    emit(rec)
    emit(profile_run(torch, lambda: serve(prompts)[2], "serving",
                     {"flash_fwd_device_s": "flash_fwd"}))
    return rec


XENT_SHAPE = (128, 10)   # the training path's: batch 128, 10 classes
XENT_TIMED = ((128, 10), (2048, 10))


def xent_cost(n: int, c: int, itemsize: int, backward: bool) -> tuple[float, float]:
    """(operations, bytes) one call needs: each input read once and each
    output written once; per logit 4 operations forward (max, subtract,
    exp, add), 8 backward (the same, then subtract, exp, scale, one-hot
    subtract)."""
    if backward:  # logits, labels, g in; dx out
        return 8.0 * n * c, n * c * itemsize + 4 * n + 4 * n + n * c * itemsize
    return 4.0 * n * c, n * c * itemsize + 4 * n + 4 * n  # logits, labels in; loss out


def phase_xent_kernels(torch, xent) -> dict:
    """K1 and K2 against their plain twins, then timed."""
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(3)
    f32, bf16 = torch.float32, torch.bfloat16

    def inputs(n, c, dtype=f32):
        x = (torch.randn((n, c), generator=gen, device="cuda") * 3.0).to(dtype)
        y = torch.randint(0, c, (n,), generator=gen, device="cuda", dtype=torch.int32)
        return x, y

    extreme = torch.tensor([[1e4, -1e4, 0.0, 5.0]] * 8, device="cuda")
    cases = [dict(shape=XENT_SHAPE), dict(shape=(37, 10)), dict(shape=(100, 257)),
             dict(shape=(8, 128)), dict(shape=XENT_SHAPE, dtype=bf16),
             dict(shape=(8, 4), x=extreme,
                  y=torch.zeros(8, dtype=torch.int32, device="cuda"), what="extreme"),
             dict(shape=(4, 10), what="label out of range",
                  y=torch.tensor([-1, 10, 300, 3], dtype=torch.int32, device="cuda"))]
    errs = {"xent_fwd": 0.0, "xent_bwd": 0.0}
    for case in cases:
        n, c = case["shape"]
        dtype = case.get("dtype", f32)
        x, y = inputs(n, c, dtype)
        x, y = case.get("x", x), case.get("y", y)
        g = torch.rand((n,), generator=gen, device="cuda")
        loss = xent.softmax_xent(x, y)
        dx = xent.softmax_xent_bwd(x, y, g)
        xr = x.detach().clone().requires_grad_()  # K2 through autograd: stride-0 g
        xent.softmax_xent(xr, y).mean().backward()
        torch.cuda.synchronize()
        err_f = (loss - xent.softmax_xent_plain(x, y)).abs().max().item()
        err_b = max(
            (dx.float() - xent.softmax_xent_grad_plain(x, y, g).float()).abs().max().item(),
            (xr.grad.float() - xent.softmax_xent_grad_plain(
                x, y, torch.full((n,), 1.0 / n, device="cuda")).float()).abs().max().item())
        tol = 1e-5 if dtype == f32 else 2e-2
        rec = {"phase": "kernel_check", "kernel": "xent_fwd+xent_bwd", "shape": [n, c],
               "dtype": str(dtype), "case": case.get("what", "random"),
               "fwd_err": err_f, "bwd_err": err_b, "tol": tol,
               "dx_dtype": str(dx.dtype)}
        emit(rec)
        check(bool(torch.isfinite(loss).all()) and bool(torch.isfinite(dx.float()).all()),
              f"non-finite xent output {rec}")
        check(err_f <= tol and err_b <= tol and dx.dtype == dtype,
              f"xent kernel disagrees: {rec}")
        errs["xent_fwd"] = max(errs["xent_fwd"], err_f)
        errs["xent_bwd"] = max(errs["xent_bwd"], err_b)

    timed = {"xent_fwd": [], "xent_bwd": []}
    for n, c in XENT_TIMED:
        x, y = inputs(n, c)
        y64 = y.long()
        g = torch.rand((n,), generator=gen, device="cuda")
        xr = x.clone().requires_grad_()
        lib_loss = F.cross_entropy(xr, y64, reduction="none")  # graph kept for K2's yardstick
        runs = {
            "xent_fwd": (lambda: xent.softmax_xent(x, y),
                         lambda: xent.softmax_xent_plain(x, y),
                         lambda: F.cross_entropy(x, y64, reduction="none"),
                         "F.cross_entropy(reduction='none')"),
            "xent_bwd": (lambda: xent.softmax_xent_bwd(x, y, g),
                         lambda: xent.softmax_xent_grad_plain(x, y, g),
                         lambda: torch.autograd.grad(lib_loss, xr, g, retain_graph=True),
                         "torch.autograd.grad through F.cross_entropy's graph "
                         "(its backward alone, retain_graph=True)"),
        }
        for name, (kernel, plain, library, library_call) in runs.items():
            flops, nbytes = xent_cost(n, c, x.element_size(), name == "xent_bwd")
            # these calls take longer to enqueue than to run: a 20M-cycle
            # sleep (~10 ms) keeps the host off the clock
            ms = {k: gpu_ms(f, torch, sleep=20_000_000)
                  for k, f in (("ms", kernel), ("plain_ms", plain), ("library_ms", library))}
            rec = {"phase": "kernel_time", "kernel": name, "shape": [n, c], "dtype": "f32",
                   **ms, "library_call": library_call,
                   **bound(flops, nbytes, H100_F32_FLOPS)}
            emit(rec)
            timed[name].append(rec)
    return {"max_abs_err": errs, "timed": timed}


def phase_training(torch, fa, xent, port) -> dict:
    """LeNet-5 on synthetic MNIST through Trainer.fit() with the fused
    cross-entropy kernels, then its throughput and a profiled epoch."""
    Trainer, get_preset = port
    cfg = get_preset("mnist_lenet_1chip").replace(
        fused_xent=True, synthetic=True, quiet=True)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device="cuda")
    setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa, xent)
    summary = trainer.fit()
    counts = read_counts(fa, xent)
    steps = trainer.state.step
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [r[k] for r in trainer.history for k in ("train_loss", "test_loss") if k in r]
    rec = {"phase": "training", "preset": cfg.name, "model": cfg.model,
           "fused_xent": True, "batch_size": cfg.batch_size,
           "synthetic": trainer.data_synthetic,
           "n_train": int(trainer.train_images.shape[0]),
           "n_test": int(trainer.test_images.shape[0]),
           "optimizer": cfg.optimizer, "lr": cfg.lr, "schedule": cfg.schedule,
           "setup_s": round(setup_s, 3), "steps": steps,
           "epochs_run": summary["epochs_run"],
           "best_test_accuracy": summary["best_test_accuracy"],
           "time_to_target_s": summary["time_to_target_s"],
           "total_time_s": summary["total_time_s"],
           "images_per_sec_per_chip": summary["images_per_sec_per_chip"],
           "mfu": summary["mfu"],
           "model_tflops_per_sec_per_chip": summary["model_tflops_per_sec_per_chip"],
           "compile_overhead_s": summary["compile_overhead_s"],
           "epoch_times_s": [r["epoch_time_s"] for r in trainer.history],
           "train_loss_last": trainer.history[-1]["train_loss"],
           "peak_mem_gb": round(peak_gb, 3), "launches": counts}
    emit(rec)
    check(all(math.isfinite(v) for v in losses), f"non-finite loss: {losses}")
    check(summary["best_test_accuracy"] >= 0.99,
          f"LeNet-5 reached {summary['best_test_accuracy']}, not 0.99")
    check(counts["xent_fwd"] == counts["xent_bwd"] == steps,
          f"xent launches {counts} != steps taken {steps}: the path skipped a kernel")

    tp = trainer.measure_throughput(epochs=2)
    # fit() stopped after its first interval, so its own overhead figure is
    # 0 by definition; against the steady epoch time measured here instead:
    steady_epoch_s = trainer.steps_per_epoch * cfg.batch_size / tp["images_per_sec"]
    tp["first_epoch_overhead_s"] = round(rec["epoch_times_s"][0] - steady_epoch_s, 4)
    emit({"phase": "throughput", **tp})

    def one_epoch():
        t = time.perf_counter()
        trainer._epoch(12345)["loss"][-1].item()  # one epoch, to its fence
        return time.perf_counter() - t

    emit(profile_run(torch, one_epoch, "training epoch",
                     {"xent_fwd_device_s": "xent_fwd", "xent_bwd_device_s": "xent_bwd"}))
    trainer.close()
    return {**rec, "throughput": tp}


def profile_run(torch, run, of: str, focus: dict) -> dict:
    """One more run under torch.profiler: device time by kernel and the
    device's busy share of the wall time (the profiler's own overhead
    inflates the wall, so the share is a lower bound).  ``run`` returns its
    wall seconds; ``focus`` maps an output key to a kernel-name substring
    whose device time is summed."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = run()
    kernels, ops = [], []  # device events; host ops by the device time they caused
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            on_device = str(getattr(e, "device_type", "")).endswith("CUDA")
            (kernels if on_device else ops).append((us, e.key, e.count))
    kernels.sort(reverse=True)
    ops.sort(reverse=True)
    busy_s = sum(us for us, _, _ in kernels) / 1e6
    focused = {k: sum(us for us, key, _ in kernels if sub in key) / 1e6
               for k, sub in focus.items()}

    def top(rows):
        return [{"name": key[:80], "ms": round(us / 1e3, 4), "count": n}
                for us, key, n in rows[:8]]

    return {"phase": "profile", "of": of, "wall_s": round(wall, 4),
            "kernel_launches": sum(n for _, _, n in kernels),
            "device_busy_s": round(busy_s, 6) if kernels else None,
            "device_busy_share": round(busy_s / wall, 4) if kernels else None,
            **{k: round(v, 6) if kernels else None for k, v in focused.items()},
            "top_kernels": top(kernels), "top_ops": top(ops)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        from distributed_tensorflow_ibm_mnist_tpu_torch.core.generate import (
            make_generator,
            make_prefill,
        )
        from distributed_tensorflow_ibm_mnist_tpu_torch.core.trainer import Trainer
        from distributed_tensorflow_ibm_mnist_tpu_torch.models import get_model
        from distributed_tensorflow_ibm_mnist_tpu_torch.ops import _build
        from distributed_tensorflow_ibm_mnist_tpu_torch.ops import flash_attention as fa
        from distributed_tensorflow_ibm_mnist_tpu_torch.ops import xent
        from distributed_tensorflow_ibm_mnist_tpu_torch.serving import InferenceEngine
        from distributed_tensorflow_ibm_mnist_tpu_torch.utils.config import get_preset
    except ImportError as e:
        print(f"chip_smoke: the PyTorch port is not beside this script: {e}",
              file=sys.stderr)
        return 2

    dev = phase_device(torch, _build)
    k3 = phase_kernels(torch, fa)
    serving = phase_serving(
        torch, fa, xent, (get_model, InferenceEngine, make_prefill, make_generator))
    xk = phase_xent_kernels(torch, xent)
    training = phase_training(torch, fa, xent, (Trainer, get_preset))

    def entry(name, source, replaces, launches, max_err, timed, by):
        head = timed[0] if by == "by_shape" else timed[-1]  # the path's shape
        return {"name": name, "route": "cuda",
                "source": f"distributed_tensorflow_ibm_mnist_tpu_torch/csrc/{source}",
                "replaces": f"distributed_tensorflow_ibm_mnist_tpu/{replaces}",
                "launches": launches, "max_abs_err": max_err, "max_err": max_err,
                "ms": head["ms"], "kernel_ms": head["ms"], "plain_ms": head["plain_ms"],
                "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                "library_ms": head["library_ms"], "shape": head["shape"],
                by: [{k: r[k] for k in ("shape", "ms", "plain_ms", "library_ms",
                                        "bound_ms", "bound_by")} for r in timed]}

    counts = training["launches"]
    print(json.dumps({"kernels": [
        # K3 at S=512, the largest serving bucket; launches on the serving run
        entry("flash_fwd", "flash_fwd.cu", "ops/flash_attention.py:208",
              serving["flash_launches"], k3["max_abs_err"], k3["timed"], "by_seq"),
        # K1/K2 at (128, 10), the training step's; launches on the training run
        entry("xent_fwd", "xent.cu", "ops/xent.py:40", counts["xent_fwd"],
              xk["max_abs_err"]["xent_fwd"], xk["timed"]["xent_fwd"], "by_shape"),
        entry("xent_bwd", "xent.cu", "ops/xent.py:53", counts["xent_bwd"],
              xk["max_abs_err"]["xent_bwd"], xk["timed"]["xent_bwd"], "by_shape"),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                             "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
