#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and hold its kernels to account.

Run from the repository root, with one GPU visible::

    python3 chip_smoke.py

It imports only the port (``distributed_tensorflow_ibm_mnist_tpu_torch``),
never JAX or the JAX package.  Phases, one JSON line each:

1. device — the card, its ``nvidia-smi`` name and power limit, the
   seconds to build every CUDA source of the port with nvcc (one nvcc per
   source, all started together), the tensor-core instructions (``HMMA``,
   ``HGMMA``) in each library's machine code (``cuobjdump --dump-sass``;
   it fails if ``flash_fwd`` or ``flash_bwd`` has none) and the registers
   and spill bytes of every kernel instance from the ptxas log;
2. kernels — the flash-attention forward (K3) against its plain PyTorch
   version on the card, at the serving path's shapes and the edge cases
   (head_dim 32, 40 and 128 among them), with the stated tolerances; at
   the path's shapes the kernel, the plain version and one PyTorch
   library call are timed with CUDA events;
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
6. flash backward kernels — every entry of ``csrc/flash_bwd.cu`` against
   the plain backward on the card: K4 (fused) at (1, 8192, 8, 64) bf16
   causal; K5 (grouped) at (1, 8192, 4, 128) bf16 causal, the summed result
   and each group's float32 partials against the plain backward over that
   group's q rows; K6a (dkv) and K6b (dq) at the same shape; then each
   entry at the edge cases (S=1000, GQA with H_kv=2, window 128,
   non-causal, float32, D=128, D=40, D=32); then the public
   ``flash_attention_bwd``
   on each route (forced by its routing constants) at (1, 8192, 4, 128)
   and under GQA at (1, 2048, 8, 64) with H_kv=2, so the wrapper's own
   sums of grouped partials and per-kv-head dK/dV are held too.
   Tolerances are relative to the reference's largest magnitude;
7. flash timings at the LM training path's shapes — K4 at (8, 8192, 8,
   64), K5, K6a and K6b at (8, 8192, 4, 128), K3 at (8, 8192, 8, 64) —
   beside their bounds, the plain versions (at batch 1: batch 8 does not
   fit the plain version's float32 score matrices) and PyTorch's
   ``scaled_dot_product_attention`` (its backward alone, through
   ``torch.autograd.grad`` with ``retain_graph``, for the backward
   kernels);
8. lm_training — ``Trainer.fit()`` on the repo's long-context LM
   (``bench.py``'s ``bench_lm8k``: causal_lm, dim 512, depth 4, 8 heads,
   vocab 256, S=8192, bf16, ``attn="flash"``, retrieval 64/16, batch 8,
   Adam 1e-3, one epoch): the loss must stay finite, K3 must launch depth x
   (steps + eval batches) times, K4 depth x steps and no other backward
   kernel; then ``measure_throughput(epochs=1)`` and one profiled step;
9. lm_grad_check — the trained weights loaded into ``attn="vanilla"``: at
   B=1, S=8192 the loss and every parameter's gradient must agree with the
   flash model's within the stated relative tolerance;
10. lm_routes — two 2-step ``fit()`` runs of the head_dim-128 sibling (4
   heads): as it stands K5 launches depth x steps times; with
   ``_GROUPED_BWD=False`` K6a and K6b do;
11. the ``kernels`` line: per kernel, its design, its launches on its
   path's run (serving for K3, the LM runs for K4-K6, LeNet training for
   K1/K2), largest error, times and bound;
12. the last line: ``{"ok": true, "device": {...}}``.

Every launch counter is set to 0 just before a path is driven and read
just after; the launches made to compare or time a kernel are not counted.

Any failed check raises, so the exit code is nonzero and the last line is
never printed.  Without a CUDA card, or without the port beside this
script, it exits nonzero before printing any result.
"""

from __future__ import annotations

import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

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


BWD_COUNTERS = {"flash_bwd_fused": "fused_launches",
                "flash_bwd_grouped": "grouped_launches",
                "flash_bwd_dkv": "dkv_launches", "flash_bwd_dq": "dq_launches"}


def reset_counts(fa, xent) -> None:
    """Zero every kernel's launch counter (just before a path is driven)."""
    fa.flash_attention_fwd.launches = 0
    for attr in BWD_COUNTERS.values():
        setattr(fa.flash_attention_bwd, attr, 0)
    xent.softmax_xent.fwd_launches = 0
    xent.softmax_xent.bwd_launches = 0


def read_counts(fa, xent) -> dict:
    return {"flash_fwd": fa.flash_attention_fwd.launches,
            **{k: getattr(fa.flash_attention_bwd, a) for k, a in BWD_COUNTERS.items()},
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


def sass_counts(cuobjdump: str, lib) -> dict:
    """Tensor-core instructions in a built library's machine code:
    ``HMMA`` (mma.sync) and ``HGMMA`` (wgmma)."""
    sass = subprocess.run([cuobjdump, "--dump-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    return {op: len(re.findall(rf"\b{op}\.", sass)) for op in ("HMMA", "HGMMA")}


def ptxas_report(log: str) -> list[dict]:
    """Registers and spill bytes of each kernel instance, from the
    ``-Xptxas -v`` log that the build keeps beside each library."""
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = {"kernel": m.group(1)}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    if shutil.which("c++filt"):  # demangled where the tool is present
        names = subprocess.run(["c++filt"], input="\n".join(r["kernel"] for r in rows),
                               capture_output=True, text=True).stdout.splitlines()
        for r, name in zip(rows, names):
            r["kernel"] = re.sub(r"\(anonymous namespace\)::|\(.*\)$", "", name)
    return rows


def phase_device(torch, build) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    print(smi_line, flush=True)  # the card's name and power limit, raw
    t0 = time.perf_counter()
    libs = build.build_all()
    build_s = time.perf_counter() - t0
    cuobjdump = str(Path(build.nvcc_path()).with_name("cuobjdump"))
    sass = {name: sass_counts(cuobjdump, lib) for name, lib in sorted(libs.items())}
    ptxas = {name: ptxas_report(lib.with_suffix(".log").read_text())
             for name, lib in sorted(libs.items())}
    rec = {"phase": "device", "name": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(), "nvidia_smi": smi_line,
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "build_s": round(build_s, 3), "built": sorted(libs),
           "tensor_core_instructions": sass, "ptxas": ptxas}
    emit(rec)
    for name in ("flash_fwd", "flash_bwd"):
        check(sass[name]["HMMA"] + sass[name]["HGMMA"] > 0,
              f"{name}: no HMMA/HGMMA instruction in its machine code: {sass[name]}")
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
        dict(s=512, d=40),            # a multiple of 8, not of 16: zero-padded
        dict(s=512, d=32),
        dict(s=1000, d=40, dtype=f32),
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
    # these calls take about as long to enqueue as to run: a 20M-cycle
    # sleep (~10 ms) keeps the host off the clock
    sleep = 20_000_000
    for s in SLICE_SEQS:
        q, k, v = qkv(s)
        out, lse = fa.flash_attention_fwd(q, k, v, True)
        ms = gpu_ms(lambda: fa.flash_attention_fwd(q, k, v, True), torch, sleep=sleep)
        plain_ms = gpu_ms(lambda: fa.flash_attention_plain(q, k, v, True), torch,
                          sleep=sleep)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = gpu_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True), torch, sleep=sleep)
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


# ---------------------------------------------------------------- causal LM

# bench.py:254-262, the LM the repo trains at full width ("bench_lm8k");
# Adam 1e-3 is RunConfig's default
LM_CFG = dict(name="bench_lm8k", model="causal_lm",
              model_kwargs={"dim": 512, "depth": DEPTH, "heads": 8, "attn": "flash"},
              dataset="retrieval", dataset_kwargs={"vocab": 256, "seq_len": 8192},
              n_train=64, n_test=16, batch_size=8, epochs=1, quiet=True,
              eval_batch_size=8)
# bench.py:277-282: its head_dim-128 sibling, cut to 2 steps and 1 eval batch
LM_D128_CFG = dict(LM_CFG, name="bench_lm8k_d128", n_train=16, n_test=8,
                   model_kwargs={"dim": 512, "depth": DEPTH, "heads": 4, "attn": "flash"})
LM_SEQ = 8192
# bf16: P and dS enter the products rounded to bf16 (as on the TPU) while
# the plain version keeps them float32, and the outputs round to bf16.
# float32: sums in another order, and K4/K5's dQ adds by atomics in an order
# that changes from run to run.  Both relative to the reference's largest
# magnitude.
BWD_TOL = {"torch.bfloat16": 2e-2, "torch.float32": 1e-4}


def bwd_inputs(torch, fa, gen, b, s, h, hkv, d, dtype, causal=True, window=0):
    """q, k, v, dO from ``gen``; lse from K3; delta = rowsum(dO * O)."""
    def mk(heads):
        return torch.randn((b, s, heads, d), generator=gen, device="cuda").to(dtype)
    q, k, v, g = mk(h), mk(hkv), mk(hkv), mk(h)
    with torch.no_grad():
        out, lse = fa.flash_attention_fwd(q, k, v, causal, window)
    delta = (g.float() * out.float()).sum(-1)
    return q, k, v, g, lse, delta


def per_kv(x, hkv):
    """Per-q-head (B, S, H, D) -> per-kv-head sums, float32."""
    b, s, h, d = x.shape
    return x.float().view(b, s, hkv, h // hkv, d).sum(3)


def compare(name, got: dict, ref: dict, dtype, extra: dict) -> tuple[float, float]:
    """Emit one check record; raise when an output disagrees.  Returns the
    largest absolute and relative errors."""
    tol = BWD_TOL[str(dtype)]
    errs = {}
    for key, a in got.items():
        r = ref[key]
        abs_err = (a.float() - r).abs().max().item()
        errs[key] = (abs_err, abs_err / max(r.abs().max().item(), 1e-30))
    finite = all(bool(a.float().isfinite().all()) for a in got.values())
    rec = {"phase": "kernel_check", "kernel": name, **extra, "dtype": str(dtype),
           "max_abs_err": {k: e[0] for k, e in errs.items()},
           "rel_err": {k: e[1] for k, e in errs.items()}, "rel_tol": tol}
    emit(rec)
    check(finite, f"non-finite {name} output {rec}")
    check(all(e[1] <= tol for e in errs.values()), f"{name} disagrees: {rec}")
    return max(e[0] for e in errs.values()), max(e[1] for e in errs.values())


def check_bwd_entries(torch, fa, gen, b, s, h, hkv, d, dtype, causal, window, which,
                      n_groups=4):
    """Run the named entries at one shape against the plain backward; returns
    {entry: (abs_err, rel_err)}."""
    args = bwd_inputs(torch, fa, gen, b, s, h, hkv, d, dtype, causal, window)
    q = args[0]
    ref = dict(zip(("dq", "dk", "dv"),
                   fa.flash_attention_bwd_plain(*args, causal, window)))
    extra = {"shape": [b, s, h, d], "heads_kv": hkv, "causal": causal, "window": window}
    out = {}
    for entry in which:
        if entry == "flash_bwd_fused":
            dq, dk, dv = fa._launch_fused(*args, causal, window, fa.Route("fused", 1, s))
            got = {"dq": dq, "dk": per_kv(dk, hkv), "dv": per_kv(dv, hkv)}
        elif entry == "flash_bwd_grouped":
            rows = -(-s // n_groups)
            route = fa.Route("grouped", n_groups, rows)
            dq, dk, dv = fa._launch_fused(*args, causal, window, route)
            torch.cuda.synchronize()
            got = {"dq": dq, "dk": per_kv(dk.sum(0), hkv), "dv": per_kv(dv.sum(0), hkv)}
            # each group's float32 partials against the plain backward over
            # that group's q rows
            for i in range(n_groups):
                _, pk, pv = fa.flash_attention_bwd_plain(
                    *args, causal, window, q_rows=(i * rows, (i + 1) * rows))
                compare(entry, {"dk": per_kv(dk[i], hkv), "dv": per_kv(dv[i], hkv)},
                        {"dk": pk, "dv": pv}, dtype,
                        {**extra, "group": i, "groups": n_groups,
                         "output": "float32 partials"})
        elif entry == "flash_bwd_dkv":
            dk, dv = fa._launch_dkv(*args, causal, window)
            got = {"dk": per_kv(dk, hkv), "dv": per_kv(dv, hkv)}
        else:
            got = {"dq": fa._launch_dq(*args, causal, window)}
        torch.cuda.synchronize()
        check("dq" not in got or got["dq"].dtype == q.dtype, f"{entry}: dq dtype")
        out[entry] = compare(entry, got, ref, dtype, extra)
    return out


BWD_ENTRIES = ("flash_bwd_fused", "flash_bwd_grouped", "flash_bwd_dkv", "flash_bwd_dq")

# routing constants that force each route
FORCE_ROUTE = {"fused": {"_FUSED_DQ_VMEM_BUDGET": 1 << 40},
               "grouped": {"_FUSED_DQ_VMEM_BUDGET": 0},
               "split": {"_FUSED_DQ_VMEM_BUDGET": 0, "_GROUPED_BWD": False}}
ROUTE_ENTRIES = {"fused": ("flash_bwd_fused",), "grouped": ("flash_bwd_grouped",),
                 "split": ("flash_bwd_dkv", "flash_bwd_dq")}


def check_public_routes(torch, fa, gen, b, s, h, hkv, d, dtype, group_budget=None):
    """The public ``flash_attention_bwd`` on each route, forced by its
    routing constants, against the plain backward: the wrapper's own sums
    (grouped partials, dK/dV per kv head) on the card.  ``group_budget``,
    when given, replaces ``_GROUPED_DQ_VMEM_BUDGET`` on the grouped route
    (0: one q tile per group).  Returns {entry: (abs_err, rel_err)}."""
    args = bwd_inputs(torch, fa, gen, b, s, h, hkv, d, dtype)
    ref = dict(zip(("dq", "dk", "dv"), fa.flash_attention_bwd_plain(*args, True)))
    out = {}
    for route, consts in FORCE_ROUTE.items():
        if route == "grouped" and group_budget is not None:
            consts = {**consts, "_GROUPED_DQ_VMEM_BUDGET": group_budget}
        saved = {name: getattr(fa, name) for name in consts}
        try:
            for name, value in consts.items():
                setattr(fa, name, value)
            picked = fa.bwd_route(s, d, dtype)
            before = {a: getattr(fa.flash_attention_bwd, a) for a in BWD_COUNTERS.values()}
            got = fa.flash_attention_bwd(*args, True)
            torch.cuda.synchronize()
        finally:
            for name, value in saved.items():
                setattr(fa, name, value)
        ran = {e for e, a in BWD_COUNTERS.items()
               if getattr(fa.flash_attention_bwd, a) != before[a]}
        check(picked.name == route and ran == set(ROUTE_ENTRIES[route]),
              f"forcing {route} at {(b, s, h, hkv, d)}: route {picked}, ran {sorted(ran)}")
        check(all(x.dtype == dtype for x in got), f"{route}: output dtypes")
        err = compare("flash_attention_bwd", dict(zip(("dq", "dk", "dv"), got)), ref, dtype,
                      {"shape": [b, s, h, d], "heads_kv": hkv, "causal": True, "window": 0,
                       "route": route, "groups": picked.groups})
        out.update({e: err for e in ROUTE_ENTRIES[route]})
    return out


def phase_flash_bwd_kernels(torch, fa) -> dict:
    """Every backward entry against the plain backward: at the LM path's
    shapes, then at the edge cases."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(5)
    bf16, f32 = torch.bfloat16, torch.float32
    check(fa.bwd_route(LM_SEQ, 64, bf16).name == "fused"
          and fa.bwd_route(LM_SEQ, 128, bf16) == fa.Route("grouped", 4, 2048),
          "the LM shapes do not take the JAX routes (fused at D=64, 4 groups at D=128)")
    errs = {e: (0.0, 0.0) for e in BWD_ENTRIES}

    def fold(found):
        for e, (a, r) in found.items():
            errs[e] = (max(errs[e][0], a), max(errs[e][1], r))

    fold(check_bwd_entries(torch, fa, gen, 1, LM_SEQ, 8, 8, 64, bf16, True, 0,
                           ["flash_bwd_fused"]))
    fold(check_bwd_entries(torch, fa, gen, 1, LM_SEQ, 4, 4, 128, bf16, True, 0,
                           ["flash_bwd_grouped", "flash_bwd_dkv", "flash_bwd_dq"]))
    edges = [dict(s=1000),                        # padding: 1000 is no tile multiple
             dict(s=1024, hkv=2),                 # GQA
             dict(s=1024, window=128),            # sliding window
             dict(s=1024, causal=False),
             dict(s=1024, dtype=f32),
             dict(s=1024, d=128),
             dict(s=1000, d=40),                  # a multiple of 8, not of 16
             dict(s=1024, d=32),
             dict(s=1000, d=40, dtype=f32)]
    for c in edges:
        fold(check_bwd_entries(torch, fa, gen, 1, c["s"], 8, c.get("hkv", 8),
                               c.get("d", 64), c.get("dtype", bf16), c.get("causal", True),
                               c.get("window", 0), BWD_ENTRIES))
    # the public wrapper on every route: at the head_dim-128 LM shape, and
    # under GQA, where it sums dK/dV per kv head (4 groups of one tile)
    fold(check_public_routes(torch, fa, gen, 1, LM_SEQ, 4, 4, 128, bf16))
    fold(check_public_routes(torch, fa, gen, 1, 2048, 8, 2, 64, bf16, group_budget=0))
    return errs


def attn_bytes(q, k, v, *extra) -> float:
    return float(sum(x.numel() * x.element_size() for x in (q, k, v, *extra)))


def phase_flash_time(torch, fa) -> dict:
    """K3-K6 at the LM training path's shapes, beside their bounds, their
    plain versions (batch 1) and SDPA."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(6)
    bf16 = torch.bfloat16
    timed = {}

    def sdpa_bwd(q, k, v, g):
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        gt = g.transpose(1, 2)
        return lambda: torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True)

    def record(name, shape, ms, plain_ms, library_ms, flops, nbytes, library_call,
               plain_note="plain version at batch 1"):
        rec = {"phase": "kernel_time", "kernel": name, "shape": shape, "dtype": "bf16",
               "causal": True, "ms": ms, "plain_ms": plain_ms, "plain_shape":
               [1, *shape[1:]], "plain_note": plain_note, "library_ms": library_ms,
               "library_call": library_call, **bound(flops, nbytes, H100_BF16_FLOPS)}
        emit(rec)
        timed[name] = rec

    slow = dict(reps=3, inner=2, sleep=0)
    for h, d, names in ((8, 64, ("flash_fwd", "flash_bwd_fused")),
                        (4, 128, ("flash_bwd_grouped", "flash_bwd_dkv", "flash_bwd_dq"))):
        b, s = 8, LM_SEQ
        q, k, v, g, lse, delta = bwd_inputs(torch, fa, gen, b, s, h, h, d, bf16)
        small = bwd_inputs(torch, fa, gen, 1, s, h, h, d, bf16)
        pairs = b * h * live_pairs(s, True, 0)
        stats = (lse, delta)
        plain_bwd = gpu_ms(lambda: fa.flash_attention_bwd_plain(*small, True), torch, **slow)
        library = gpu_ms(sdpa_bwd(q, k, v, g), torch, **slow)
        lib_call = ("torch.autograd.grad through F.scaled_dot_product_attention("
                    "is_causal=True), its backward alone (retain_graph=True): dq, dk, dv")
        route = fa.Route("grouped", 4, 2048) if d == 128 else fa.Route("fused", 1, s)
        args = (q, k, v, g, lse, delta, True, 0)
        for name in names:
            if name == "flash_fwd":
                qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
                out = torch.empty_like(q)
                record(name, [b, s, h, d],
                       gpu_ms(lambda: fa.flash_attention_fwd(q, k, v, True), torch, **slow),
                       gpu_ms(lambda: fa.flash_attention_plain(*small[:3], True), torch, **slow),
                       gpu_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
                              torch, **slow),
                       4.0 * d * pairs, attn_bytes(q, k, v, out, lse),
                       "F.scaled_dot_product_attention(is_causal=True)")
            elif name in ("flash_bwd_fused", "flash_bwd_grouped"):
                record(name, [b, s, h, d],
                       gpu_ms(lambda: fa._launch_fused(*args, route), torch, **slow),
                       plain_bwd, library, 5 * 2.0 * d * pairs,
                       attn_bytes(q, k, v, g, *stats, q, k, v), lib_call)
            elif name == "flash_bwd_dkv":  # S, dP, dV, dK: 4 products
                record(name, [b, s, h, d],
                       gpu_ms(lambda: fa._launch_dkv(*args), torch, **slow),
                       plain_bwd, library, 4 * 2.0 * d * pairs,
                       attn_bytes(q, k, v, g, *stats, k, v), lib_call,
                       "the whole plain backward (dq, dk, dv) at batch 1")
            else:  # S, dP, dQ: 3 products
                record(name, [b, s, h, d],
                       gpu_ms(lambda: fa._launch_dq(*args), torch, **slow),
                       plain_bwd, library, 3 * 2.0 * d * pairs,
                       attn_bytes(q, k, v, g, *stats, q), lib_call,
                       "the whole plain backward (dq, dk, dv) at batch 1")
        del q, k, v, g, lse, delta, small
        torch.cuda.empty_cache()
    return timed


def phase_lm_training(torch, fa, xent, port) -> dict:
    """bench_lm8k through Trainer.fit(), then its throughput and one
    profiled step."""
    Trainer, RunConfig = port
    cfg = RunConfig(**LM_CFG)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device="cuda")
    setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa, xent)
    summary = trainer.fit()
    counts = read_counts(fa, xent)
    steps = trainer.state.step
    eval_batches = -(-cfg.n_test // cfg.eval_batch_size)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rec = {"phase": "lm_training", "config": LM_CFG,
           "dtype": "bf16", "setup_s": round(setup_s, 3), "steps": steps,
           "eval_batches": eval_batches, "total_time_s": summary["total_time_s"],
           "epoch_time_s": trainer.history[0]["epoch_time_s"],
           "train_loss": trainer.history[0]["train_loss"],
           "test_loss": trainer.history[0]["test_loss"],
           "test_accuracy": trainer.history[0]["test_accuracy"],
           "tokens_per_sec_per_chip": summary["tokens_per_sec_per_chip"],
           "mfu": summary["mfu"],
           "model_tflops_per_sec_per_chip": summary["model_tflops_per_sec_per_chip"],
           "flops_per_sequence": trainer._flops_per_image,
           "peak_mem_gb": round(peak_gb, 3), "launches": counts}
    emit(rec)
    losses = [trainer.history[0]["train_loss"], trainer.history[0]["test_loss"]]
    check(all(math.isfinite(x) for x in losses), f"non-finite LM loss: {losses}")
    check(counts["flash_fwd"] == DEPTH * (steps + eval_batches),
          f"K3 launched {counts['flash_fwd']} times, expected depth x (steps + eval "
          f"batches) = {DEPTH * (steps + eval_batches)}")
    check(counts["flash_bwd_fused"] == DEPTH * steps,
          f"K4 launched {counts['flash_bwd_fused']} times, expected depth x steps = "
          f"{DEPTH * steps}")
    check(counts["flash_bwd_grouped"] == counts["flash_bwd_dkv"]
          == counts["flash_bwd_dq"] == 0, f"another backward kernel ran: {counts}")

    tp = trainer.measure_throughput(epochs=1)
    tp["s_per_step"] = cfg.batch_size / tp["images_per_sec"]
    emit({"phase": "lm_throughput", **tp})
    check(math.isfinite(tp["last_loss"]), f"non-finite throughput loss {tp}")

    def one_step():
        t = time.perf_counter()
        trainer._run_epoch(trainer.state, trainer.train_images[:cfg.batch_size],
                           trainer.train_labels[:cfg.batch_size])["loss"][-1].item()
        return time.perf_counter() - t

    emit(profile_run(torch, one_step, "lm training step",
                     {"flash_fwd_device_s": "flash_fwd", "flash_bwd_device_s": "flash_bwd"}))
    return {**rec, "throughput": tp, "trainer": trainer}


# measured on an H100: loss 6e-7, worst gradient 9e-3 (the embedding)
LM_GRAD_TOL = {"loss": 1e-3, "grad": 3e-2}


def phase_lm_grad_check(torch, trainer, get_model, steps_mod) -> dict:
    """The trained weights under attn="vanilla": loss and every gradient at
    B=1, S=8192 against the flash model's, relative to each reference's
    largest magnitude (bf16 model: the two attentions round at different
    places, and the difference crosses 4 blocks)."""
    flash = trainer.model
    kw = dict(num_classes=256, dim=512, depth=DEPTH, heads=8, dtype=torch.bfloat16)
    vanilla = get_model("causal_lm", attn="vanilla", device="cuda", **kw)
    vanilla.load_state_dict(flash.state_dict())
    batch = {"image": trainer.train_images[:1], "label": trainer.train_labels[:1]}
    out = {}
    for name, model in (("flash", flash), ("vanilla", vanilla)):
        loss, _ = steps_mod.make_loss_fn(model)(batch)
        params = dict(model.named_parameters())
        grads = torch.autograd.grad(loss, list(params.values()))
        out[name] = (loss.item(), dict(zip(params, grads)))
        torch.cuda.synchronize()
    loss_rel = abs(out["flash"][0] - out["vanilla"][0]) / abs(out["vanilla"][0])
    grad_rel = {}
    for key, gv in out["vanilla"][1].items():
        gf = out["flash"][1][key]
        grad_rel[key] = ((gf.float() - gv.float()).abs().max()
                         / gv.float().abs().max().clamp_min(1e-30)).item()
    worst = max(grad_rel, key=grad_rel.get)
    rec = {"phase": "lm_grad_check", "shape": [1, LM_SEQ], "loss_flash": out["flash"][0],
           "loss_vanilla": out["vanilla"][0], "loss_rel_err": loss_rel,
           "grad_rel_err_max": grad_rel[worst], "grad_rel_err_worst_param": worst,
           "grad_rel_err_median": statistics.median(grad_rel.values()),
           "params": len(grad_rel), "tol": LM_GRAD_TOL}
    emit(rec)
    check(all(math.isfinite(g) for g in grad_rel.values()), f"non-finite gradient {rec}")
    check(loss_rel <= LM_GRAD_TOL["loss"], f"flash vs vanilla loss: {rec}")
    check(grad_rel[worst] <= LM_GRAD_TOL["grad"], f"flash vs vanilla gradients: {rec}")
    del vanilla
    torch.cuda.empty_cache()
    return rec


def phase_lm_routes(torch, fa, xent, port) -> dict:
    """The head_dim-128 LM for 2 steps: through K5 as it stands, through
    K6a + K6b with _GROUPED_BWD=False."""
    Trainer, RunConfig = port
    cfg = RunConfig(**LM_D128_CFG)
    runs = {}
    for route, grouped in (("grouped", True), ("split", False)):
        fa._GROUPED_BWD = grouped
        try:
            trainer = Trainer(cfg, device="cuda")
            reset_counts(fa, xent)
            summary = trainer.fit()
            counts = read_counts(fa, xent)
        finally:
            fa._GROUPED_BWD = True
        steps = trainer.state.step
        loss = trainer.history[0]["train_loss"]
        rec = {"phase": "lm_route", "route": route, "config": cfg.name, "heads": 4,
               "head_dim": 128, "steps": steps, "train_loss": loss,
               "total_time_s": summary["total_time_s"], "launches": counts}
        emit(rec)
        check(math.isfinite(loss), f"non-finite loss {rec}")
        want = ({"flash_bwd_grouped": DEPTH * steps} if grouped else
                {"flash_bwd_dkv": DEPTH * steps, "flash_bwd_dq": DEPTH * steps})
        others = [k for k in BWD_COUNTERS if k not in want]
        check(all(counts[k] == n for k, n in want.items())
              and all(counts[k] == 0 for k in others),
              f"{route} route launches {counts}, expected {want} and no other")
        runs[route] = rec
        trainer.close()
        del trainer
        torch.cuda.empty_cache()
    return runs


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


# Each kernel's design as it stands: "tensor-core bf16" for the bf16
# instances on mma.sync, "scalar" for CUDA-core float32 FMAs.  The flash
# kernels' float32 instances stay scalar (the tensor cores have no float32
# product that keeps the 1e-4 checks).
DESIGN = {"flash_fwd": "tensor-core bf16", "flash_bwd_fused": "tensor-core bf16",
          "flash_bwd_grouped": "tensor-core bf16", "flash_bwd_dkv": "tensor-core bf16",
          "flash_bwd_dq": "scalar", "xent_fwd": "scalar", "xent_bwd": "scalar"}


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
        from distributed_tensorflow_ibm_mnist_tpu_torch.core import steps as steps_mod
        from distributed_tensorflow_ibm_mnist_tpu_torch.core.trainer import Trainer
        from distributed_tensorflow_ibm_mnist_tpu_torch.models import get_model
        from distributed_tensorflow_ibm_mnist_tpu_torch.ops import _build
        from distributed_tensorflow_ibm_mnist_tpu_torch.ops import flash_attention as fa
        from distributed_tensorflow_ibm_mnist_tpu_torch.ops import xent
        from distributed_tensorflow_ibm_mnist_tpu_torch.serving import InferenceEngine
        from distributed_tensorflow_ibm_mnist_tpu_torch.utils.config import (
            RunConfig,
            get_preset,
        )
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
    bwd_errs = phase_flash_bwd_kernels(torch, fa)
    flash_timed = phase_flash_time(torch, fa)
    lm = phase_lm_training(torch, fa, xent, (Trainer, RunConfig))
    phase_lm_grad_check(torch, lm.pop("trainer"), get_model, steps_mod)
    routes = phase_lm_routes(torch, fa, xent, (Trainer, RunConfig))

    def entry(name, source, replaces, launches, max_err, timed, by):
        head = timed[0] if by == "by_shape" else timed[-1]  # the path's shape
        return {"name": name, "route": "cuda",
                "source": f"distributed_tensorflow_ibm_mnist_tpu_torch/csrc/{source}",
                "replaces": f"distributed_tensorflow_ibm_mnist_tpu/{replaces}",
                "design": DESIGN[name], "launches": launches, "max_abs_err": max_err,
                "max_err": max_err, "ms": head["ms"], "kernel_ms": head["ms"],
                "plain_ms": head["plain_ms"],
                "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                "library_ms": head["library_ms"], "shape": head["shape"],
                by: [{k: r[k] for k in ("shape", "ms", "plain_ms", "library_ms",
                                        "bound_ms", "bound_by")} for r in timed]}

    def bwd_entry(name, replaces, launches):
        rec = flash_timed[name]
        return {**entry(name, "flash_bwd.cu", replaces, launches, bwd_errs[name][0],
                        [rec], "by_shape"),
                "max_rel_err": bwd_errs[name][1], "plain_shape": rec["plain_shape"],
                "plain_note": rec["plain_note"], "library_call": rec["library_call"]}

    counts = training["launches"]
    k3_entry = entry("flash_fwd", "flash_fwd.cu", "ops/flash_attention.py:208",
                     serving["flash_launches"], k3["max_abs_err"], k3["timed"], "by_seq")
    # K3 at the LM training shape, launches on the LM training run
    k3_entry["lm_training"] = {**{k: flash_timed["flash_fwd"][k] for k in (
        "shape", "ms", "plain_ms", "plain_shape", "library_ms", "bound_ms", "bound_by")},
        "launches": lm["launches"]["flash_fwd"]}
    print(json.dumps({"kernels": [
        # K3 at S=512, the largest serving bucket; launches on the serving run
        k3_entry,
        # K4 on the bench_lm8k run; K5 and K6a/b on the head_dim-128 runs
        bwd_entry("flash_bwd_fused", "ops/flash_attention.py:340",
                  lm["launches"]["flash_bwd_fused"]),
        bwd_entry("flash_bwd_grouped", "ops/flash_attention.py:399",
                  routes["grouped"]["launches"]["flash_bwd_grouped"]),
        bwd_entry("flash_bwd_dkv", "ops/flash_attention.py:304",
                  routes["split"]["launches"]["flash_bwd_dkv"]),
        bwd_entry("flash_bwd_dq", "ops/flash_attention.py:460",
                  routes["split"]["launches"]["flash_bwd_dq"]),
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
