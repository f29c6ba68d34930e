#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and hold its kernels to account.

Run from the repository root, with one GPU visible::

    python3 chip_smoke.py

It imports only the port (``distributed_tensorflow_ibm_mnist_tpu_torch``),
never JAX or the JAX package.  Phases, one JSON line each:

1. device — the card, its ``nvidia-smi`` name and power limit, the
   seconds to build every CUDA source of the port with nvcc (one nvcc per
   source, all started together), the tensor-core instructions (``HMMA``
   for mma.sync, ``HGMMA`` for wgmma) in each library's machine code
   (``cuobjdump --dump-sass``; it fails unless each flash library holds
   the instruction of every design it uses: ``check_tensor_cores``) and
   the registers and spill bytes of every kernel instance from the ptxas
   log;
2. kernels — the flash-attention forward (K3) against its plain PyTorch
   version on the card, at the serving path's shapes and the edge cases
   (head_dim 32, 40 and 128 among them; non-causal at the ViT's ragged
   lengths 49 and 196, at 1000, and batch 2 on q/k/v views of one
   (B, S, 3, H, D) tensor, these also row by row), with the stated
   tolerances; at the path's shapes the kernel, the plain version and one
   PyTorch library call are timed with CUDA events;
3. serving — the full-width flash-prefill LM (causal_lm, vocab 256, dim
   512, depth 4, 8 heads, bf16, seeded random weights) serves 16 requests
   through ``InferenceEngine``; every request must finish with its whole
   budget, the flash kernel's launch count must equal depth x admissions
   (the path ran through the kernel), and the prefill logits must agree
   with the same weights under plain attention; then the same run once
   more under ``torch.profiler`` (device time by kernel, busy share);
4. xent kernels — the softmax cross-entropy forward (K1) and backward (K2)
   against their plain versions at the shapes of every path that launches
   them (LeNet's (128, 10), the ViT's (512, 10), the dp runs' per-rank
   (1024, 10), (512, 10) and (128, 10): ``DP_XENT_SHAPES``) and the edge
   cases, then timed at those and (2048, 10) beside their bound and a
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
   entry at the edge cases (S=1000 and 1030, GQA with H_kv=2, window 128,
   non-causal, float32, D=128, D=40, D=32, and batch 2 with q, k, v views
   of one (B, S, 3, H, D) tensor; non-causal at S=49, 196 and 1000 and
   packed at (2, 196, 8, 64), every output row by row); then the public
   ``flash_attention_bwd``
   on each route (forced by its routing constants) at (1, 8192, 4, 128)
   and under GQA at (1, 2048, 8, 64) with H_kv=2, so the wrapper's own
   sums of grouped partials and per-kv-head dK/dV are held too.
   Tolerances are relative to the reference's largest magnitude; K6b's
   dQ is also held row by row (``row_rel_err``);
7. flash timings at the LM training path's shapes — K4 at (8, 8192, 8,
   64), K5, K6a and K6b at (8, 8192, 4, 128), K3 at (8, 8192, 8, 64) —
   beside their bounds, the plain versions (at batch 1: batch 8 does not
   fit the plain version's float32 score matrices) and PyTorch's
   ``scaled_dot_product_attention`` (for the backward kernels its backward
   alone, ``sdpa_grad``: with respect to q, k, v for K4/K5, k, v for K6a
   and q for K6b);
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
11. lm_split — the head_dim-128 LM at S=32768 (batch 2, 2 steps, 1 eval
   batch), where the JAX rule itself takes the split route: K6a and K6b
   must each launch depth x steps times and no other backward kernel, the
   loss stay finite; K6b's dQ at (2, 32768, 4, 128), on q/k/v views of
   one (B, S, 3, H, D) tensor as the model gives them, against the fused
   walk's (also row by row), and K6b timed there; the step time,
   tokens/s and one profiled step with K6b's share of device time;
12. vit kernels — K3 and K4 at the ViT's attention shape (512, 196, 8,
   64) bf16 non-causal on packed q/k/v views: against the plain versions
   entry by entry and row by row, then timed beside their bounds, the
   plain versions and SDPA (non-causal);
13. resnet20 and resnet50 — ``Trainer.fit()`` on the presets
   ``fashion_resnet20_dp32`` and ``cifar_resnet50_dp32`` in single-chip
   form (dp=1; ResNet-50 with ``grad_accum=4``; batch 4096, momentum 0.9,
   lr 0.4, warmup-cosine, weight decay 1e-4, synthetic 60k/10k and
   50k/10k) to the preset's 0.90 target: the best test accuracy must reach
   it, the loss stay finite and every BatchNorm's running statistics be
   finite and moved from (0, 1); then ``measure_throughput(epochs=1)``
   (which must leave them as they were) and one profiled step;
14. vit — ``Trainer.fit()`` on the repo's compute-bound ViT (dim 512,
   depth 8, 8 heads, patch 2 on MNIST: 196 tokens, batch 512, Adam 1e-3,
   ``attn="flash"``, ``fused_xent=True``; 8192/1024 images, one epoch): K3
   must launch depth x (steps + eval batches) times, K4 depth x steps and
   no other backward kernel, K1 and K2 once a step, the loss stay finite;
   its throughput, one profiled step, and flash against vanilla attention
   on the trained weights at batch 8 (logits within 2e-2 of the largest,
   gradients within 3e-2);
15. dp — data-parallel training through ``torch.distributed``, one
   ``dp`` line per sub-phase.  The card is one H100 and NCCL refuses two
   ranks on one GPU, so: ``dp1_nccl`` runs ``mnist_cnn_dp8`` at dp=1
   (``fused_xent``) as one rank of a world-size-1 NCCL group (the
   Trainer with a mesh: the bucketed gradient all-reduce every step)
   against the plain Trainer: the first epoch's losses must be bit-equal,
   K1 == K2 == steps, both reach 0.99; the difference of their steady
   step times is the wrapper's cost; ``dp2_gloo`` runs it at dp=2 as two
   gloo ranks sharing the card over 20 fixed global batches (dropout
   off), replicated, ZeRO-1 and a float32 twin, against dp=1 on the same
   batches: per-step loss within 2e-3, the whole update within 0.1 of
   dp=1's; the float32 twin also tensor by tensor, its first-step
   gradient (``DP_GRAD_REL``) and final parameters (``PARAM_REL_F32``);
   the twin again under each planted fault (``DP_FAULTS``: the smallest
   bucket left un-reduced, a sum for the mean), which must fail both of
   those; ZeRO-1 bit-equal to the replicated update, both ranks equal,
   K1 == K2 == 20 a rank;
   ``dp8_gloo_fit`` trains the preset as written (dp 8, global batch
   1024) as 8 gloo ranks on the one card to 0.99; ``resnet20_dp2_gloo``
   takes two global batches of 4096 of ``fashion_resnet20_dp32`` at dp=2
   with cross-replica BatchNorm (bf16 and a float32 twin) against dp=1:
   running statistics bit-equal on both ranks, loss and statistics
   within 2e-2, the float32 parameters within 2e-2 of each tensor's
   largest entry; before it, the BatchNorm backward's CUDA kernels
   against their plain formulas at ResNet-20's per-rank activations
   (``BN_BWD_TOL``), and after it the float64 gradient on 8 rows a rank
   against dp=1's (``BN_GRAD_REL``), which must fail with the backward's
   cross-rank sum planted away.  Each line also carries the host time of
   one step's collectives on the model's buckets (``collectives``);
16. the ``kernels`` line: per kernel, its design, its launches on its
   path's run (serving for K3, the LM runs for K4-K6, LeNet training for
   K1/K2; the ViT run's for K1-K4 and the ``dp`` runs' for K1/K2 beside
   them), largest error, times and bound;
17. the last line: ``{"ok": true, "device": {...}}``.

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


# The tensor-core instruction of each bf16 design in the machine code, and
# the designs each flash library's kernels use: mma.sync (K3, K4, K5, K6a)
# and wgmma (K6b).
TC_INSTRUCTION = {"mma.sync": "HMMA", "wgmma": "HGMMA"}
TC_DESIGNS = {"flash_fwd": ("mma.sync",), "flash_bwd": ("mma.sync", "wgmma")}


def check_tensor_cores(sass: dict, designs: dict) -> None:
    """Fail unless each library's machine code (``sass``: instruction
    counts by library) holds the tensor-core instruction of every design
    that ``designs`` says it uses."""
    for name, used in designs.items():
        for design in used:
            op = TC_INSTRUCTION[design]
            check(sass[name][op] > 0,
                  f"{name}: its {design} design compiled to no {op} instruction: "
                  f"{sass[name]}")


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
    check_tensor_cores(sass, TC_DESIGNS)
    return rec


def phase_kernels(torch, fa) -> dict:
    """Flash forward (K3) against its plain version, then timed."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32

    def qkv(s, h=8, hkv=8, d=64, dtype=bf16, b=1, packed=False):
        """q, k, v from ``gen``; ``packed``: views of one (B, S, 3, H, D)
        tensor, as the blocks' qkv projection gives them."""
        mk = lambda *heads: torch.randn((b, s, *heads, d), generator=gen,  # noqa: E731
                                        device="cuda").to(dtype)
        if packed:
            return mk(3, h).unbind(2)
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
        # non-causal at the ViT's ragged lengths (196 and 49 tokens: no tile
        # multiple, and 49 is below one 64-row tile), where every real row
        # sees the padded key columns unless the sequence-end mask holds;
        # also held row by row
        dict(s=196, causal=False), dict(s=196, d=32, causal=False),
        dict(s=49, causal=False), dict(s=49, d=32, causal=False),
        dict(s=1000, causal=False),
        dict(b=2, s=196, causal=False, packed=True),  # the ViT's qkv views
    ]
    max_err = 0.0
    for c in cases:
        s, causal, window = c["s"], c.get("causal", True), c.get("window", 0)
        dtype, b = c.get("dtype", bf16), c.get("b", 1)
        q, k, v = qkv(s, hkv=c.get("hkv", 8), d=c.get("d", 64), dtype=dtype, b=b,
                      packed=c.get("packed", False))
        out, lse = fa.flash_attention_fwd(q, k, v, causal, window)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_plain(q, k, v, causal, window)
        err = (out.float() - ref_out.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        row_err = row_rel_err(out, ref_out)
        # bf16: P enters PV rounded to bf16 (as on the TPU) while the plain
        # version keeps it f32, and both outputs round to bf16
        tol = 1e-4 if dtype == f32 else 2e-2
        rec = {"phase": "kernel_check", "kernel": "flash_fwd",
               "shape": [b, s, 8, c.get("d", 64)], "heads_kv": c.get("hkv", 8),
               "causal": causal, "window": window, "dtype": str(dtype),
               "packed_qkv": c.get("packed", False),
               "max_abs_err": err, "lse_err": lse_err, "tol": tol,
               "lse_tol": 1e-3, "row_rel_err": row_err,
               "row_rel_tol": None if causal else ROW_TOL[str(dtype)]}
        emit(rec)
        check(bool(torch.isfinite(out.float()).all()), f"non-finite output {rec}")
        check(err <= tol and lse_err <= 1e-3, f"kernel disagrees: {rec}")
        check(causal or row_err <= ROW_TOL[str(dtype)], f"kernel disagrees row by row: {rec}")
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
VIT_XENT_SHAPE = (512, 10)  # the ViT step's: batch 512, float32 logits
# mnist_cnn_dp8's per-rank logits: its global batch 1024 over dp=1, 2 and 8
# (dp1_nccl, dp2_gloo, dp8_gloo_fit); dp 2 and 8 land on the shapes above
DP_XENT_SHAPES = {1: (1024, 10), 2: VIT_XENT_SHAPE, 8: XENT_SHAPE}
# LeNet's, the ViT's, dp1_nccl's, and larger
XENT_TIMED = (XENT_SHAPE, VIT_XENT_SHAPE, DP_XENT_SHAPES[1], (2048, 10))


def xent_cost(n: int, c: int, itemsize: int, backward: bool) -> tuple[float, float]:
    """(operations, bytes) one call needs: each input read once and each
    output written once; per logit 4 operations forward (max, subtract,
    exp, add), 8 backward (the same, then subtract, exp, scale, one-hot
    subtract)."""
    if backward:  # logits, labels, g in; dx out
        return 8.0 * n * c, n * c * itemsize + 4 * n + 4 * n + n * c * itemsize
    return 4.0 * n * c, n * c * itemsize + 4 * n + 4 * n  # logits, labels in; loss out


def phase_xent_kernels(torch, xent) -> dict:
    """K1 and K2 against their plain twins (at the shapes of every path
    that launches them: LeNet's, the ViT's and the data-parallel runs'
    per-rank logits, among others), then timed."""
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
    cases = [dict(shape=XENT_SHAPE), dict(shape=VIT_XENT_SHAPE, what="vit"),
             dict(shape=DP_XENT_SHAPES[1], what="dp1"),
             dict(shape=(37, 10)), dict(shape=(100, 257)),
             dict(shape=(8, 128)), dict(shape=XENT_SHAPE, dtype=bf16),
             dict(shape=(8, 4), x=extreme,
                  y=torch.zeros(8, dtype=torch.int32, device="cuda"), what="extreme"),
             dict(shape=(4, 10), what="label out of range",
                  y=torch.tensor([-1, 10, 300, 3], dtype=torch.int32, device="cuda"))]
    errs = {"xent_fwd": 0.0, "xent_bwd": 0.0}
    at_shape = {}  # a path's shape: its K1/K2 errors
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
        if dtype == f32:
            e = at_shape.setdefault((n, c), {"xent_fwd": 0.0, "xent_bwd": 0.0})
            e["xent_fwd"], e["xent_bwd"] = max(e["xent_fwd"], err_f), max(e["xent_bwd"], err_b)

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
    return {"max_abs_err": errs, "at_shape": at_shape, "timed": timed}


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
# K6b's dQ is also held row by row: each (batch, position, head) row's
# error norm over that row's reference norm.  Causal dQ rows shrink about
# as 1/sqrt(position), so a measure against the largest magnitude would let
# the late half of a long sequence go wrong unseen.  A row whose reference
# norm is below ROW_FLOOR of the largest (causal row 0's dQ is zero) is
# measured against that floor instead.
# ROW_TOL is about 3x the worst row seen on an H100 over every shape
# checked (bf16 4.8e-3 against the plain backward, 2.9e-3 against the
# fused walk at S=32768; float32 7.6e-7).
ROW_TOL = {"torch.bfloat16": 1.5e-2, "torch.float32": 5e-6}
ROW_FLOOR = 1e-3


def row_rel_err(got, ref) -> float:
    """The largest error norm of a row of the last dim over its reference
    norm (floored at ROW_FLOOR of the largest)."""
    err = (got.float() - ref.float()).norm(dim=-1)
    norm = ref.float().norm(dim=-1)
    return (err / norm.clamp(min=max(ROW_FLOOR * norm.max().item(), 1e-30))).max().item()


def bwd_inputs(torch, fa, gen, b, s, h, hkv, d, dtype, causal=True, window=0,
               packed=False):
    """q, k, v, dO from ``gen``; lse from K3; delta = rowsum(dO * O).
    ``packed``: q, k, v are views of one (B, S, 3, H, D) tensor, as the
    model's qkv projection gives them, and dO is a view of a (B, S, 2, H, D)
    one, so no batch or seq stride is a contiguous tensor's."""
    def mk(*heads):
        return torch.randn((b, s, *heads, d), generator=gen, device="cuda").to(dtype)
    if packed:
        check(h == hkv, "packed q, k, v need as many kv heads as q heads")
        q, k, v = mk(3, h).unbind(2)
        g = mk(2, h)[:, :, 1]
    else:
        q, k, v, g = mk(h), mk(hkv), mk(hkv), mk(h)
    with torch.no_grad():
        out, lse = fa.flash_attention_fwd(q, k, v, causal, window)
    delta = (g.float() * out.float()).sum(-1)
    return q, k, v, g, lse, delta


def per_kv(x, hkv):
    """Per-q-head (B, S, H, D) -> per-kv-head sums, float32."""
    b, s, h, d = x.shape
    return x.float().view(b, s, hkv, h // hkv, d).sum(3)


def compare(name, got: dict, ref: dict, dtype, extra: dict,
            by_row: bool = False) -> tuple[float, float, float]:
    """Emit one check record; raise when an output disagrees, relative to
    the reference's largest magnitude and, with ``by_row``, also row by row
    (``row_rel_err`` within ROW_TOL).  Returns the largest absolute,
    relative and row-relative errors."""
    tol, row_tol = BWD_TOL[str(dtype)], ROW_TOL[str(dtype)]
    errs = {}
    for key, a in got.items():
        r = ref[key]
        abs_err = (a.float() - r).abs().max().item()
        errs[key] = (abs_err, abs_err / max(r.abs().max().item(), 1e-30), row_rel_err(a, r))
    finite = all(bool(a.float().isfinite().all()) for a in got.values())
    rec = {"phase": "kernel_check", "kernel": name, **extra, "dtype": str(dtype),
           "max_abs_err": {k: e[0] for k, e in errs.items()},
           "rel_err": {k: e[1] for k, e in errs.items()}, "rel_tol": tol,
           "row_rel_err": {k: e[2] for k, e in errs.items()},
           "row_rel_tol": row_tol if by_row else None}
    emit(rec)
    check(finite, f"non-finite {name} output {rec}")
    check(all(e[1] <= tol for e in errs.values()), f"{name} disagrees: {rec}")
    check(not by_row or all(e[2] <= row_tol for e in errs.values()),
          f"{name} disagrees row by row: {rec}")
    return tuple(max(e[i] for e in errs.values()) for i in range(3))


def check_bwd_entries(torch, fa, gen, b, s, h, hkv, d, dtype, causal, window, which,
                      n_groups=4, packed=False):
    """Run the named entries at one shape against the plain backward; K6b's
    dQ, and every output of a non-causal case, also row by row.  Returns
    {entry: (abs_err, rel_err, row_rel_err)}."""
    args = bwd_inputs(torch, fa, gen, b, s, h, hkv, d, dtype, causal, window, packed)
    q = args[0]
    ref = dict(zip(("dq", "dk", "dv"),
                   fa.flash_attention_bwd_plain(*args, causal, window)))
    extra = {"shape": [b, s, h, d], "heads_kv": hkv, "causal": causal, "window": window,
             "packed_qkv": packed}
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
        out[entry] = compare(entry, got, ref, dtype, extra,
                             by_row=entry == "flash_bwd_dq" or not causal)
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
    (0: one q tile per group).  Returns {entry: (abs_err, rel_err,
    row_rel_err)}."""
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
    errs = {e: (0.0, 0.0, 0.0) for e in BWD_ENTRIES}

    def fold(found):
        for e, err in found.items():
            errs[e] = tuple(map(max, errs[e], err))

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
             dict(s=1030, d=128),                 # a last 128-row q-tile half past S
             dict(b=2, s=1030, d=128, packed=True),  # the model's batch and qkv strides
             dict(s=1000, d=40),                  # a multiple of 8, not of 16
             dict(s=1024, d=32),
             dict(s=1000, d=40, dtype=f32),
             # non-causal at the ViT's ragged lengths (below one tile at 49),
             # every output row by row
             dict(s=196, causal=False), dict(s=196, d=32, causal=False),
             dict(s=49, causal=False), dict(s=49, d=32, causal=False),
             dict(s=1000, causal=False),
             dict(b=2, s=196, causal=False, packed=True)]
    for c in edges:
        fold(check_bwd_entries(torch, fa, gen, c.get("b", 1), c["s"], 8, c.get("hkv", 8),
                               c.get("d", 64), c.get("dtype", bf16), c.get("causal", True),
                               c.get("window", 0), BWD_ENTRIES, packed=c.get("packed", False)))
    # the public wrapper on every route: at the head_dim-128 LM shape, and
    # under GQA, where it sums dK/dV per kv head (4 groups of one tile)
    fold(check_public_routes(torch, fa, gen, 1, LM_SEQ, 4, 4, 128, bf16))
    fold(check_public_routes(torch, fa, gen, 1, 2048, 8, 2, 64, bf16, group_budget=0))
    return errs


def sdpa_grad(q, k, v, g, wrt: str, causal: bool = True):
    """One PyTorch call as a backward kernel's yardstick: the gradient of
    ``F.scaled_dot_product_attention(is_causal=causal)`` on (B, S, H, D)
    inputs under the output gradient ``g``, with respect to ``wrt``: "q"
    (K6b's dQ), "kv" (K6a's dK, dV) or "qkv" (K4, K5).  The forward runs
    once here; the returned function runs the backward alone
    (``retain_graph``) and returns the gradients as (B, S, H, D) views.
    Runs on any device."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(name in wrt)
                  for name, x in zip("qkv", (q, k, v)))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    leaves = [t for name, t in zip("qkv", (qt, kt, vt)) if name in wrt]
    gt = g.transpose(1, 2)
    return lambda: tuple(x.transpose(1, 2) for x in
                         torch.autograd.grad(out, leaves, gt, retain_graph=True))


SDPA_CALL = ("torch.autograd.grad through F.scaled_dot_product_attention(is_causal=True), "
             "its backward alone (retain_graph=True), with respect to ")


def attn_bytes(q, k, v, *extra) -> float:
    return float(sum(x.numel() * x.element_size() for x in (q, k, v, *extra)))


def phase_flash_time(torch, fa) -> dict:
    """K3-K6 at the LM training path's shapes, beside their bounds, their
    plain versions (batch 1) and SDPA (for the backward kernels, its
    gradient with respect to what each kernel computes)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(6)
    bf16 = torch.bfloat16
    timed = {}

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
        library = {wrt: gpu_ms(sdpa_grad(q, k, v, g, wrt), torch, **slow)
                   for wrt in (("qkv",) if d == 64 else ("qkv", "kv", "q"))}
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
                       plain_bwd, library["qkv"], 5 * 2.0 * d * pairs,
                       attn_bytes(q, k, v, g, *stats, q, k, v), SDPA_CALL + "(q, k, v)")
            elif name == "flash_bwd_dkv":  # S, dP, dV, dK: 4 products
                record(name, [b, s, h, d],
                       gpu_ms(lambda: fa._launch_dkv(*args), torch, **slow),
                       plain_bwd, library["kv"], 4 * 2.0 * d * pairs,
                       attn_bytes(q, k, v, g, *stats, k, v), SDPA_CALL + "(k, v)",
                       "the whole plain backward (dq, dk, dv) at batch 1")
            else:  # S, dP, dQ: 3 products
                record(name, [b, s, h, d],
                       gpu_ms(lambda: fa._launch_dq(*args), torch, **slow),
                       plain_bwd, library["q"], 3 * 2.0 * d * pairs,
                       attn_bytes(q, k, v, g, *stats, q), SDPA_CALL + "q",
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


# The head_dim-128 LM where the JAX rule itself takes the split route
# (K6a then K6b): S=32768, batch 2 (65536 tokens a step, as bench_lm8k's),
# 2 steps and 1 eval batch
SPLIT_SEQ = 32768
LM_SPLIT_CFG = dict(LM_D128_CFG, name="lm32k_d128", n_train=4, n_test=2, batch_size=2,
                    eval_batch_size=2, dataset_kwargs={"vocab": 256, "seq_len": SPLIT_SEQ})


def check_split_dq(torch, fa, gen) -> dict:
    """K6b at the split route's shape and layout, (2, 32768, 4, 128) with
    q, k, v views of one (B, S, 3, H, D) tensor as the model gives them:
    its dQ against the fused tensor-core walk's (K4's design, a second
    kernel: the plain version does not fit at this length), relative to the
    largest magnitude and row by row; then K6b timed on the same inputs
    beside its bound and SDPA's dQ."""
    bf16 = torch.bfloat16
    b, s, h, d = 2, SPLIT_SEQ, 4, 128
    q, k, v, g, lse, delta = args = bwd_inputs(torch, fa, gen, b, s, h, h, d, bf16,
                                               packed=True)
    ref = fa._launch_fused(*args, True, 0, fa.Route("fused", 1, s))[0]
    got = fa._launch_dq(*args, True, 0)
    torch.cuda.synchronize()
    abs_err, rel_err, row_err = compare(
        "flash_bwd_dq", {"dq": got}, {"dq": ref.float()}, bf16,
        {"shape": [b, s, h, d], "heads_kv": h, "causal": True, "window": 0,
         "packed_qkv": True, "reference": "flash_bwd_fused's dQ"}, by_row=True)
    del ref, got
    slow = dict(reps=3, inner=2, sleep=0)
    rec = {"phase": "kernel_time", "kernel": "flash_bwd_dq", "shape": [b, s, h, d],
           "dtype": "bf16", "causal": True,
           "ms": gpu_ms(lambda: fa._launch_dq(q, k, v, g, lse, delta, True, 0), torch, **slow),
           "plain_ms": None, "plain_note": "the plain version does not fit at this length",
           "library_ms": gpu_ms(sdpa_grad(q, k, v, g, "q"), torch, **slow),
           "library_call": SDPA_CALL + "q",
           **bound(3 * 2.0 * d * b * h * live_pairs(s, True, 0), attn_bytes(
               q, k, v, g, lse, delta, q), H100_BF16_FLOPS)}
    emit(rec)
    del args, q, k, v, g, lse, delta
    torch.cuda.empty_cache()
    return {"abs_err": abs_err, "rel_err": rel_err, "row_rel_err": row_err, "timed": rec}


def phase_lm_split(torch, fa, xent, port) -> dict:
    """The head_dim-128 LM at S=32768 through Trainer.fit(), unforced: the
    JAX rule's split route, K6a then K6b; then K6b's checks at that length,
    the step time and one profiled step."""
    Trainer, RunConfig = port
    route = fa.bwd_route(SPLIT_SEQ, 128, torch.bfloat16)
    check(route.name == "split", f"S={SPLIT_SEQ}, D=128 takes the {route} route, not split")
    cfg = RunConfig(**LM_SPLIT_CFG)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device="cuda")
    setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa, xent)
    summary = trainer.fit()
    counts = read_counts(fa, xent)
    steps = trainer.state.step
    loss = trainer.history[0]["train_loss"]
    rec = {"phase": "lm_split", "config": LM_SPLIT_CFG, "route": route._asdict(),
           "dtype": "bf16", "setup_s": round(setup_s, 3), "steps": steps,
           "train_loss": loss, "test_loss": trainer.history[0]["test_loss"],
           "total_time_s": summary["total_time_s"],
           "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 1e9, 3),
           "launches": counts}
    emit(rec)
    check(math.isfinite(loss), f"non-finite loss {rec}")
    want = {"flash_bwd_dkv": DEPTH * steps, "flash_bwd_dq": DEPTH * steps}
    check(steps > 0 and all(counts[k] == n for k, n in want.items())
          and all(counts[k] == 0 for k in BWD_COUNTERS if k not in want),
          f"split route launches {counts}, expected {want} and no other backward kernel")

    kernels = check_split_dq(torch, fa, torch.Generator(device="cuda").manual_seed(7))

    def one_step():
        t = time.perf_counter()
        trainer._run_epoch(trainer.state, trainer.train_images[:cfg.batch_size],
                           trainer.train_labels[:cfg.batch_size])["loss"][-1].item()
        return time.perf_counter() - t

    walls = [one_step() for _ in range(4)][1:]  # the first warms the allocator
    s_per_step = statistics.median(walls)
    tokens = cfg.batch_size * SPLIT_SEQ
    emit({"phase": "lm_split_throughput", "s_per_step": s_per_step, "step_walls_s": walls,
          "tokens_per_step": tokens, "tokens_per_sec_per_chip": tokens / s_per_step})
    prof = profile_run(torch, one_step, "lm split-route training step",
                       {"flash_bwd_dq_device_s": "flash_bwd_dq",
                        "flash_bwd_dkv_device_s": "flash_bwd_kv_tc",
                        "flash_fwd_device_s": "flash_fwd"})
    if prof["device_busy_s"]:
        prof["flash_bwd_dq_share_of_device"] = round(
            prof["flash_bwd_dq_device_s"] / prof["device_busy_s"], 4)
    emit(prof)
    trainer.close()
    del trainer
    torch.cuda.empty_cache()
    return {**rec, "s_per_step": s_per_step, "kernels": kernels}


# ---------------------------------------------------------------- image models

# the repo's compute-bound ViT point (docs/PERFORMANCE.md:45, BASELINE.md:54):
# dim 512, depth 8, patch 2 on 28 px MNIST (196 tokens), batch 512, Adam
# 1e-3; 8 heads (head_dim 64).  Cut: 8192 training and 1024 test images, one
# epoch (16 steps, 2 eval batches)
VIT_DEPTH = 8
VIT_KW = {"dim": 512, "depth": VIT_DEPTH, "heads": 8, "patch_size": 2, "attn": "flash"}
VIT_CFG = dict(name="vit_d512_p2", model="vit", model_kwargs=VIT_KW, dataset="mnist",
               synthetic=True, n_train=8192, n_test=1024, batch_size=512,
               eval_batch_size=512, epochs=1, optimizer="adam", lr=1e-3,
               fused_xent=True, quiet=True)
VIT_ATTN = (512, 196, 8, 64)  # (B, S, H, D) at every block's attention
# flash against vanilla on the same weights at batch 8: logits relative to
# the largest |logit|, gradients relative to each parameter's largest (the
# LM's limit); the two attentions round at different places in bf16
VIT_GRAD_TOL = {"logits": 2e-2, "grad": 3e-2}


def phase_vit_kernels(torch, fa) -> dict:
    """K3 and K4 at the ViT's attention shape, (512, 196, 8, 64) bf16
    non-causal on q/k/v views of one (B, S, 3, H, D) tensor as its blocks
    pass them: against the plain versions entry by entry and row by row,
    then timed beside their bounds, the plain versions and SDPA.  4096
    (batch, head) rows of 4 k-tiles each; K4's float32 dQ buffer is made
    and zeroed per call at this batch."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(8)
    bf16 = torch.bfloat16
    b, s, h, d = VIT_ATTN
    check(fa.bwd_route(s, d, bf16).name == "fused", "the ViT shape does not take K4")
    q, k, v, g, lse, delta = args = bwd_inputs(torch, fa, gen, b, s, h, h, d, bf16,
                                               causal=False, packed=True)
    out, lse2 = fa.flash_attention_fwd(q, k, v, False)
    ref_out, ref_lse = fa.flash_attention_plain(q, k, v, False)
    torch.cuda.synchronize()
    fwd_err = {"max_abs_err": (out.float() - ref_out.float()).abs().max().item(),
               "lse_err": (lse2 - ref_lse).abs().max().item(),
               "row_rel_err": row_rel_err(out, ref_out)}
    rec = {"phase": "kernel_check", "kernel": "flash_fwd", "shape": list(VIT_ATTN),
           "causal": False, "packed_qkv": True, "dtype": "torch.bfloat16", **fwd_err,
           "tol": 2e-2, "lse_tol": 1e-3, "row_rel_tol": ROW_TOL["torch.bfloat16"]}
    emit(rec)
    check(bool(out.float().isfinite().all()) and fwd_err["max_abs_err"] <= 2e-2
          and fwd_err["lse_err"] <= 1e-3
          and fwd_err["row_rel_err"] <= ROW_TOL["torch.bfloat16"],
          f"flash_fwd disagrees at the ViT shape: {rec}")
    del out, lse2, ref_out, ref_lse
    bwd_err = check_bwd_entries(torch, fa, gen, b, s, h, h, d, bf16, False, 0,
                                ["flash_bwd_fused"], packed=True)["flash_bwd_fused"]

    pairs = b * h * live_pairs(s, False, 0)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    route = fa.Route("fused", 1, s)
    # a call takes about as long to enqueue as to run: a 20M-cycle sleep
    # (~10 ms) keeps the host off the clock
    fast, slow = dict(sleep=20_000_000), dict(reps=5, inner=2, sleep=0)
    timed = {}
    for name, kernel, plain, library, flops, nbytes, call in (
            ("flash_fwd", lambda: fa.flash_attention_fwd(q, k, v, False),
             lambda: fa.flash_attention_plain(q, k, v, False),
             lambda: F.scaled_dot_product_attention(qt, kt, vt),
             4.0 * d * pairs, attn_bytes(q, k, v, q, lse),
             "F.scaled_dot_product_attention (non-causal)"),
            ("flash_bwd_fused", lambda: fa._launch_fused(*args, False, 0, route),
             lambda: fa.flash_attention_bwd_plain(*args, False),
             sdpa_grad(q, k, v, g, "qkv", causal=False),
             5 * 2.0 * d * pairs, attn_bytes(q, k, v, g, lse, delta, q, k, v),
             "torch.autograd.grad through F.scaled_dot_product_attention (non-causal), "
             "its backward alone (retain_graph=True), with respect to (q, k, v)")):
        rec = {"phase": "kernel_time", "kernel": name, "shape": list(VIT_ATTN),
               "dtype": "bf16", "causal": False, "packed_qkv": True,
               "ms": gpu_ms(kernel, torch, **fast), "plain_ms": gpu_ms(plain, torch, **slow),
               "plain_shape": list(VIT_ATTN), "library_ms": gpu_ms(library, torch, **fast),
               "library_call": call, **bound(flops, nbytes, H100_BF16_FLOPS)}
        emit(rec)
        timed[name] = rec
    del args, q, k, v, g, lse, delta, qt, kt, vt
    torch.cuda.empty_cache()
    return {"fwd_err": fwd_err, "bwd_err": bwd_err, "timed": timed}


def bn_buffers(model) -> dict:
    """Every BatchNorm's running statistics, as the model holds them."""
    return {name: buf for name, buf in model.named_buffers() if "running_" in name}


def phase_resnet(torch, fa, xent, port, preset: str, **replace) -> dict:
    """A ResNet preset in its single-chip form through Trainer.fit() to the
    preset's target, then its throughput and one profiled step."""
    Trainer, get_preset = port
    cfg = get_preset(preset).replace(dp=1, synthetic=True, quiet=True, **replace)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device="cuda")
    setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa, xent)
    summary = trainer.fit()
    counts = read_counts(fa, xent)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stats = bn_buffers(trainer.model)
    means = [v for k, v in stats.items() if k.endswith("running_mean")]
    variances = [v for k, v in stats.items() if k.endswith("running_var")]
    losses = [r[k] for r in trainer.history for k in ("train_loss", "test_loss") if k in r]
    rec = {"phase": "resnet_training", "preset": cfg.name, "model": cfg.model,
           "replace": {"dp": 1, **replace}, "batch_size": cfg.batch_size,
           "grad_accum": cfg.grad_accum, "optimizer": cfg.optimizer, "lr": cfg.lr,
           "schedule": cfg.schedule, "warmup_steps": cfg.warmup_steps,
           "weight_decay": cfg.weight_decay, "synthetic": trainer.data_synthetic,
           "n_train": int(trainer.train_images.shape[0]),
           "n_test": int(trainer.test_images.shape[0]), "setup_s": round(setup_s, 3),
           "steps": trainer.state.step, "epochs_run": summary["epochs_run"],
           "best_test_accuracy": summary["best_test_accuracy"],
           "target_accuracy": cfg.target_accuracy,
           "time_to_target_s": summary["time_to_target_s"],
           "total_time_s": summary["total_time_s"],
           "images_per_sec_per_chip_fit": summary["images_per_sec_per_chip"],
           "mfu_fit": summary["mfu"], "flops_per_image": trainer._flops_per_image,
           "param_count": summary["param_count"],
           "epoch_times_s": [r["epoch_time_s"] for r in trainer.history],
           "train_loss_last": trainer.history[-1]["train_loss"],
           "bn_layers": len(means),
           "bn_running_mean_abs_max": max(m.abs().max().item() for m in means),
           "bn_running_var_range": [min(v.min().item() for v in variances),
                                    max(v.max().item() for v in variances)],
           "peak_mem_gb": round(peak_gb, 3), "launches": counts}
    emit(rec)
    check(all(math.isfinite(x) for x in losses), f"non-finite loss: {losses}")
    check(summary["best_test_accuracy"] >= cfg.target_accuracy,
          f"{cfg.model} reached {summary['best_test_accuracy']}, not {cfg.target_accuracy}")
    check(all(bool(t.isfinite().all()) for t in stats.values()),
          "non-finite BatchNorm running statistics")
    check(all(bool((m != 0).any()) for m in means) and all(bool((v != 1).any())
                                                             for v in variances),
          "a BatchNorm's running statistics never moved from (0, 1)")

    before = {k: v.clone() for k, v in stats.items()}
    tp = trainer.measure_throughput(epochs=1)
    tp["s_per_step"] = cfg.batch_size / tp["images_per_sec"]
    emit({"phase": "resnet_throughput", "model": cfg.model, **tp})
    check(math.isfinite(tp["last_loss"]), f"non-finite throughput loss {tp}")
    check(all(torch.equal(before[k], v) for k, v in bn_buffers(trainer.model).items()),
          "measure_throughput moved the BatchNorm statistics")

    def one_step():
        t = time.perf_counter()
        trainer._run_epoch(trainer.state, trainer.train_images[:cfg.batch_size],
                           trainer.train_labels[:cfg.batch_size])["loss"][-1].item()
        return time.perf_counter() - t

    one_step()  # the allocator settles at this exact shape
    prof = profile_run(torch, one_step, f"{cfg.model} training step", {}, top_n=12)
    emit(prof)
    trainer.close()
    del trainer, stats, means, variances, before
    torch.cuda.empty_cache()
    return {**rec, "throughput": tp, "profile": prof}


def phase_vit(torch, fa, xent, port, get_model, steps_mod) -> dict:
    """The ViT through Trainer.fit() with flash attention (K3, K4) and the
    fused cross-entropy (K1, K2); then its throughput, one profiled step and
    flash against vanilla attention on the trained weights."""
    Trainer, RunConfig = port
    cfg = RunConfig(**VIT_CFG)
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
    rec = {"phase": "vit_training", "config": VIT_CFG, "dtype": "bf16",
           "seq_len": trainer.model.seq_len, "setup_s": round(setup_s, 3),
           "steps": steps, "eval_batches": eval_batches,
           "train_loss": trainer.history[0]["train_loss"],
           "test_loss": trainer.history[0]["test_loss"],
           "test_accuracy": trainer.history[0]["test_accuracy"],
           "total_time_s": summary["total_time_s"],
           "images_per_sec_per_chip_fit": summary["images_per_sec_per_chip"],
           "mfu_fit": summary["mfu"], "flops_per_image": trainer._flops_per_image,
           "param_count": summary["param_count"],
           "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 1e9, 3),
           "launches": counts}
    emit(rec)
    losses = [rec["train_loss"], rec["test_loss"]]
    check(all(math.isfinite(x) for x in losses), f"non-finite ViT loss: {losses}")
    check(counts["flash_fwd"] == VIT_DEPTH * (steps + eval_batches),
          f"K3 launched {counts['flash_fwd']} times, expected depth x (steps + eval "
          f"batches) = {VIT_DEPTH * (steps + eval_batches)}")
    check(counts["flash_bwd_fused"] == VIT_DEPTH * steps,
          f"K4 launched {counts['flash_bwd_fused']} times, expected depth x steps")
    check(counts["flash_bwd_grouped"] == counts["flash_bwd_dkv"]
          == counts["flash_bwd_dq"] == 0, f"another backward kernel ran: {counts}")
    check(counts["xent_fwd"] == counts["xent_bwd"] == steps,
          f"xent launches {counts} != steps taken {steps}")
    check((cfg.batch_size, trainer.num_classes) == VIT_XENT_SHAPE,
          f"the ViT step's logits are not the checked K1/K2 shape {VIT_XENT_SHAPE}")

    tp = trainer.measure_throughput(epochs=1)
    tp["s_per_step"] = cfg.batch_size / tp["images_per_sec"]
    emit({"phase": "vit_throughput", **tp})
    check(math.isfinite(tp["last_loss"]), f"non-finite throughput loss {tp}")

    def one_step():
        t = time.perf_counter()
        trainer._run_epoch(trainer.state, trainer.train_images[:cfg.batch_size],
                           trainer.train_labels[:cfg.batch_size])["loss"][-1].item()
        return time.perf_counter() - t

    prof = profile_run(torch, one_step, "vit training step",
                       {"flash_fwd_device_s": "flash_fwd",
                        "flash_bwd_device_s": "flash_bwd"}, top_n=12)
    if prof["device_busy_s"]:
        prof["flash_share_of_device"] = round(
            (prof["flash_fwd_device_s"] + prof["flash_bwd_device_s"])
            / prof["device_busy_s"], 4)
    emit(prof)

    # the trained weights under plain attention, at batch 8
    flash = trainer.model
    vanilla = get_model("vit", num_classes=10, device="cuda",
                        **{**VIT_KW, "attn": "vanilla"})
    vanilla.load_state_dict(flash.state_dict())
    batch = {"image": trainer.train_images[:8], "label": trainer.train_labels[:8]}
    out = {}
    for name, model in (("flash", flash), ("vanilla", vanilla)):
        loss, logits = steps_mod.make_loss_fn(model)(batch, train=True)
        params = dict(model.named_parameters())
        grads = torch.autograd.grad(loss, list(params.values()))
        out[name] = (logits.detach().float(), dict(zip(params, grads)))
    torch.cuda.synchronize()
    ref = out["vanilla"][0]
    logit_rel = ((out["flash"][0] - ref).abs().max() / ref.abs().max()).item()
    grad_rel = {key: ((out["flash"][1][key].float() - gv.float()).abs().max()
                      / gv.float().abs().max().clamp_min(1e-30)).item()
                for key, gv in out["vanilla"][1].items()}
    worst = max(grad_rel, key=grad_rel.get)
    grad_rec = {"phase": "vit_grad_check", "batch": 8, "logit_rel_err": logit_rel,
                "grad_rel_err_max": grad_rel[worst], "grad_rel_err_worst_param": worst,
                "grad_rel_err_median": statistics.median(grad_rel.values()),
                "params": len(grad_rel), "tol": VIT_GRAD_TOL}
    emit(grad_rec)
    check(all(math.isfinite(x) for x in grad_rel.values()), f"non-finite gradient {grad_rec}")
    check(logit_rel <= VIT_GRAD_TOL["logits"], f"flash vs vanilla logits: {grad_rec}")
    check(grad_rel[worst] <= VIT_GRAD_TOL["grad"], f"flash vs vanilla gradients: {grad_rec}")
    trainer.close()
    del trainer, flash, vanilla, out
    torch.cuda.empty_cache()
    return {**rec, "throughput": tp, "profile": prof, "grad_check": grad_rec}


def profile_run(torch, run, of: str, focus: dict, top_n: int = 8) -> dict:
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
                for us, key, n in rows[:top_n]]

    return {"phase": "profile", "of": of, "wall_s": round(wall, 4),
            "kernel_launches": sum(n for _, _, n in kernels),
            "device_busy_s": round(busy_s, 6) if kernels else None,
            "device_busy_share": round(busy_s / wall, 4) if kernels else None,
            **{k: round(v, 6) if kernels else None for k, v in focused.items()},
            "top_kernels": top(kernels), "top_ops": top(ops)}


# ---------------------------------------------------------------- data parallel

DP_PRESET = "mnist_cnn_dp8"  # the source paper's job: LeNet, global batch 1024, dp 8
DP_STEPS = 20  # dp2_gloo: fixed global batches
DP_LOSS_RTOL = 2e-3  # bf16 LeNet: per-step loss, dp=2 against dp=1
BN_REL = 2e-2  # ResNet-20 steps: tests/test_torch_resnet.py's BF16_REL
ZERO1_REL = 1e-7  # ZeRO-1 against the replicated update, where not bit-equal
# The whole update (every parameter's move) of a dp=2 run against dp=1's,
# as an L2 error relative to dp=1's update (rounding: ~2e-2 in bf16, ~5e-3
# in float32; LeNet, 20 Adam steps).  A coarse gate only: LeNet's largest
# tensor dominates the norm and Adam's step hardly moves when a gradient
# is scaled, so both planted faults pass it (0.019-0.024) and the loss
# gate; the float32 twin's per-tensor gates below are what catch them.
UPDATE_REL = 0.1
# The float32 twin, tensor by tensor, relative to each tensor's largest
# |entry|.  DP_GRAD_REL: the gradient the optimizer is handed on the first
# step (dp=2's all-reduced mean, dp=1's over the whole batch, from the same
# weights).  PARAM_REL_F32: the parameters after DP_STEPS steps.  Each
# limit sits between the clean twin's reading and the planted faults'
# (DP_FAULTS), which must fail both gates (PERF.md §6, PR 7: clean 4.6e-3
# and 0.053, the faults 0.72-1.0 and 0.36-0.78).
DP_GRAD_REL = 5e-2
PARAM_REL_F32 = 0.15


def max_rel(got: dict, ref: dict) -> float:
    """The largest error of any tensor over that tensor's largest |entry|."""
    return max(float((got[k].double() - ref[k].double()).abs().max()
                     / max(float(ref[k].double().abs().max()), 1e-30)) for k in ref)


def time_collectives(torch, trainer, reps: int = 20) -> dict:
    """Host wall ms of one step's gradient collectives on the trainer's own
    parameter buckets, to a synchronize: the bucketed all-reduce of plain
    data parallelism, and ZeRO-1's reduce-scatter then all-gather."""
    from distributed_tensorflow_ibm_mnist_tpu_torch.parallel import collectives as C

    params = list(trainer.model.parameters())
    out = {}
    for name, zero1 in (("all_reduce_ms", False), ("reduce_scatter_all_gather_ms", True)):
        lay = C.make_bucket_layout(params, trainer.dp if zero1 else 1)
        buckets = C.flatten_buckets(params, lay)

        def once():
            if not zero1:
                C.grouped_all_reduce_mean(buckets)
                return
            for shard in C.grouped_reduce_scatter_mean(buckets):
                C.all_gather(shard)

        once()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            once()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t) / reps * 1e3
        out["bucket_bytes"] = sum(b.numel() * b.element_size() for b in buckets)
    return out


def first_epoch_losses(trainer) -> list:
    """Capture the per-step losses of the trainer's next epoch."""
    caught, run = [], trainer._run_epoch

    def capture(*args, **kw):
        m = run(*args, **kw)
        caught.append(m["loss"].detach().cpu())
        return m

    trainer._run_epoch = capture
    return caught


def dp_config(get_preset, **replace):
    return get_preset(DP_PRESET).replace(fused_xent=True, synthetic=True, quiet=True,
                                         **replace)


def check_dp_xent_shape(shape: tuple, dp: int) -> None:
    """K1/K2 on a dp run see (global batch / dp, classes) logits a rank:
    that must be the shape phase_xent_kernels held them to."""
    check(tuple(shape) == DP_XENT_SHAPES[dp],
          f"dp={dp}: K1/K2 run at {tuple(shape)}, not the checked {DP_XENT_SHAPES[dp]}")


def phase_dp1_nccl(torch, fa, xent, port, tmp: Path) -> dict:
    """mnist_cnn_dp8 at dp=1 as one rank of a world-size-1 NCCL group
    (Trainer with a mesh: the bucketed all-reduce on every step) against
    the plain in-process Trainer: the first epoch's per-step losses must be
    bit-equal and K1 == K2 == steps on the mesh run; the difference of
    their steady step times is what the data-parallel wrapper costs."""
    Trainer, get_preset, torchrun, make_mesh = port
    cfg = dp_config(get_preset, dp=1)
    torchrun.bootstrap("nccl", f"file://{tmp}/nccl", 1, 0, "cuda:0")
    runs = {}
    try:
        mesh = make_mesh(dp=1)
        for name, kw in (("plain", {}), ("nccl", {"mesh": mesh})):
            trainer = Trainer(cfg, device="cuda:0", **kw)
            check_dp_xent_shape((cfg.batch_size // trainer.dp, trainer.num_classes), 1)
            caught = first_epoch_losses(trainer)
            reset_counts(fa, xent)
            summary = trainer.fit()
            counts = read_counts(fa, xent)
            tp = trainer.measure_throughput(epochs=2)
            runs[name] = {"summary": summary, "steps": trainer.state.step,
                          "launches": {k: counts[k] for k in ("xent_fwd", "xent_bwd")},
                          "losses": caught[0], "s_per_step": cfg.batch_size / tp[
                              "images_per_sec"], "images_per_sec_per_chip": tp[
                              "images_per_sec_per_chip"]}
            if name == "nccl":
                runs[name]["collectives"] = time_collectives(torch, trainer)
            trainer.close()
    finally:
        torchrun.shutdown()
    plain, nccl = runs["plain"], runs["nccl"]
    rec = {"phase": "dp", "sub": "dp1_nccl", "preset": DP_PRESET, "replace": {"dp": 1},
           "backend": "nccl", "world_size": 1, "batch_size": cfg.batch_size,
           "losses_bit_equal": bool(torch.equal(plain["losses"], nccl["losses"])),
           "first_epoch_steps": int(nccl["losses"].numel()),
           "launches": nccl["launches"], "steps": nccl["steps"],
           "collectives": nccl["collectives"],
           "wrapper_s_per_step": nccl["s_per_step"] - plain["s_per_step"]}
    for name, run in runs.items():
        rec[name] = {"time_to_target_s": run["summary"]["time_to_target_s"],
                     "best_test_accuracy": run["summary"]["best_test_accuracy"],
                     "epochs_run": run["summary"]["epochs_run"],
                     "images_per_sec_per_chip_fit": run["summary"]["images_per_sec_per_chip"],
                     "images_per_sec_per_chip": run["images_per_sec_per_chip"],
                     "s_per_step": run["s_per_step"]}
    emit(rec)
    check(rec["losses_bit_equal"], "dp=1 over NCCL: first-epoch losses differ from the "
          "plain Trainer's")
    check(nccl["launches"]["xent_fwd"] == nccl["launches"]["xent_bwd"] == nccl["steps"],
          f"dp1_nccl: xent launches {nccl['launches']} != steps {nccl['steps']}")
    for name, run in runs.items():
        check(run["summary"]["best_test_accuracy"] >= cfg.target_accuracy,
              f"{name}: {run['summary']['best_test_accuracy']} < {cfg.target_accuracy}")
    return rec


def drive_steps(torch, state, step, images, labels, batch: int, n: int):
    """``n`` steps of ``step(state, batch)`` on consecutive global batches
    of ``images``/``labels`` (on the card): the per-step losses and the
    host seconds a step, to a synchronize."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    losses = [step(state, {"image": images[i * batch:(i + 1) * batch],
                           "label": labels[i * batch:(i + 1) * batch]})["loss"]
              for i in range(n)]
    losses = torch.stack(losses).tolist()  # the fence
    return losses, (time.perf_counter() - t) / n


def float32_twin(torch, name: str, init: dict, cfg, total_steps: int, **model_kw):
    """The control run of a data-parallel check: model ``name`` computing
    in float32 from the state dict ``init``, with ``cfg``'s optimizer.
    float32 rounds 2**16 times finer than bf16, so what still separates
    dp=2 from dp=1 there is the path's arithmetic, not the dtype."""
    from distributed_tensorflow_ibm_mnist_tpu_torch.core.optim import make_optimizer
    from distributed_tensorflow_ibm_mnist_tpu_torch.core.state import TrainState
    from distributed_tensorflow_ibm_mnist_tpu_torch.models import get_model

    model = get_model(name, num_classes=10, device="cuda:0", dtype=torch.float32, **model_kw)
    model.load_state_dict(init)
    opt = make_optimizer(cfg, total_steps, list(model.parameters()))
    return model, TrainState(step=0, model=model, optimizer=opt,
                             data_generator=torch.Generator(device="cuda:0"))


def cpu_params(model) -> dict:
    return {k: v.detach().cpu() for k, v in model.named_parameters()}


def no_tf32(torch) -> None:
    """float32 products in float32 (phase_kernels sets the same for the
    script's own process)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def capture_grads(model, optimizer) -> dict:
    """Spy on ``optimizer.step``: the gradients it is handed (after the
    step's all-reduce), on the host in float64 by parameter name: every
    tensor's on the first step (``first``), the 1-D tensors' on every step
    (``steps``)."""
    names = [n for n, _ in model.named_parameters()]
    out = {"first": {}, "steps": {n: [] for n, p in model.named_parameters() if p.ndim == 1}}
    step = optimizer.step

    def spy(grads):
        keep = out["steps"] if out["first"] else names
        host = {n: g.detach().double().cpu() for n, g in zip(names, grads, strict=True)
                if n in keep}
        if not out["first"]:
            out["first"] = host
        for n, seen in out["steps"].items():
            seen.append(host[n])
        return step(grads)

    optimizer.step = spy
    return out


def fault_unreduced_bucket(buckets):
    """Planted fault: the smallest gradient bucket skips its all-reduce, so
    each rank keeps its own half-batch gradient for those tensors."""
    from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.collectives import (
        grouped_all_reduce_mean,
    )

    skip = min(range(len(buckets)), key=lambda i: buckets[i].numel())
    grouped_all_reduce_mean([b for i, b in enumerate(buckets) if i != skip])
    return buckets


def fault_sum_not_mean(buckets):
    """Planted fault: the gradient buckets summed across ranks, not averaged."""
    import torch.distributed as dist

    for b in buckets:
        dist.all_reduce(b)
    return buckets


DP_FAULTS = {"fault_unreduced_bucket": fault_unreduced_bucket,
             "fault_sum_not_mean": fault_sum_not_mean}


def float32_run(torch, make_step, init: dict, cfg, total_steps: int, images, labels,
                batch: int, fault=None) -> dict:
    """DP_STEPS steps of LeNet's float32 twin from ``init`` on consecutive
    global batches, the step from ``make_step(model, optimizer)``, its
    gradients captured; ``fault`` stands in for the gradient all-reduce
    (``core.steps.grouped_all_reduce_mean``) for the run."""
    from distributed_tensorflow_ibm_mnist_tpu_torch.core import steps as steps_mod

    model, state = float32_twin(torch, "lenet5", init, cfg, total_steps, dropout_rate=0.0)
    step = make_step(model, state.optimizer)
    grads = capture_grads(model, state.optimizer)
    reduce = steps_mod.grouped_all_reduce_mean
    steps_mod.grouped_all_reduce_mean = fault or reduce
    try:
        losses, _ = drive_steps(torch, state, step, images, labels, batch, DP_STEPS)
    finally:
        steps_mod.grouped_all_reduce_mean = reduce
    return {"losses": losses, "params": cpu_params(model), "grads": grads}


def dp2_rank(rank: int, images, labels) -> dict:
    """One rank of dp2_gloo: the fixed global batches through
    make_dp_train_step, replicated (then its float32 twin, clean and under
    each planted fault) and ZeRO-1, from the same seed."""
    import torch

    from distributed_tensorflow_ibm_mnist_tpu_torch.core.trainer import Trainer
    from distributed_tensorflow_ibm_mnist_tpu_torch.ops import xent
    from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.data_parallel import (
        make_dp_train_step,
    )
    from distributed_tensorflow_ibm_mnist_tpu_torch.utils.config import get_preset

    no_tf32(torch)
    cfg = dp_config(get_preset, dp=2, n_train=len(labels), n_test=1024,
                    model_kwargs={"dropout_rate": 0.0})
    images, labels = torch.from_numpy(images).cuda(), torch.from_numpy(labels).cuda()
    out = {}
    for name, sharded in (("replicated", False), ("sharded", True)):
        trainer = Trainer(cfg.replace(sharded_update=sharded), device="cuda:0")
        init = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        step = make_dp_train_step(trainer.model, trainer.state.optimizer, trainer.mesh,
                                  fused_xent=True, sharded_update=trainer._sharded)
        xent.softmax_xent.fwd_launches = xent.softmax_xent.bwd_launches = 0
        losses, s_per_step = drive_steps(torch, trainer.state, step, images, labels,
                                         cfg.batch_size, DP_STEPS)
        out[name] = {"losses": losses, "s_per_step": s_per_step,
                     "params": cpu_params(trainer.model),
                     "launches": [xent.softmax_xent.fwd_launches,
                                  xent.softmax_xent.bwd_launches]}
        if sharded:
            continue
        out["collectives"] = time_collectives(torch, trainer)

        def make_step(model, optimizer, mesh=trainer.mesh):
            return make_dp_train_step(model, optimizer, mesh, fused_xent=True)

        for run, fault in (("float32", None), *DP_FAULTS.items()):
            out[run] = float32_run(torch, make_step, init, cfg,
                                   trainer.steps_per_epoch * cfg.epochs, images, labels,
                                   cfg.batch_size, fault)
    return out


def worst_entry(got: dict, ref: dict, init: dict, ref_grads: dict) -> dict:
    """The parameter entry furthest off the reference's, relative to its
    tensor's largest |entry|: its error, the reference's move there and,
    for a 1-D tensor, its gradients over the run: the largest |gradient|
    the entry saw relative to the largest any entry of the tensor saw, and
    the run's largest gradient error there relative to the entry's own
    largest |gradient|."""
    import torch

    def rel(k):
        return ((got["params"][k].double() - ref[k].double()).abs().flatten()
                / max(float(ref[k].double().abs().max()), 1e-30))

    name = max(ref, key=lambda k: float(rel(k).max()))
    err = rel(name)
    i = int(err.argmax())
    top = max(float(ref[name].double().abs().max()), 1e-30)
    rec = {"tensor": name, "index": i, "rel_err": float(err[i]),
           "ref_move_rel": abs(float(ref[name].flatten()[i]) - float(
               init[name].flatten()[i])) / top}
    if name in ref_grads["steps"]:
        g_ref = torch.stack(ref_grads["steps"][name])  # (steps, entries)
        g_got = torch.stack(got["grads"]["steps"][name])
        peak = max(float(g_ref[:, i].abs().max()), 1e-300)
        rec["grad_rel_to_tensor"] = peak / float(g_ref.abs().max())
        rec["grad_err_rel"] = float((g_got[:, i] - g_ref[:, i]).abs().max()) / peak
    return rec


def rel_errs(got: dict, ref: dict, ref_losses: list, init: dict,
             ref_grads: dict | None = None) -> dict:
    """A run against its reference: the per-step loss error relative to
    each step's loss; the parameter error relative to each tensor's largest
    |entry|; and the error of the whole update (all parameters, minus
    ``init``) relative to the reference update's L2 norm.  With
    ``ref_grads`` (capture_grads): the first step's gradient error relative
    to each tensor's largest |entry|, and the worst parameter entry."""
    diff = sum(float((got["params"][k].double() - v.double()).square().sum())
               for k, v in ref.items())
    step = sum(float((v.double() - init[k].double().cpu()).square().sum())
               for k, v in ref.items())
    out = {"loss_max_rel_err": max(abs(a - b) / abs(b)
                                   for a, b in zip(got["losses"], ref_losses)),
           "param_max_rel_err": max_rel(got["params"], ref),
           "update_rel_l2_err": math.sqrt(diff / step)}
    if ref_grads is not None:
        first = ref_grads["first"]
        out["grad_rel_err_by_tensor"] = {k: max_rel({k: got["grads"]["first"][k]}, {k: v})
                                         for k, v in first.items()}
        out["grad_max_rel_err"] = max(out["grad_rel_err_by_tensor"].values())
        out["worst_entry"] = worst_entry(got, ref, {k: v.cpu() for k, v in init.items()},
                                         ref_grads)
    return out


def split_batch_grads(torch, steps_mod, init: dict, cfg, images, labels) -> dict:
    """The gradient gate's control: LeNet's float32 twin's gradient on the
    first global batch as the mean of its two halves' gradients, in this
    process with no collective, by parameter name on the host."""
    model, _ = float32_twin(torch, "lenet5", init, cfg, 1, dropout_rate=0.0)
    loss_fn = steps_mod.make_loss_fn(model, fused_xent=True)
    half = images.shape[0] // 2
    grads = [torch.autograd.grad(loss_fn({"image": images[i:i + half],
                                          "label": labels[i:i + half]})[0],
                                 list(model.parameters()))
             for i in (0, half)]
    return {n: (a.double() + b.double()).cpu() / 2
            for (n, _), a, b in zip(model.named_parameters(), *grads)}


def phase_dp2_gloo(torch, fa, xent, port, steps_mod, tmp: Path) -> dict:
    """mnist_cnn_dp8 at dp=2: two gloo ranks sharing cuda:0 take 20 fixed
    global batches (dropout off) through make_dp_train_step, replicated
    (bf16, and a float32 twin: clean and under each planted fault) and
    ZeRO-1, against the dp=1 step on the same batches in this process."""
    from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.collectives import (
        make_bucket_layout,
    )

    Trainer, get_preset, torchrun, _ = port
    batch = get_preset(DP_PRESET).batch_size
    n = DP_STEPS * batch
    ref = Trainer(dp_config(get_preset, dp=1, n_train=n, n_test=1024,
                            model_kwargs={"dropout_rate": 0.0}), device="cuda:0")
    check_dp_xent_shape((batch // 2, ref.num_classes), 2)
    init = {k: v.clone() for k, v in ref.model.state_dict().items()}
    step = steps_mod.make_train_step(ref.model, ref.state.optimizer, fused_xent=True)
    ref_bf16 = drive_steps(torch, ref.state, step, ref.train_images, ref.train_labels,
                           batch, DP_STEPS)[0], cpu_params(ref.model)
    ref32 = float32_run(torch, lambda m, o: steps_mod.make_train_step(m, o, fused_xent=True),
                        init, ref.config, ref.steps_per_epoch * ref.config.epochs,
                        ref.train_images, ref.train_labels, batch)
    t0 = time.perf_counter()
    ranks = torchrun.spawn(dp2_rank, 2, "gloo", "cuda:0", tmp / "gloo2",
                           args=(ref.train_images.cpu().numpy(),
                                 ref.train_labels.cpu().numpy()), timeout=600)
    spawn_s = time.perf_counter() - t0
    rep, sh = ranks[0]["replicated"], ranks[0]["sharded"]
    bf16 = rel_errs(rep, ref_bf16[1], ref_bf16[0], init)

    def against_ref32(run):
        return rel_errs(ranks[0][run], ref32["params"], ref32["losses"], init, ref32["grads"])

    f32 = against_ref32("float32")
    faults = {run: against_ref32(run) for run in DP_FAULTS}
    halves = split_batch_grads(torch, steps_mod, init, ref.config,
                               ref.train_images[:batch], ref.train_labels[:batch])
    f32["split_batch_control_by_tensor"] = {
        k: max_rel({k: halves[k]}, {k: v}) for k, v in ref32["grads"]["first"].items()}
    lay = make_bucket_layout(list(ref.model.parameters()), 1)
    skipped = min(range(lay.n_buckets), key=lambda b: lay.bucket_sizes[b])
    faults["fault_unreduced_bucket"]["tensors"] = [
        name for (name, _), slot in zip(ref.model.named_parameters(), lay.slots)
        if slot.bucket == skipped]
    zero1_equal = all(torch.equal(sh["params"][k], v) for k, v in rep["params"].items())
    ranks_equal = all(torch.equal(ranks[1][m]["params"][k], v)
                      for m in ("replicated", "sharded", "float32")
                      for k, v in ranks[0][m]["params"].items())
    rec = {"phase": "dp", "sub": "dp2_gloo", "preset": DP_PRESET,
           "replace": {"dp": 2, "dropout_rate": 0.0}, "backend": "gloo",
           "ranks_on": "cuda:0", "world_size": 2, "steps": DP_STEPS,
           "host_staging": False, "bf16": bf16, "float32": f32, "planted_faults": faults,
           "limits": {"loss": DP_LOSS_RTOL, "update": UPDATE_REL, "grad_f32": DP_GRAD_REL,
                      "param_f32": PARAM_REL_F32},
           "zero1_bit_equal": zero1_equal,
           "zero1_max_rel_err": max_rel(sh["params"], rep["params"]),
           "ranks_bit_equal": ranks_equal,
           "launches": {m: [r[m]["launches"] for r in ranks] for m in ("replicated", "sharded")},
           "s_per_step": {m: ranks[0][m]["s_per_step"] for m in ("replicated", "sharded")},
           "collectives": ranks[0]["collectives"], "spawn_s": spawn_s}
    emit(rec)
    for dt, e in (("bf16", bf16), ("float32", f32)):
        check(e["loss_max_rel_err"] <= DP_LOSS_RTOL and e["update_rel_l2_err"] <= UPDATE_REL,
              f"dp2_gloo {dt}: {e} off dp=1 (limits {DP_LOSS_RTOL}, {UPDATE_REL})")
    check(f32["grad_max_rel_err"] <= DP_GRAD_REL and f32["param_max_rel_err"] <= PARAM_REL_F32,
          f"dp2_gloo float32: {f32} off dp=1 (limits {DP_GRAD_REL}, {PARAM_REL_F32})")
    for run, e in faults.items():  # the gates must see what they are there to catch
        check(e["grad_max_rel_err"] > DP_GRAD_REL and e["param_max_rel_err"] > PARAM_REL_F32,
              f"dp2_gloo: {run} passes a float32 gate: {e}")
    check(zero1_equal or rec["zero1_max_rel_err"] <= ZERO1_REL,
          f"dp2_gloo: ZeRO-1 {rec['zero1_max_rel_err']} off")
    check(ranks_equal, "dp2_gloo: the ranks' parameters differ")
    for m, per_rank in rec["launches"].items():
        check(all(f == b == DP_STEPS for f, b in per_rank),
              f"dp2_gloo {m}: xent launches {per_rank} != {DP_STEPS} a rank")
    ref.close()
    return rec


def dp8_rank(rank: int) -> dict:
    """One of 8 ranks training mnist_cnn_dp8 as the preset has it."""
    from distributed_tensorflow_ibm_mnist_tpu_torch.core.trainer import Trainer
    from distributed_tensorflow_ibm_mnist_tpu_torch.ops import xent
    from distributed_tensorflow_ibm_mnist_tpu_torch.utils.config import get_preset

    t0 = time.perf_counter()
    trainer = Trainer(dp_config(get_preset), device="cuda:0")
    setup_s = time.perf_counter() - t0
    xent.softmax_xent.fwd_launches = xent.softmax_xent.bwd_launches = 0
    summary = trainer.fit()
    return {"summary": summary, "steps": trainer.state.step, "setup_s": setup_s,
            "launches": [xent.softmax_xent.fwd_launches, xent.softmax_xent.bwd_launches],
            "xent_shape": (trainer.config.batch_size // trainer.dp, trainer.num_classes)}


def phase_dp8_gloo_fit(torch, port, tmp: Path) -> dict:
    """mnist_cnn_dp8 as the preset has it (dp 8, global batch 1024): 8
    gloo ranks time-sharing the one card train to 0.99.  The rate is the
    card's under 8 processes, not a per-chip data-parallel rate."""
    _, get_preset, torchrun, _ = port
    t0 = time.perf_counter()
    ranks = torchrun.spawn(dp8_rank, 8, "gloo", "cuda:0", tmp / "gloo8", timeout=900)
    wall = time.perf_counter() - t0
    s = ranks[0]["summary"]
    rec = {"phase": "dp", "sub": "dp8_gloo_fit", "preset": DP_PRESET, "backend": "gloo",
           "ranks_on": "cuda:0 (8 ranks share one H100)", "world_size": 8,
           "summaries_equal": all(r["summary"] == s for r in ranks),
           "best_test_accuracy": s["best_test_accuracy"], "epochs_run": s["epochs_run"],
           "time_to_target_s": s["time_to_target_s"], "total_time_s": s["total_time_s"],
           "images_per_sec": s["images_per_sec"], "steps": ranks[0]["steps"],
           "launches": [r["launches"] for r in ranks],
           "setup_s": max(r["setup_s"] for r in ranks), "spawn_wall_s": wall}
    emit(rec)
    check(rec["summaries_equal"], "dp8: the ranks returned different summaries")
    for r in ranks:
        check_dp_xent_shape(r["xent_shape"], 8)
    check(s["best_test_accuracy"] >= 0.99, f"dp8: reached {s['best_test_accuracy']}, not 0.99")
    check(all(f == b == r["steps"] for r, (f, b) in zip(ranks, rec["launches"])),
          f"dp8: xent launches {rec['launches']} != steps")
    return rec


RESNET_DP_PRESET = "fashion_resnet20_dp32"
RESNET_DP_STEPS = 2
# The small-batch check of cross-replica BatchNorm's gradient: BN_SMALL
# rows a rank, where a rank's own channel reductions differ most from the
# global ones; float64 (float32 reads 7.8e-3 here, its rounding through
# BatchNorm's cancelling sums), against dp=1 on the 2 * BN_SMALL rows,
# tensor by tensor relative to the tensor's largest |gradient|, at the
# float64 limit of tests/test_torch_data_parallel.py.  It must fail with
# the backward's cross-rank sum planted away (0.51 in float32).
BN_SMALL = 8
BN_GRAD_REL = 1e-9
# ResNet-20's activations a rank at dp=2 (2048 images): (N, C, H = W)
BN_BWD_SHAPES = ((2048, 16, 28), (2048, 32, 14), (2048, 64, 7))
# the backward's aten kernels against its plain formulas, relative to the
# plain result's largest |entry|: the channel sums are float32 whatever
# the input; the input gradient is in the input's dtype
BN_BWD_TOL = {"sums": 1e-4, "torch.float32": 1e-4, "torch.bfloat16": 2e-2}


def check_bn_backward(torch) -> list:
    """Cross-replica BatchNorm's backward on CUDA (``batch_norm_backward_
    reduce`` and ``_elemt``) against its plain formulas, the CPU path, on
    the same CUDA tensors: at ResNet-20's per-rank activations under dp=2,
    channels-last, bf16 and float32, with the channel sums of two ranks."""
    from distributed_tensorflow_ibm_mnist_tpu_torch.models import resnet

    gen = torch.Generator(device="cuda").manual_seed(11)

    def rand(shape, dtype, scale=1.0, shift=0.0):
        t = torch.randn(shape, generator=gen, device="cuda") * scale + shift
        return t.to(dtype).contiguous(memory_format=torch.channels_last)

    def err(a, b):
        return float((a.double() - b.double()).abs().max()
                     / max(float(b.double().abs().max()), 1e-30))

    out = []
    for n, c, hw in BN_BWD_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            x = rand((n, c, hw, hw), dtype, scale=2.0, shift=0.5)
            g = rand((n, c, hw, hw), dtype, shift=0.1)
            mean, var = resnet.batch_moments(x)
            invstd = torch.rsqrt(var + 1e-5)
            weight = torch.rand((c,), generator=gen, device="cuda") + 0.5
            got = resnet._backward_reduce(g, x, mean, invstd, weight)
            ref = resnet.backward_reduce_plain(g, x, mean, invstd, weight)
            count, ranks = n * hw * hw, 2
            sums = (2 * ref[0], 2 * ref[1])  # two ranks' sums
            got_gx = resnet._backward_elemt(g, x, mean, invstd, weight, *sums, count, ranks)
            ref_gx = resnet.backward_elemt_plain(g, x, mean, invstd, weight, *sums, count,
                                                 ranks)
            rec = {"shape": [n, c, hw, hw], "dtype": str(dtype),
                   "sums_err": max(err(a, b) for a, b in zip(got, ref)),
                   "grad_input_err": err(got_gx, ref_gx), "grad_input_dtype": str(got_gx.dtype)}
            out.append(rec)
            check(rec["sums_err"] <= BN_BWD_TOL["sums"] and got_gx.dtype == dtype
                  and rec["grad_input_err"] <= BN_BWD_TOL[str(dtype)],
                  f"cross-replica BatchNorm backward: CUDA off its plain formulas {rec}")
    return out


def bn_grads(torch, init: dict, images, labels, **model_kw) -> dict:
    """ResNet-20 in float64 (parameters too) from the state dict ``init``:
    the training loss's gradient (train-mode BatchNorm) on one batch, by
    parameter name, on the host."""
    from distributed_tensorflow_ibm_mnist_tpu_torch.core.steps import make_loss_fn
    from distributed_tensorflow_ibm_mnist_tpu_torch.models import get_model

    model = get_model("resnet20", num_classes=10, device="cuda:0", dtype=torch.float64,
                      in_channels=1, **model_kw).double()
    model.load_state_dict(init)
    loss, _ = make_loss_fn(model)({"image": images, "label": labels}, train=True)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return {n: g.double().cpu() for (n, _), g in zip(model.named_parameters(), grads)}


def resnet_dp2_rank(rank: int, images, labels, n_train: int) -> dict:
    """One rank of resnet20_dp2_gloo: cross-replica BatchNorm steps, bf16
    and a float32 twin; then the float64 gradient on BN_SMALL rows a rank,
    clean and with the backward's cross-rank sum planted away."""
    import torch

    from distributed_tensorflow_ibm_mnist_tpu_torch.core.trainer import Trainer
    from distributed_tensorflow_ibm_mnist_tpu_torch.models import resnet
    from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.collectives import all_reduce_mean
    from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.data_parallel import (
        make_dp_train_step,
    )
    from distributed_tensorflow_ibm_mnist_tpu_torch.utils.config import get_preset

    no_tf32(torch)
    cfg = get_preset(RESNET_DP_PRESET).replace(dp=2, synthetic=True, quiet=True,
                                               n_train=n_train, n_test=1024)
    images, labels = torch.from_numpy(images).cuda(), torch.from_numpy(labels).cuda()
    trainer = Trainer(cfg, device="cuda:0")
    init = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    step = make_dp_train_step(trainer.model, trainer.state.optimizer, trainer.mesh)
    losses, _ = drive_steps(torch, trainer.state, step, images, labels, cfg.batch_size,
                            RESNET_DP_STEPS)
    out = {"bf16": {"losses": losses, "params": cpu_params(trainer.model),
                    "stats": {k: v.detach().cpu() for k, v in bn_buffers(trainer.model).items()}}}
    total = trainer.steps_per_epoch * cfg.epochs
    model, state = float32_twin(torch, "resnet20", init, cfg, total, in_channels=1,
                                axis_name="data")
    step = make_dp_train_step(model, state.optimizer, trainer.mesh)
    losses, _ = drive_steps(torch, state, step, images, labels, cfg.batch_size, RESNET_DP_STEPS)
    out["float32"] = {"losses": losses, "params": cpu_params(model),
                      "stats": {k: v.detach().cpu() for k, v in bn_buffers(model).items()}}
    rows = slice(rank * BN_SMALL, (rank + 1) * BN_SMALL)
    reduce = resnet.all_reduce_sum
    out["small"] = {}
    for run in ("clean", "fault_per_rank_backward"):
        if run != "clean":  # each rank's own channel sums, as if every rank's were alike
            resnet.all_reduce_sum = lambda t, n=trainer.dp: t * n
        try:
            grads = bn_grads(torch, init, images[rows], labels[rows], axis_name="data")
        finally:
            resnet.all_reduce_sum = reduce
        out["small"][run] = dict(zip(grads, all_reduce_mean(list(grads.values()))))
    return out


def phase_resnet20_dp2_gloo(torch, port, steps_mod, tmp: Path) -> dict:
    """fashion_resnet20_dp32 at dp=2 and full width (global batch 4096,
    cross-replica BatchNorm): the backward's CUDA kernels against their
    plain formulas; two gloo ranks on cuda:0 take two fixed global batches
    (bf16, and a float32 twin) against dp=1 on the same batches here; and
    the float64 gradient on a small batch, clean and with a planted fault,
    against dp=1's."""
    Trainer, get_preset, torchrun, _ = port
    bn_backward = check_bn_backward(torch)
    batch = get_preset(RESNET_DP_PRESET).batch_size
    n = RESNET_DP_STEPS * batch
    ref = Trainer(get_preset(RESNET_DP_PRESET).replace(dp=1, synthetic=True, quiet=True,
                                                       n_train=n, n_test=1024),
                  device="cuda:0")
    init = {k: v.clone() for k, v in ref.model.state_dict().items()}
    refs = {}
    step = steps_mod.make_train_step(ref.model, ref.state.optimizer)
    refs["bf16"] = (drive_steps(torch, ref.state, step, ref.train_images, ref.train_labels,
                                batch, RESNET_DP_STEPS)[0], cpu_params(ref.model),
                    {k: v.detach().cpu() for k, v in bn_buffers(ref.model).items()})
    total = ref.steps_per_epoch * ref.config.epochs
    model, state = float32_twin(torch, "resnet20", init, ref.config, total, in_channels=1)
    step = steps_mod.make_train_step(model, state.optimizer)
    refs["float32"] = (drive_steps(torch, state, step, ref.train_images, ref.train_labels,
                                   batch, RESNET_DP_STEPS)[0], cpu_params(model),
                       {k: v.detach().cpu() for k, v in bn_buffers(model).items()})
    small_ref = bn_grads(torch, init, ref.train_images[:2 * BN_SMALL],
                         ref.train_labels[:2 * BN_SMALL])
    ranks = torchrun.spawn(resnet_dp2_rank, 2, "gloo", "cuda:0", tmp / "resnet2",
                           args=(ref.train_images.cpu().numpy(),
                                 ref.train_labels.cpu().numpy(), n), timeout=600)
    errs = {}
    for dt in ("bf16", "float32"):
        got = ranks[0][dt]
        errs[dt] = {**rel_errs(got, refs[dt][1], refs[dt][0], init),
                    "stats_max_rel_err": max_rel(got["stats"], refs[dt][2]),
                    "stats_bit_equal_across_ranks": all(
                        torch.equal(got["stats"][k], ranks[1][dt]["stats"][k])
                        for k in got["stats"]),
                    "losses": got["losses"], "dp1_losses": refs[dt][0]}
    small = {run: max_rel(g, small_ref) for run, g in ranks[0]["small"].items()}
    rec = {"phase": "dp", "sub": "resnet20_dp2_gloo", "preset": RESNET_DP_PRESET,
           "replace": {"dp": 2}, "backend": "gloo", "ranks_on": "cuda:0", "world_size": 2,
           "batch_size": batch, "steps": RESNET_DP_STEPS, "bn_layers": len(refs["bf16"][2]) // 2,
           **errs, "bn_backward_cuda_vs_plain": bn_backward,
           "small_batch_grad_max_rel_err": {"rows_a_rank": BN_SMALL, **small,
                                            "limit": BN_GRAD_REL}}
    emit(rec)
    for dt, e in errs.items():
        check(e["stats_bit_equal_across_ranks"], f"resnet20 dp2 {dt}: running statistics "
              "differ across ranks")
        check(e["loss_max_rel_err"] <= BN_REL and e["stats_max_rel_err"] <= BN_REL
              and e["update_rel_l2_err"] <= UPDATE_REL,
              f"resnet20 dp2 {dt}: {e} past {BN_REL} / {UPDATE_REL}")
    check(errs["float32"]["param_max_rel_err"] <= BN_REL,
          f"resnet20 dp2: float32 parameters {errs['float32']['param_max_rel_err']} off dp=1")
    check(small["clean"] <= BN_GRAD_REL < small["fault_per_rank_backward"],
          f"resnet20 dp2: small-batch gradient {small} against the limit {BN_GRAD_REL}")
    ref.close()
    return rec


def phase_dp(torch, fa, xent, port, steps_mod) -> dict:
    """The data-parallel phases (Trainer over torch.distributed)."""
    import tempfile

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_dp_"))
    try:
        return {"dp1_nccl": phase_dp1_nccl(torch, fa, xent, port, tmp),
                "dp2_gloo": phase_dp2_gloo(torch, fa, xent, port, steps_mod, tmp),
                "dp8_gloo_fit": phase_dp8_gloo_fit(torch, port, tmp),
                "resnet20_dp2_gloo": phase_resnet20_dp2_gloo(torch, port, steps_mod, tmp)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# Each kernel's design as it stands: its bf16 instances on the tensor
# cores (mma.sync on cp.async-fed tiles, or wgmma on TMA-fed tiles), or
# "scalar" for CUDA-core float32 FMAs.  The flash kernels' float32
# instances stay scalar (the tensor cores have no float32 product that
# keeps the 1e-4 checks).
MMA_SYNC = "tensor-core bf16: mma.sync on cp.async-fed tiles"
DESIGN = {"flash_fwd": MMA_SYNC, "flash_bwd_fused": MMA_SYNC, "flash_bwd_grouped": MMA_SYNC,
          "flash_bwd_dkv": MMA_SYNC,
          "flash_bwd_dq": "tensor-core bf16: wgmma on TMA-fed tiles, setmaxnreg",
          "xent_fwd": "scalar", "xent_bwd": "scalar"}


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
        from distributed_tensorflow_ibm_mnist_tpu_torch.launch import torchrun
        from distributed_tensorflow_ibm_mnist_tpu_torch.models import get_model
        from distributed_tensorflow_ibm_mnist_tpu_torch.ops import _build
        from distributed_tensorflow_ibm_mnist_tpu_torch.ops import flash_attention as fa
        from distributed_tensorflow_ibm_mnist_tpu_torch.ops import xent
        from distributed_tensorflow_ibm_mnist_tpu_torch.parallel.mesh import make_mesh
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
    split = phase_lm_split(torch, fa, xent, (Trainer, RunConfig))
    vit_kernels = phase_vit_kernels(torch, fa)
    phase_resnet(torch, fa, xent, (Trainer, get_preset), "fashion_resnet20_dp32")
    phase_resnet(torch, fa, xent, (Trainer, get_preset), "cifar_resnet50_dp32", grad_accum=4)
    vit = phase_vit(torch, fa, xent, (Trainer, RunConfig), get_model, steps_mod)
    dp = phase_dp(torch, fa, xent, (Trainer, get_preset, torchrun, make_mesh), steps_mod)

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
                "max_rel_err": bwd_errs[name][1], "max_row_rel_err": bwd_errs[name][2],
                "plain_shape": rec["plain_shape"],
                "plain_note": rec["plain_note"], "library_call": rec["library_call"]}

    counts = training["launches"]
    timing_keys = ("shape", "ms", "plain_ms", "plain_shape", "library_ms", "bound_ms",
                   "bound_by")

    def on_vit(name, errs):
        """A kernel at the ViT's attention shape; launches on the ViT run."""
        return {**{k: vit_kernels["timed"][name][k] for k in timing_keys},
                "causal": False, "launches": vit["launches"][name], **errs}

    def on_vit_xent(name):
        """K1/K2 at the ViT step's (512, 10): held, timed, launches on the ViT run."""
        rec = next(r for r in xk["timed"][name] if tuple(r["shape"]) == VIT_XENT_SHAPE)
        return {**{k: rec[k] for k in ("shape", "ms", "plain_ms", "library_ms", "bound_ms",
                                       "bound_by")},
                "launches": vit["launches"][name],
                "max_abs_err": xk["at_shape"][VIT_XENT_SHAPE][name]}

    def dp_launches(i):
        """K1 (i=0) or K2 (1) on the data-parallel runs: the launches of
        the dp1_nccl mesh run, and per rank of the dp2 (replicated) and
        dp8 runs, each beside the per-rank shape it runs at and the
        kernel's error there (its check in phase_xent_kernels)."""
        name = ("xent_fwd", "xent_bwd")[i]
        launches = {1: dp["dp1_nccl"]["launches"][name],
                    2: [r[i] for r in dp["dp2_gloo"]["launches"]["replicated"]],
                    8: [r[i] for r in dp["dp8_gloo_fit"]["launches"]]}
        return {key: {"shape": DP_XENT_SHAPES[n], "launches": launches[n],
                      "max_abs_err": xk["at_shape"][DP_XENT_SHAPES[n]][name]}
                for n, key in ((1, "dp1_nccl"), (2, "dp2_gloo_per_rank"),
                               (8, "dp8_gloo_per_rank"))}

    k3_entry = entry("flash_fwd", "flash_fwd.cu", "ops/flash_attention.py:208",
                     serving["flash_launches"], k3["max_abs_err"], k3["timed"], "by_seq")
    # K3 at the LM training shape, launches on the LM training run
    k3_entry["lm_training"] = {**{k: flash_timed["flash_fwd"][k] for k in timing_keys},
                               "launches": lm["launches"]["flash_fwd"]}
    k3_entry["vit_training"] = on_vit("flash_fwd", vit_kernels["fwd_err"])
    k4_entry = bwd_entry("flash_bwd_fused", "ops/flash_attention.py:340",
                         lm["launches"]["flash_bwd_fused"])
    k4_entry["vit_training"] = on_vit("flash_bwd_fused", dict(zip(
        ("max_abs_err", "max_rel_err", "max_row_rel_err"), vit_kernels["bwd_err"])))
    print(json.dumps({"kernels": [
        # K3 at S=512, the largest serving bucket; launches on the serving run
        k3_entry,
        # K4 on the bench_lm8k run (and the ViT's), K5 on the head_dim-128
        # run at S=8192; K6a and K6b on the split route where the JAX rule
        # takes it (S=32768)
        k4_entry,
        bwd_entry("flash_bwd_grouped", "ops/flash_attention.py:399",
                  routes["grouped"]["launches"]["flash_bwd_grouped"]),
        {**bwd_entry("flash_bwd_dkv", "ops/flash_attention.py:304",
                     split["launches"]["flash_bwd_dkv"]),
         "forced_split_launches": routes["split"]["launches"]["flash_bwd_dkv"]},
        {**bwd_entry("flash_bwd_dq", "ops/flash_attention.py:460",
                     split["launches"]["flash_bwd_dq"]),
         "forced_split_launches": routes["split"]["launches"]["flash_bwd_dq"],
         "lm_split": {**{k: split["kernels"]["timed"][k] for k in (
             "shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
             "launches": split["launches"]["flash_bwd_dq"],
             "rel_err_vs_fused_dq": split["kernels"]["rel_err"],
             "row_rel_err_vs_fused_dq": split["kernels"]["row_rel_err"]}},
        # K1/K2 at (128, 10), the LeNet step's; launches on the LeNet run
        # (and at (512, 10) on the ViT run)
        {**entry("xent_fwd", "xent.cu", "ops/xent.py:40", counts["xent_fwd"],
                 xk["max_abs_err"]["xent_fwd"], xk["timed"]["xent_fwd"], "by_shape"),
         "vit_training": on_vit_xent("xent_fwd"), "dp_launches": dp_launches(0)},
        {**entry("xent_bwd", "xent.cu", "ops/xent.py:53", counts["xent_bwd"],
                 xk["max_abs_err"]["xent_bwd"], xk["timed"]["xent_bwd"], "by_shape"),
         "vit_training": on_vit_xent("xent_bwd"), "dp_launches": dp_launches(1)},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                             "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
