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
3b. serving_features — the engine's decode path as the JAX engine runs
   it, on the same model, 8 slots, max_len 1024, 32 new tokens a request:
   (a) phase 3's 16 requests greedy at decode_ahead 1, 4 and 8 (streams
   identical to k=1, K3 == depth x admissions; the busy share of one
   more profiled run each); (b) 8 greedy + 8 sampled requests
   (temperature 0.8, top-k 40, top-p 0.9, min-p 0.05, seed = request
   index) replayed identically at k=1, k=8 and paged, the Threefry key
   bits on CUDA equal to the CPU's, and the pick on CUDA equal to the
   CPU's on the same logits; (c) 16 prompts sharing a 384-token head on
   the paged cache (page 16) with the radix trie: K3 == depth x
   whole-prompt prefills, radix hit tokens > 0, peak pages x 16 < slots x
   max_len, and greedy streams identical to the dense engine's on a
   float32 twin of the weights (in bf16 the extend's attention rounds
   otherwise than K3, so near-ties flip: the agreement and each first
   divergence's top-2 logit gap are recorded); (d) 8 prompts then the
   same 8 again through the 64 MiB prefix cache: streams identical to
   the cache off, K3 == depth x misses.  Compared configurations are
   served in the order A B .. B A and timed twice;
3c. serving_spec_quant_chunk — the rest of the single-card engine on the
   same model, slots and max_len: (e) phase 3's requests under
   ``quant="int8"`` and with the int8 KV cache, dense and paged (K3 ==
   depth x whole-prompt prefills; the teacher-forced logit drift on JAX's
   protocol within ``QUANT_DRIFT``; the teacher-forced greedy pick agrees
   with bf16's >= 0.9 and every stream that leaves bf16's does so at a
   top-2 gap inside the weights' drift bound; the float32 twin's int8
   paged streams identical to int8 dense; the int8-cache attention, held
   at every call against a float64 reference on the same cache, differs
   in at most ``INT8_ATTN_MISMATCH`` of its outputs, dense and paged; two
   planted faults, ``fault_p_bf16`` (the cache's known trap) and
   ``fault_paged_v_scale``, must each fail its gate, their other readings
   recorded; weight and KV bytes, busy share); (f) ``speculative="ngram"`` at draft_len 3 and 7 on
   ``scripts/bench_speculative.py``'s motif and control prompt sets, 16 x
   64 tokens, against decode_ahead = draft_len + 1 (K3 == depth x
   admissions; the float32 twin's spec streams identical to its plain
   k=1 streams, dense at 3 and paged at 7; bf16 agreement and first
   divergences recorded), a sampled mix replayed dense and paged, and the
   accept uniforms CUDA == CPU; (g) ``prefill_chunk`` 64 and 128 on 8
   prompts of 600-896 tokens among the 16 short ones (K3 == 0, the chunk
   count exact, the pool drained, the float32 twin's streams identical to
   a whole-prompt engine with a 1024 bucket; long-prompt TTFT, the short
   requests' decode tokens/s, chunk_stall_s);
4. xent kernels — the softmax cross-entropy forward (K1) and backward (K2)
   against their plain versions at the shapes of every path that launches
   them (LeNet's (128, 10), the ViT's (512, 10), the dp runs' per-rank
   (1024, 10), (512, 10) and (128, 10): ``DP_XENT_SHAPES``) and the edge
   cases, then timed at those and (2048, 10) beside their bound and a
   PyTorch library call, and an empty kernel (``csrc/launch_floor.cu``)
   with the same timer: the card's launch floor;
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
15b. fault_tolerant_training — the checkpoint, resume, preemption,
   chaos, stream-input, remat and profiling layer, one line per
   sub-phase, on the card's name and power limit, with cuDNN held to
   deterministic algorithms (so two runs give the run-to-run floor) and
   the data rendered once for the phase: (a) ``mnist_lenet_1chip`` +
   ``fused_xent`` (60k/10k, batch 128, no early stop) for 3 epochs with
   a checkpoint each, twice (the floor: the largest difference of
   parameters and Adam moments, and of the per-epoch losses), then 1
   epoch plus a resume for 2 in a fresh Trainer: within the floor; a
   resume without Adam's moments and one with the data order restarted
   at epoch 0 (``FT_FAULTS``) must each fail that gate; K1 == K2 ==
   the steps of every fit; (c) the newest step's largest file truncated:
   ``restore_checkpoint()`` lands on the step before and lists the reason;
   a ``train-step`` NaN plan under ``run_with_recovery`` ends within the
   floor of the fault-free run; (d) ``input_mode="stream"`` through the
   native Prefetcher at ``stream_chunk`` 8 and 1: the first epoch's
   per-step losses equal device mode's on the same permutation (to the
   floor), 0.99 reached, K1 == K2 == steps; images/s/chip of stream and
   device mode (``measure_throughput``), the busy share and the H2D
   device time per chunk (a profiled stream epoch), and the native and
   numpy renders of 60k images; (e) ``cifar_resnet50_dp32`` (dp=1, batch
   4096) for 3 steps plain at grad_accum 4 and 1, ``remat=True`` and
   ``remat="blocks"`` at 1: peak memory, s/step, and each remat run's
   first-step loss and BatchNorm statistics equal to the plain grad_accum
   1 step's (to the floor of two plain forwards); ``bench_lm8k`` 4 steps
   plain and with ``block_remat``: tokens/s/chip, peak memory, K3 ==
   depth x (steps + eval batches) plain and depth x (2 steps + eval
   batches) under remat (the recompute runs K3 again), K4 == depth x
   steps; (f) ``profile_dir`` on a 2-epoch LeNet fit (8192 training
   images): a Chrome trace with ``xent_fwd`` events; (b) a child process
   (``chip_smoke.py --preempt-child DIR``) trains the preset under a
   ``PreemptionHandler`` and gets a real SIGTERM after its first epoch
   record: exit 0, ``preempted``, one checkpoint; the CLI's ``--resume``
   in a fresh process reaches 0.99 from it; the save's wall time and the
   time it blocked the loop;
15b. serving_tier — the host serving tier at the serving LM's full width
   (vocab 256, dim 512, depth 4, 8 heads), 3 replicas on the card, each
   with 8 slots, max_len 1024, paged KV (page 16) with the radix trie and
   decode_ahead 2 (``scripts/router_soak.py``'s story and
   ``scripts/bench_slo.py``'s open loop): (a) ``Trainer`` fits the LM in
   float32 on the retrieval set (vocab 256, S=512) for one epoch with a
   checkpoint (W1), K4 == depth x steps and no other backward kernel; (b)
   a seeded plan (a ``router-dispatch`` fault, a ``serving-step`` kill
   calibrated onto replica 1's second cluster step) over a wave of 10:
   every output token-identical to one fault-free engine, streams
   exactly-once, one failover, ``restart`` respawns it (spawn seconds
   recorded), K3 == depth x whole-prompt prefills (radix hits take the
   extend); (c) the trainer resumes for W2; with bridge requests in
   flight ``WeightWatcher.poll()`` returns None while a ``weight-swap``
   fault aborts one swap, then W2's step: zero drops, every bridge output
   W1's or W2's reference, wave 2 W2's on every replica; (d) the shared
   tracer's export validates clean with per-replica tracks, the failover
   and swap instants and no open span; (e) ``ServingDaemon`` with
   ``DeadlineAwarePolicy`` over a fresh bf16 tier: closed-loop service
   rate R, then Poisson open loops at 0.5 R and 1.5 R with TTFT SLOs of
   20 and 4 x the calibrated p50 (goodput, TTFT p50/p99, tokens/s, shed
   count), a ``daemon-pump`` raise and a wedge each failed over with zero
   drops; every leg conserved exactly, exactly-once, drained with no open
   span and every pool at refcount zero, no build or load after the
   prewarm; bf16 agreement with one engine recorded; (f) the bf16 wave
   with the tracer and telemetry off and on in 3 interleaved pairs: each
   ratio and the spread (recorded, not gated: host noise);
15c. serving_edge — the tier's edge at the same full width (paged KV,
   page 16, the radix trie, 8 slots a replica, max_len 1024): (a) three
   bf16 replicas behind the daemon and a ``FrontDoor`` on 127.0.0.1:
   unary, SSE and ``daemon.stream`` token-identical, greedy and
   seeded-sampled; the wire's TTFT and tokens/s against ``daemon.stream``
   on one wave (ABBA); a ``daemon-pump`` raise while SSE clients stream
   (every stream ends done, exactly once); a 4-deep admission bound under
   a flood (429/503 with an integer ``Retry-After``, conservation exact);
   one ``/metrics`` scrape with the front door's and the tier's counters;
   every leg drained with no open span and every pool at refcount zero,
   K3 == depth x whole-prompt prefills, no build or load after the
   prewarm; (b) a child (``chip_smoke.py --serve-child DIR``) serves a
   float32 tier with a journal (fsync ``always``), the front door and
   fsync'd telemetry, and is SIGKILLed while keyed SSE clients stream;
   ``recover`` rebuilds the tier here, each client retries with its
   ``Idempotency-Key`` and ``Last-Event-ID``: nothing lost, no gap, no
   divergent duplicate, every stitched transcript's digest the uncrashed
   reference's; a torn ``retired`` record drops exactly one record and the
   request replays to done; the journal's append share, per-append cost
   and one fsync at each fsync policy (the interval policy's share gated at
   2%); (c) an ``Autoscaler`` over a one-replica bf16 daemon: a backlog
   scales it up, a lull retires a replica (drain first), a second backlog
   brings it back warm: nothing dropped, spawn seconds recorded, no build
   or load; (d) ``prefill(1) + decode(2)`` against ``3 x both`` on
   ``scripts/bench_disagg.py``'s drip (12 long 448-token prompts one a
   router step, 6 short ones every third): float32 streams identical,
   ``handoffs == requests``, K3 on the prefill replica only (each
   replica's launches counted around its own step), short TTFT p99 in
   router steps loaded <= 1.15 x control, a ``kv-handoff`` fault on the
   first delivery (exactly-once, pools at refcount zero), each packet's
   pages, bytes, read and install milliseconds, bf16 agreement recorded;
16. the ``kernels`` line: per kernel, its design, its launches on its
   path's run (serving for K3, the LM runs for K4-K6, LeNet training for
   K1/K2; the ViT run's for K1-K4, the ``dp`` runs' for K1/K2, each
   ``serving_features`` and ``serving_spec_quant_chunk`` run's for K3,
   the ``fault_tolerant_training`` runs' for K1-K4, the
   ``serving_tier`` runs' for K3 and K4 and the ``serving_edge`` runs' for
   K3, by replica role on the disaggregated tier, beside them),
   largest error, times
   and bound; and ``launch_floor_ms``;
17. the last line: ``{"ok": true, "device": {...}}``.

Every launch counter is set to 0 just before a path is driven and read
just after; the launches made to compare or time a kernel are not counted.
Every synthetic split (of the script, its ranks and child processes) is
rendered by the native C++ renderer (``native/dtm.cpp``) unless
``DTM_DATA_BACKEND`` is set (``DTM_DATA_BACKEND=numpy``: the numpy renderer).

Any failed check raises, so the exit code is nonzero and the last line is
never printed.  Without a CUDA card, or without the port beside this
script, it exits nonzero before printing any result.
"""

from __future__ import annotations

import gc
import importlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
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


def nvidia_smi_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""


def phase_device(torch, build) -> dict:
    smi_line = nvidia_smi_line()
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
           "data_backend": os.environ.get("DTM_DATA_BACKEND", "numpy"),
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


def serving_prompts(torch) -> list:
    """The serving phases' 16 prompts: lengths 16-512, tokens 1-255, seeded."""
    rng = torch.Generator().manual_seed(1)
    lens = torch.randint(16, 513, (16,), generator=rng).tolist()
    return [torch.randint(1, 256, (n,), generator=rng).tolist() for n in lens]


def phase_serving(torch, fa, xent, port) -> dict:
    get_model, InferenceEngine, make_prefill, make_generator = port
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = get_model("causal_lm", dtype=torch.bfloat16, generator=gen, **MODEL_KW)
    prompts = serving_prompts(torch)
    lens = [len(p) for p in prompts]

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


# ------------------------------------------------------- serving features

FEATURE_BUCKETS = (64, 128, 256, 512)
FEATURE_SLOTS, FEATURE_MAX_LEN, FEATURE_NEW = 8, 1024, 32
FEATURE_K = (1, 4, 8)  # decode_ahead of sub-run (a)
PAGE = 16  # kv_page_size of sub-runs (b) and (c)
SHARED_PREFIX = 384  # sub-run (c): the prompts' common head
PREFIX_CACHE_BYTES = 64 << 20  # sub-run (d): 8 rows of 8 MiB would not all fit
SAMPLED = dict(temperature=0.8, top_k=40, top_p=0.9, min_p=0.05)
KEY_SEEDS = (0, 1, (1 << 32) + 5, (1 << 64) - 1)
KEY_INDICES = (0, 1, 7, 31, 12345, (1 << 31) + 3)


def serve_features(torch, fa, xent, engine_cls, model, prompts, sampling=None,
                   profile_of=None, max_new=FEATURE_NEW, buckets=FEATURE_BUCKETS,
                   **kw) -> dict:
    """Serve ``prompts`` (``max_new`` new tokens each, 32 by default)
    through a fresh engine; the launch counters are zeroed just before the
    run and read just after.  ``profile_of`` adds one more identical run
    under torch.profiler (device activity only)."""
    def run():
        eng = engine_cls(model, slots=FEATURE_SLOTS, max_len=FEATURE_MAX_LEN,
                         buckets=buckets, **kw)
        reqs = [eng.submit(p, max_new=max_new,
                           sampling=None if sampling is None else sampling[i])
                for i, p in enumerate(prompts)]
        torch.cuda.synchronize()
        reset_counts(fa, xent)
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return eng, reqs, wall, read_counts(fa, xent)["flash_fwd"]

    eng, reqs, wall, launches = run()
    check(all(r.status == "done" and len(r.generated) == max_new for r in reqs),
          f"not every request finished with {max_new} tokens: "
          f"{[(r.status, len(r.generated)) for r in reqs]}")
    s = eng.stats.summary()
    admissions = sum(r.admit_t is not None for r in reqs)
    rec = {"wall_s": round(wall, 4), "ttft_s_p50": s["ttft_s_p50"],
           "ttft_s_p99": s["ttft_s_p99"], "tokens_per_sec": s["tokens_per_sec"],
           "decode_tokens_per_s": round((s["tokens_generated"] - admissions)
                                        / s["decode_s"], 3),
           "prefill_s": s["prefill_s"], "decode_s": s["decode_s"],
           "window_readback_s": s["window_readback_s"], "n_windows": s["n_windows"],
           "window_waste_frac": s["window_waste_frac"], "admissions": admissions,
           "flash_launches": launches}
    for key in ("prefix_hits", "prefix_misses", "radix_hits", "radix_misses",
                "radix_hit_tokens", "kv_pages_peak", "n_sampled_requests",
                "drafted_tokens", "accepted_tokens", "accept_rate",
                "n_prefill_chunks", "chunk_stall_s", "chunk_stall_frac"):
        if s[key]:
            rec[key] = s[key]
    if eng.speculative is not None:
        rec["useful_tokens_per_window"] = s["useful_tokens_per_window"]
    if profile_of is not None:
        prof = profile_run(torch, lambda: run()[2], profile_of,
                           {"flash_fwd_device_s": "flash_fwd"}, host_ops=False)
        emit(prof)
        rec["device_busy_share"] = prof["device_busy_share"]
    return {"rec": rec, "streams": [list(r.generated) for r in reqs],
            "summary": s, "reqs": reqs, "engine": eng}


# the host clock drifts within a call (~30% between calls, PERF.md §5), so
# the configurations a sub-run compares are served in the order A B .. B A
# and each timing is reported as [first, second]
TIMING_KEYS = ("wall_s", "ttft_s_p50", "ttft_s_p99", "tokens_per_sec",
               "decode_tokens_per_s", "prefill_s", "decode_s", "window_readback_s")


def serve_abba(serve, configs: dict) -> dict:
    """Serve each named configuration twice, in the order A B .. B A; a
    rerun must give the same streams (the gates read the first run)."""
    runs = {name: serve(**kw) for name, kw in configs.items()}
    for name in reversed(configs):
        again = serve(**configs[name])
        check(again["streams"] == runs[name]["streams"],
              f"{name}: serving the same requests again changed the streams")
        rec = runs[name]["rec"]
        for key in TIMING_KEYS:
            rec[key] = [rec[key], again["rec"][key]]
    return runs


def bf16_ulps(gap: float, top: float) -> float:
    """A logit gap in bf16 ulps at the top logit's magnitude."""
    return gap / 2.0 ** (math.floor(math.log2(max(abs(top), 2.0 ** -126))) - 7)


def divergences(torch, make_prefill, model, prompts, want, got) -> list:
    """For each stream of ``got`` that leaves ``want``: where, and the top-2
    gap of ``model``'s logits there (a B=1 prefill of the prompt and
    ``want``'s tokens before it), in bf16 ulps."""
    out = []
    for i, (p, a, b) in enumerate(zip(prompts, want, got)):
        if a == b:
            continue
        j = next(t for t, (x, y) in enumerate(zip(a, b)) if x != y)
        _, last = make_prefill(model, FEATURE_MAX_LEN)(
            torch.tensor([p + a[:j]], device="cuda"))
        top = last[0].topk(2).values.tolist()
        out.append({"request": i, "position": j, "want": a[j], "got": b[j],
                    "gap": top[0] - top[1], "ulps": bf16_ulps(top[0] - top[1], top[0])})
    return out


def phase_serving_features(torch, fa, xent, port) -> dict:
    """The engine's decode path as the JAX engine runs it, at phase_serving's
    width: (a) greedy at decode_ahead 1, 4 and 8; (b) a greedy + sampled mix
    replayed across k and layout, with the key schedule and the pick held
    CUDA against CPU; (c) the paged cache with the radix trie on prompts
    sharing a 384-token head; (d) the prefix cache on repeated prompts."""
    get_model, engine_cls, make_prefill, SamplingParams, ts, pick_rows = port
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = get_model("causal_lm", dtype=torch.bfloat16, generator=gen, **MODEL_KW)
    prompts = serving_prompts(torch)
    serve = lambda *a, **kw: serve_features(torch, fa, xent, engine_cls, *a, **kw)  # noqa: E731
    out = {}

    # (a) greedy, dense, decode_ahead 1 / 4 / 8
    runs = serve_abba(serve, {k: dict(model=model, prompts=prompts, decode_ahead=k)
                              for k in FEATURE_K})
    for k in FEATURE_K:  # one more run of each under the profiler: busy share
        runs[k]["rec"]["device_busy_share"] = serve(
            model, prompts, decode_ahead=k,
            profile_of=f"serving_features[a,k={k}]")["rec"]["device_busy_share"]
    for k, run in runs.items():
        check(run["streams"] == runs[1]["streams"],
              f"(a) decode_ahead={k} streams differ from decode_ahead=1")
        check(run["rec"]["flash_launches"] == DEPTH * run["rec"]["admissions"],
              f"(a) k={k}: K3 launched {run['rec']['flash_launches']} times, "
              f"expected depth x admissions = {DEPTH * run['rec']['admissions']}")
    out["a"] = {f"k{k}": run["rec"] for k, run in runs.items()}
    emit({"phase": "serving_features", "sub": "a_greedy_decode_ahead",
          "model": MODEL_KW, "dtype": "bf16", "slots": FEATURE_SLOTS,
          "max_len": FEATURE_MAX_LEN, "requests": len(prompts),
          "max_new": FEATURE_NEW, "streams_identical_across_k": True, **out["a"]})

    # (b) 8 greedy + 8 sampled requests, seed = request index
    mix = [None if i % 2 == 0 else SamplingParams(seed=i, **SAMPLED)
           for i in range(len(prompts))]
    b1 = serve(model, prompts, sampling=mix, decode_ahead=1)
    b8 = serve(model, prompts, sampling=mix, decode_ahead=8)
    bp = serve(model, prompts, sampling=mix, decode_ahead=8, kv_page_size=PAGE)
    check(b1["streams"] == b8["streams"], "(b) sampled streams differ k=1 vs k=8")
    check(b8["streams"] == bp["streams"], "(b) sampled streams differ dense vs paged")
    check(all(b1["streams"][i] == runs[1]["streams"][i] for i in range(0, 16, 2)),
          "(b) greedy rows riding with sampled rows left the all-greedy streams")
    key_err = 0
    for seed in KEY_SEEDS:
        base = torch.from_numpy(ts.base_key(seed).astype("int64"))[None]
        idx = torch.tensor(KEY_INDICES)
        cpu = ts.fold_in(base.expand(len(KEY_INDICES), 2), idx)
        cuda = ts.fold_in(base.expand(len(KEY_INDICES), 2).cuda(), idx.cuda()).cpu()
        key_err += int((cpu != cuda).sum())
        key_err += int((ts.random_bits(cpu, 256) != ts.random_bits(cuda.cuda(), 256).cpu()).sum())
    check(key_err == 0, f"(b) key bits differ CUDA vs CPU in {key_err} words")
    logits = torch.cat([make_prefill(model, FEATURE_MAX_LEN)(
        torch.tensor([p], device="cuda"))[1] for p in prompts])
    planes = [torch.tensor([0.0 if s is None else getattr(s, f) for s in mix],
                           dtype=torch.int64 if f == "top_k" else torch.float32)
              for f in ("temperature", "top_p", "top_k", "min_p")]
    keys = ts.fold_in(torch.stack([torch.from_numpy(
        ts.base_key(0 if s is None else s.seed).astype("int64")) for s in mix]),
        torch.zeros(len(mix), dtype=torch.int64))
    tok_cpu, _ = pick_rows(logits.cpu(), *planes, keys)
    tok_cuda, _ = pick_rows(logits, *(x.cuda() for x in planes), keys.cuda())
    check(torch.equal(tok_cpu, tok_cuda.cpu()),
          f"(b) _pick_rows differs CUDA vs CPU: {tok_cpu.tolist()} vs {tok_cuda.tolist()}")
    out["b"] = {"k1": b1["rec"], "k8": b8["rec"], "k8_paged": bp["rec"]}
    emit({"phase": "serving_features", "sub": "b_sampled_mix", "sampling": SAMPLED,
          "greedy_requests": 8, "sampled_requests": 8, "replay_k1_k8_paged": True,
          "key_words_checked": len(KEY_SEEDS) * len(KEY_INDICES) * 258,
          "key_words_differing": key_err, "pick_rows_cuda_eq_cpu": True, **out["b"]})

    # (c) paged + radix: 16 prompts sharing a 384-token head, 16-128 new tail
    rng = torch.Generator().manual_seed(2)
    head = torch.randint(1, 256, (SHARED_PREFIX,), generator=rng).tolist()
    tails = torch.randint(16, 129, (16,), generator=rng).tolist()
    shared = [head + torch.randint(1, 256, (n,), generator=rng).tolist() for n in tails]
    c = serve_abba(serve, {"dense": dict(model=model, prompts=shared),
                           "paged": dict(model=model, prompts=shared, kv_page_size=PAGE)})
    cd, cp = c["dense"], c["paged"]
    s = cp["summary"]
    check(cp["rec"]["flash_launches"] == DEPTH * s["radix_misses"],
          f"(c) K3 launched {cp['rec']['flash_launches']} times, expected depth x "
          f"whole-prompt prefills = {DEPTH * s['radix_misses']}")
    check(s["radix_hit_tokens"] > 0, "(c) the radix trie shared nothing")
    check(s["kv_pages_peak"] * PAGE < FEATURE_SLOTS * FEATURE_MAX_LEN,
          f"(c) peak pages {s['kv_pages_peak']} x {PAGE} >= slots x max_len")
    # token identity with the dense engine, on a float32 twin of the weights:
    # in bf16 the extend's attention and K3 round differently, which flips
    # near-ties of bf16-quantized logits (recorded below, not gated)
    twin = get_model("causal_lm", dtype=torch.float32, generator=gen, **MODEL_KW)
    twin.load_state_dict(model.state_dict())
    fd = serve(twin, shared)
    fp = serve(twin, shared, kv_page_size=PAGE)
    check(fp["streams"] == fd["streams"],
          "(c) float32 paged + radix streams differ from the dense engine's")
    check(fp["rec"]["flash_launches"] == DEPTH * fp["summary"]["radix_misses"],
          "(c) float32: K3 launches != depth x whole-prompt prefills")
    diverged = divergences(torch, make_prefill, model, shared, cd["streams"], cp["streams"])
    agree = sum(x == y for a, b in zip(cd["streams"], cp["streams"]) for x, y in zip(a, b))
    out["c"] = {"dense": cd["rec"], "paged_radix": cp["rec"],
                "f32_dense": fd["rec"], "f32_paged_radix": fp["rec"]}
    emit({"phase": "serving_features", "sub": "c_paged_radix", "page_size": PAGE,
          "shared_prefix": SHARED_PREFIX, "tail_lens": tails,
          "f32_streams_identical": True,
          "bf16_token_agreement": round(agree / (16 * FEATURE_NEW), 4),
          "bf16_divergences": diverged, **out["c"]})

    # (d) prefix cache: 8 prompts, then the same 8 again in reverse order
    repeated = prompts[:8] + prompts[:8][::-1]
    d = serve_abba(serve, {"off": dict(model=model, prompts=repeated),
                           "on": dict(model=model, prompts=repeated,
                                      prefix_cache_bytes=PREFIX_CACHE_BYTES)})
    dd, dc = d["off"], d["on"]
    s = dc["summary"]
    check(dc["streams"] == dd["streams"], "(d) prefix-cache streams differ from cache-off")
    check(s["prefix_hits"] > 0, "(d) the prefix cache never hit")
    check(dc["rec"]["flash_launches"] == DEPTH * s["prefix_misses"],
          f"(d) K3 launched {dc['rec']['flash_launches']} times, expected depth x "
          f"misses = {DEPTH * s['prefix_misses']}")
    out["d"] = {"cache_off": dd["rec"], "cache_on": dc["rec"]}
    emit({"phase": "serving_features", "sub": "d_prefix_cache",
          "prefix_cache_bytes": PREFIX_CACHE_BYTES, "requests": len(repeated),
          "repeats": 8, "streams_identical": True, **out["d"]})
    return out


# ------------------------------------- speculation, int8 and chunked prefill

# Teacher-forced logit drift on JAX's protocol (2 x 16 tokens).  The
# weights' bound is tests/test_quant.py:150's.  Its cache bound, 0.05
# (:270), sat 1.56x over the 0.032 JAX read on its toy model; at this
# width JAX's own cache drift reads 0.045-0.057 (and the port's, on the
# same weights, 0.039-0.047: tests/test_torch_quant.py::
# test_int8_kv_drift_at_chip_width_matches_jax), so the bound here keeps
# that headroom over the reference's highest reading: 1.56 x 0.057
QUANT_DRIFT = {"weights": 0.15, "kv": 0.09}
# tests/test_quant.py:164's floor, on the teacher-forced pick: on these
# random bf16 weights a tenth of the top-2 gaps sit under the drift, and
# one flip changes the rest of its stream (so the streams' own agreement is
# recorded beside a float32-twin control, not gated)
QUANT_AGREEMENT = 0.9
# The int8 KV attention against a float64 reference on the same int8
# cache: the share of output elements that differ once rounded to bf16.
# The cache's known trap, probabilities rounded to bf16 before the PV
# product, moves the logit drift less than the seeds spread it, so this
# share gates it, and the trap is planted each run (INT8_FAULTS) to show
# that it fails the gate (PERF.md §6).
INT8_ATTN_MISMATCH = 0.01
SPEC_DRAFT_LENS = (3, 7)
SPEC_NEW = 64  # bench_speculative.py's MAX_NEW
CHUNKS = (64, 128)
LONG_LENS = (600, 897)  # (g): prompts past the 512 bucket, 600-896 tokens
LONG_REQUESTS = 8
WHOLE_BUCKETS = FEATURE_BUCKETS + (1024,)  # (g): the whole-prompt reference


def spec_prompts(torch, seed: int, repetitive: bool) -> list:
    """``scripts/bench_speculative.py``'s two prompt sets at vocab 256, 16
    requests: a 4-8-token motif tiled to 28 tokens (retrieved context
    quoted back), or i.i.d. prompts of 16-28 tokens (the control)."""
    rng = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(16):
        if repetitive:
            motif = torch.randint(1, 255, (int(torch.randint(4, 9, (1,), generator=rng)),),
                                  generator=rng).tolist()
            out.append((motif * 7)[:28])
        else:
            n = int(torch.randint(16, 29, (1,), generator=rng))
            out.append(torch.randint(1, 255, (n,), generator=rng).tolist())
    return out


def agreement(want: list, got: list) -> float:
    return round(sum(x == y for a, b in zip(want, got) for x, y in zip(a, b))
                 / sum(len(a) for a in want), 4)


def teacher_forced_drift(torch, model, other, init_cache, tokens, prefix: int) -> float:
    """Largest logit gap between ``model`` and ``other`` decoding ``tokens``
    teacher-forced: a ``prefix``-token decode-mode prefill, then one token a
    step, each against its own dense cache (JAX's drift tests, at width)."""
    b, n = tokens.shape
    worst = 0.0
    caches = [init_cache(m, b, n) for m in (model, other)]
    with torch.no_grad():
        for lo, hi in [(0, prefix)] + [(t, t + 1) for t in range(prefix, n)]:
            a, c = (m(tokens[:, lo:hi], cache=cache, max_len=n)
                    for m, cache in zip((model, other), caches))
            worst = max(worst, (a - c).abs().max().item())
    return worst


def int8_attention(torch, q, kc, vc, mask, dtype, ksc, vsc, work, p_dtype=None):
    """Plain int8-KV attention with the port's semantics: scores in ``work``
    with ``k_scale`` per (q, k) pair, a softmax masked at -1e30, ``v_scale``
    folded into the probabilities, which enter the PV product in
    ``p_dtype`` (``work`` by default); the output in ``dtype``."""
    rep = q.shape[2] // kc.shape[2]
    k, v, ks, vs = (x.to(work).repeat_interleave(rep, dim=2) for x in (kc, vc, ksc, vsc))
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(work), k) * q.shape[-1] ** -0.5
    scores = scores * ks.permute(0, 2, 1)[:, :, None, :]
    p = torch.softmax(torch.where(mask[:, None], scores, -1e30), dim=-1)
    p = (p * vs.permute(0, 2, 1)[:, :, None, :]).to(p_dtype or work)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.to(p.dtype)).to(dtype)


def int8_attention_mismatch(torch, tr, run, fault=None) -> float:
    """Run ``run()`` with every int8-cache call of ``tr._attend_cached``
    (or of ``fault`` in its place) held against the float64 reference:
    the share of output elements that differ from it."""
    real, counts = tr._attend_cached, [0, 0]

    def held(q, kc, vc, mask, dtype, ksc=None, vsc=None):
        out = (fault or real)(q, kc, vc, mask, dtype, ksc, vsc)
        if ksc is not None:
            ref = int8_attention(torch, q, kc, vc, mask, dtype, ksc, vsc, torch.float64)
            counts[0] += int((out != ref).sum())
            counts[1] += out.numel()
        return out

    tr._attend_cached = held
    try:
        run()
    finally:
        tr._attend_cached = real
    check(counts[1] > 0, "(e) no int8-cache attention ran")
    return counts[0] / counts[1]


def fault_p_bf16(torch, real):
    """Planted fault, the int8 cache's known trap: the probabilities are
    rounded to the compute dtype before the PV product."""
    def attend(q, kc, vc, mask, dtype, ksc=None, vsc=None):
        if ksc is None:
            return real(q, kc, vc, mask, dtype)
        return int8_attention(torch, q, kc, vc, mask, dtype, ksc, vsc,
                              torch.float32, dtype)
    return attend


def fault_paged_v_scale(make_insert):
    """Planted fault: the paged insert leaves ``pages_v_scale`` as it
    found it, so a prefilled prompt's V is read with stale scales."""
    def make(page_size, max_len):
        insert = make_insert(page_size, max_len)

        def faulty(cache, row_cache, bt_row, slot):
            kept = {n: e["pages_v_scale"].clone() for n, e in cache.items()}
            insert(cache, row_cache, bt_row, slot)
            for n, v in kept.items():
                cache[n]["pages_v_scale"].copy_(v)
            return cache
        return faulty
    return make


def phase_serving_spec_quant_chunk(torch, fa, xent, port) -> dict:
    """(e) int8 weights and the int8 KV cache, (f) speculative decoding on
    the motif and control prompt sets, (g) chunked prefill of prompts past
    the 512 bucket among short decoding requests, on serving_features'
    model, slots and max_len."""
    get_model, engine_cls, make_prefill, SamplingParams, ts, init_cache = port
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = get_model("causal_lm", dtype=torch.bfloat16, generator=gen, **MODEL_KW)
    kv8 = model.clone(kv_cache_dtype="int8")
    twin = get_model("causal_lm", dtype=torch.float32, generator=gen, **MODEL_KW)
    twin.load_state_dict(model.state_dict())
    prompts = serving_prompts(torch)
    serve = lambda *a, **kw: serve_features(torch, fa, xent, engine_cls, *a, **kw)  # noqa: E731
    out = {}

    def k3_gate(sub, name, run, prefills=None):
        """K3 == depth x whole-prompt prefills (admissions less radix hits)."""
        rec = run["rec"]
        if prefills is None:
            prefills = rec["admissions"] - rec.get("radix_hits", 0)
        want = DEPTH * prefills
        check(rec["flash_launches"] == want,
              f"({sub}) {name}: K3 launched {rec['flash_launches']} times, expected {want}")

    # (e) int8: weights, then weights + KV, dense and paged
    e = serve_abba(serve, {
        "bf16": dict(model=model, prompts=prompts),
        "w8": dict(model=model, prompts=prompts, quant="int8"),
        "w8_kv8": dict(model=kv8, prompts=prompts, quant="int8")})
    e["w8_paged"] = serve(model, prompts, quant="int8", kv_page_size=PAGE)
    e["w8_kv8_paged"] = serve(kv8, prompts, quant="int8", kv_page_size=PAGE)
    for name in ("w8", "w8_kv8"):
        e[name]["rec"]["device_busy_share"] = serve(
            kv8 if "kv8" in name else model, prompts, quant="int8",
            profile_of=f"serving_spec_quant_chunk[e,{name}]")["rec"]["device_busy_share"]
    # the drift gates on JAX's own protocol (tests/test_quant.py:150, 270):
    # 2 rows x 16 tokens, the weights' full forward and the cache's 8-token
    # decode-mode prefill + 8 steps; the same at 4 x 128 (64 + 64) recorded
    q8 = e["w8"]["engine"].model  # the engine's own int8 copy
    drift = {}
    for rows, n, prefix in (("2x16", 2, 16), ("4x128", 4, 128)):
        x = torch.tensor([p[:prefix] for p in prompts if len(p) >= prefix][:n], device="cuda")
        check(x.shape == (n, prefix), f"(e) drift rows: {tuple(x.shape)}")
        with torch.no_grad():
            w = (model(x) - q8(x)).abs().max().item()
        drift[rows] = {"weights": w, "kv": teacher_forced_drift(
            torch, model, kv8, init_cache, x, prefix // 2)}
    for what, limit in QUANT_DRIFT.items():
        check(drift["2x16"][what] <= limit,
              f"(e) int8 {what} teacher-forced logit drift {drift['2x16'][what]} > {limit}")
    # greedy agreement: the quantized pick against bf16's, teacher-forced
    # over the bf16 streams (gated), and the engines' streams (recorded;
    # one flip at a near-tie changes the rest of a stream)
    agree = total = 0
    with torch.no_grad():
        for p, st in zip(prompts, e["bf16"]["streams"]):
            x = torch.tensor([p + st[:-1]], device="cuda")
            a, b = model(x)[0, len(p) - 1:], q8(x)[0, len(p) - 1:]
            agree += int((a.argmax(-1) == b.argmax(-1)).sum())
            total += a.shape[0]
    tf_agreement = round(agree / total, 4)
    check(tf_agreement >= QUANT_AGREEMENT,
          f"(e) int8 teacher-forced greedy agreement {tf_agreement} < {QUANT_AGREEMENT}")
    control = serve(twin, prompts)  # bf16 against its float32 twin: no int8
    rec_e = {"f32_twin_control": {"agreement_vs_bf16": agreement(
        e["bf16"]["streams"], control["streams"])}}
    for name, run in e.items():
        k3_gate("e", name, run)
        eng = run["engine"]
        rec_e[name] = {**run["rec"], "agreement_vs_bf16": agreement(
            e["bf16"]["streams"], run["streams"]),
            "weight_bytes": eng.weight_bytes_per_chip(), "kv_bytes": eng.kv_bytes_per_chip()}
        if name == "bf16":
            continue
        # every stream that leaves bf16's does so at a near-tie: a top-2
        # gap of bf16's logits within the weights' drift bound
        div = divergences(torch, make_prefill, model, prompts, e["bf16"]["streams"],
                          run["streams"])
        rec_e[name]["divergences"] = div
        check(all(d["gap"] <= QUANT_DRIFT["weights"] for d in div),
              f"(e) {name}: a stream left bf16's at a gap above the drift bound: "
              f"{[d for d in div if d['gap'] > QUANT_DRIFT['weights']]}")
    # int8 paged == int8 dense, token for token, on the float32 twin
    twin8 = twin.clone(kv_cache_dtype="int8")
    fd = serve(twin8, prompts, quant="int8")
    fp = serve(twin8, prompts, quant="int8", kv_page_size=PAGE)
    check(fp["streams"] == fd["streams"],
          "(e) float32 twin: int8 paged streams differ from int8 dense")
    # the int8-cache attention against its float64 reference, on JAX's
    # drift protocol (dense) and in a short paged engine run
    tr = importlib.import_module(type(model.blocks[0]).__module__)
    x = torch.tensor([p[:16] for p in prompts[:2]], device="cuda")
    mismatch = {
        "dense_2x16": int8_attention_mismatch(
            torch, tr, lambda: teacher_forced_drift(torch, model, kv8, init_cache, x, 8)),
        "paged_engine": int8_attention_mismatch(
            torch, tr, lambda: serve(kv8, prompts[:4], quant="int8", kv_page_size=PAGE,
                                     max_new=8))}
    for where, share in mismatch.items():
        check(share <= INT8_ATTN_MISMATCH,
              f"(e) int8-cache attention ({where}) differs from its float64 reference "
              f"in {share} of its outputs > {INT8_ATTN_MISMATCH}")
    # the planted faults: each must fail a gate; the others' readings are
    # recorded beside it
    faults = {}
    drift_p = {}
    faults["fault_p_bf16"] = {"attention_mismatch_dense_2x16": int8_attention_mismatch(
        torch, tr, lambda: drift_p.update(kv=teacher_forced_drift(
            torch, model, kv8, init_cache, x, 8)), fault_p_bf16(torch, tr._attend_cached))}
    faults["fault_p_bf16"]["kv_drift_2x16"] = drift_p["kv"]
    check(faults["fault_p_bf16"]["attention_mismatch_dense_2x16"] > INT8_ATTN_MISMATCH,
          f"(e) the planted p-to-bf16 fault passed the attention gate: {faults}")
    eng_mod = sys.modules[engine_cls.__module__]
    real_insert = eng_mod.make_paged_insert
    eng_mod.make_paged_insert = fault_paged_v_scale(real_insert)
    try:
        ff = serve(twin8, prompts, quant="int8", kv_page_size=PAGE)
        fb = serve(kv8, prompts, quant="int8", kv_page_size=PAGE)
    finally:
        eng_mod.make_paged_insert = real_insert
    div = divergences(torch, make_prefill, model, prompts, e["bf16"]["streams"], fb["streams"])
    faults["fault_paged_v_scale"] = {
        "f32_twin_agreement_paged_vs_dense": agreement(fd["streams"], ff["streams"]),
        "bf16_agreement_vs_bf16": agreement(e["bf16"]["streams"], fb["streams"]),
        "max_divergence_gap": max((d["gap"] for d in div), default=None)}
    check(ff["streams"] != fd["streams"],
          f"(e) the planted paged v_scale fault passed the paged == dense gate: {faults}")
    check((faults["fault_paged_v_scale"]["max_divergence_gap"] or 0) > QUANT_DRIFT["weights"],
          f"(e) the planted paged v_scale fault passed the divergence-gap gate: {faults}")
    out["e"] = rec_e
    emit({"phase": "serving_spec_quant_chunk", "sub": "e_int8", "model": MODEL_KW,
          "requests": len(prompts), "max_new": FEATURE_NEW, "logit_drift": drift,
          "drift_limits": QUANT_DRIFT, "teacher_forced_agreement": tf_agreement,
          "agreement_limit": QUANT_AGREEMENT, "f32_twin_int8_paged_eq_dense": True,
          "attention_mismatch": mismatch, "attention_mismatch_limit": INT8_ATTN_MISMATCH,
          "planted_faults": faults, **rec_e})

    # (f) speculative decoding, greedy: the motif set and the control.
    # Identity with plain k=1 decode is gated on the float32 twin: in bf16
    # the verify chunk's k-token products round otherwise than k one-token
    # steps, so near-ties may flip (agreement and each first divergence's
    # top-2 gap recorded, as serving_features (c) does for the extend)
    rec_f = {}
    for set_name, seed, repetitive in (("motif", 2, True), ("control", 3, False)):
        ps = spec_prompts(torch, seed, repetitive)
        ref = serve(model, ps, max_new=SPEC_NEW)
        twin_ref = serve(twin, ps, max_new=SPEC_NEW)
        k3_gate("f", f"{set_name} k=1", ref)
        runs = {"k1": ref["rec"]}
        for dl, twin_layout in zip(SPEC_DRAFT_LENS, ({}, {"kv_page_size": PAGE})):
            pair = serve_abba(serve, {
                "plain": dict(model=model, prompts=ps, max_new=SPEC_NEW, decode_ahead=dl + 1),
                "spec": dict(model=model, prompts=ps, max_new=SPEC_NEW,
                             speculative="ngram", draft_len=dl)})
            pair["spec_f32"] = serve(twin, ps, max_new=SPEC_NEW, speculative="ngram",
                                     draft_len=dl, **twin_layout)
            for name, run in pair.items():
                k3_gate("f", f"{set_name} {name} dl={dl}", run)
                runs[f"{name}_dl{dl}"] = run["rec"]
            check(pair["plain"]["streams"] == ref["streams"],
                  f"(f) {set_name} decode_ahead={dl + 1}: streams differ from k=1")
            check(pair["spec_f32"]["streams"] == twin_ref["streams"],
                  f"(f) {set_name} float32 spec dl={dl} "
                  f"{'paged' if twin_layout else 'dense'}: streams differ from plain k=1")
            runs[f"spec_dl{dl}"].update(
                bf16_agreement_vs_k1=agreement(ref["streams"], pair["spec"]["streams"]),
                bf16_divergences=divergences(torch, make_prefill, model, ps, ref["streams"],
                                             pair["spec"]["streams"]))
        rec_f[set_name] = runs
    # a sampled mix (serving_features (b)'s) replays; its accept uniforms
    # on CUDA equal the CPU's bit for bit
    mix = [None if i % 2 == 0 else SamplingParams(seed=i, **SAMPLED)
           for i in range(len(prompts))]
    sd = serve(model, prompts, sampling=mix, speculative="ngram", draft_len=3)
    sp = serve(model, prompts, sampling=mix, speculative="ngram", draft_len=3,
               kv_page_size=PAGE)
    check(sd["streams"] == sp["streams"], "(f) sampled spec streams differ dense vs paged")
    check(sd["streams"] == serve(model, prompts, sampling=mix, speculative="ngram",
                                 draft_len=3)["streams"],
          "(f) sampled spec streams differ on a replay")
    u_err = 0
    for seed in KEY_SEEDS:
        base = torch.from_numpy(ts.base_key(seed).astype("int64"))[None]
        keys = ts.fold_in(ts.fold_in(base.expand(len(KEY_INDICES), 2),
                                     torch.tensor(KEY_INDICES)),
                          torch.ones(len(KEY_INDICES), dtype=torch.int64))
        u_err += int((ts.uniform(keys).view(torch.int32)
                      != ts.uniform(keys.cuda()).cpu().view(torch.int32)).sum())
    check(u_err == 0, f"(f) accept uniforms differ CUDA vs CPU in {u_err} draws")
    rec_f["sampled_mix"] = {"dense": sd["rec"], "paged": sp["rec"]}
    out["f"] = rec_f
    emit({"phase": "serving_spec_quant_chunk", "sub": "f_speculative",
          "draft_lens": SPEC_DRAFT_LENS, "requests": 16, "max_new": SPEC_NEW,
          "f32_spec_streams_identical_to_k1": {"dense": SPEC_DRAFT_LENS[0],
                                               "paged": SPEC_DRAFT_LENS[1]},
          "sampled_replays": True,
          "uniform_draws_checked": len(KEY_SEEDS) * len(KEY_INDICES),
          "uniform_draws_differing": u_err, **rec_f})

    # (g) chunked prefill: 8 prompts of 600-896 tokens among the 16 short
    # ones (cut from 16 long prompts to hold the phase's time)
    rng = torch.Generator().manual_seed(4)
    long_lens = torch.randint(*LONG_LENS, (LONG_REQUESTS,), generator=rng).tolist()
    longs = [torch.randint(1, 256, (n,), generator=rng).tolist() for n in long_lens]
    mixed, is_long = [], []
    for i, p in enumerate(prompts):  # a long prompt before every other short one
        if i % 2 == 0:
            mixed.append(longs[i // 2])
            is_long.append(True)
        mixed.append(p)
        is_long.append(False)
    chunked = {f"c{c}": dict(model=model, prompts=mixed, kv_page_size=PAGE, prefill_chunk=c)
               for c in CHUNKS}
    g = serve_abba(serve, {"whole": dict(model=model, prompts=mixed, buckets=WHOLE_BUCKETS,
                                         kv_page_size=PAGE), **chunked})
    rec_g = {}
    for name, run in g.items():
        eng, reqs = run["engine"], run["reqs"]
        ttft = sorted(r.first_token_t - r.submit_t for r, lg in zip(reqs, is_long) if lg)
        short = [r for r, lg in zip(reqs, is_long) if not lg]
        # the short requests' decode as a group: tokens after each one's
        # first, over the span from the first of those to the last finish
        span = max(r.finish_t for r in short) - min(r.first_token_t for r in short)
        rec_g[name] = {**run["rec"], "long_ttft_s_p50": round(ttft[len(ttft) // 2], 6),
                       "long_ttft_s_max": round(ttft[-1], 6),
                       "short_decode_tokens_per_s": round(
                           sum(len(r.generated) - 1 for r in short) / span, 3)}
        if name == "whole":
            k3_gate("g", name, run)
            continue
        c = eng._prefill_chunk
        k3_gate("g", name, run, prefills=0)
        want = sum(-(-(len(r.tokens) - r.radix_tokens) // c) for r in reqs)
        check(run["summary"]["n_prefill_chunks"] == want,
              f"(g) {name}: {run['summary']['n_prefill_chunks']} chunks, expected {want}")
        stack, refs = [eng._radix.root], 0
        while stack:
            node = stack.pop()
            refs += node.ref
            stack.extend(node.children.values())
        check(refs == 0 and eng._pool.allocated == eng._radix.n_blocks,
              f"(g) {name}: pool not drained (refs {refs}, pages {eng._pool.allocated}, "
              f"trie {eng._radix.n_blocks})")
        rec_g[name]["bf16_agreement_vs_whole"] = agreement(g["whole"]["streams"], run["streams"])
    # token identity with the whole-prompt engine on the float32 twin
    fw = serve(twin, mixed, buckets=WHOLE_BUCKETS, kv_page_size=PAGE)
    for c in CHUNKS:
        fc = serve(twin, mixed, kv_page_size=PAGE, prefill_chunk=c)
        check(fc["streams"] == fw["streams"],
              f"(g) float32 twin: chunk {c} streams differ from the whole-prompt engine")
        check(fc["rec"]["flash_launches"] == 0, f"(g) float32 chunk {c}: K3 launched")
    out["g"] = rec_g
    emit({"phase": "serving_spec_quant_chunk", "sub": "g_chunked_prefill",
          "chunks": CHUNKS, "long_prompt_lens": long_lens, "short_requests": len(prompts),
          "max_new": FEATURE_NEW, "whole_buckets": WHOLE_BUCKETS,
          "f32_streams_identical": True, **rec_g})
    return out


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
    per-rank logits, among others), then timed, and the card's launch
    floor (an empty kernel) with the same timer."""
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
    # the launch floor: an empty kernel (csrc/launch_floor.cu), same timer
    from distributed_tensorflow_ibm_mnist_tpu_torch.ops.launch_floor import launch_floor

    floor_ms = gpu_ms(launch_floor, torch, sleep=20_000_000)
    emit({"phase": "kernel_time", "kernel": "launch_floor", "ms": floor_ms,
          "what": "one empty kernel, <<<1, 1>>>, no arguments read"})
    return {"max_abs_err": errs, "at_shape": at_shape, "timed": timed,
            "launch_floor_ms": floor_ms}


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


def profile_run(torch, run, of: str, focus: dict, top_n: int = 8,
                host_ops: bool = True) -> dict:
    """One more run under torch.profiler: device time by kernel and the
    device's busy share of the wall time (the profiler's own overhead
    inflates the wall, so the share is a lower bound).  ``run`` returns its
    wall seconds; ``focus`` maps an output key to a kernel-name substring
    whose device time is summed.  ``host_ops=False`` traces the device
    only (no ``top_ops``), which reads back in a fraction of the time."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops else [])
    with profile(activities=activities) as prof:
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
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_dp_"))
    try:
        return {"dp1_nccl": phase_dp1_nccl(torch, fa, xent, port, tmp),
                "dp2_gloo": phase_dp2_gloo(torch, fa, xent, port, steps_mod, tmp),
                "dp8_gloo_fit": phase_dp8_gloo_fit(torch, port, tmp),
                "resnet20_dp2_gloo": phase_resnet20_dp2_gloo(torch, port, steps_mod, tmp)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------- fault tolerance

FT_PRESET = "mnist_lenet_1chip"  # the source paper's job, with fused_xent
FT_EPOCHS = 3
FT_PROFILE_TRAIN = 8192  # (f): the profiled fit's training set (a trace of 60k is ~1 GB)
FT_RESNET_BATCHES = 3  # (e): steps of cifar_resnet50_dp32 per configuration
FT_REMAT = {"plain_ga4": (False, 4), "plain_ga1": (False, 1), "remat_ga1": (True, 1),
            "blocks_ga1": ("blocks", 1)}
FT_LM_STEPS = 4
FT_MNIST_RENDER = dict(out_hw=(28, 28), scale_range=(2.2, 3.4), rot_range=0.30,
                       shift_frac=0.12, noise_std=0.18)  # synthetic_mnist's


class SharedData:
    """Render each synthetic split once for the phase: the Trainers of one
    configuration share it (``load_dataset`` is a pure function of its
    arguments), and ``render_s`` keeps the first render's seconds."""

    def __init__(self, trainer_mod):
        self.mod, self.orig = trainer_mod, trainer_mod.load_dataset
        self.cache: dict = {}
        self.render_s: dict = {}

    def load(self, name, **kw):
        key = (name, tuple(sorted((k, repr(v)) for k, v in kw.items())))
        if key not in self.cache:
            t0 = time.perf_counter()
            self.cache[key] = self.orig(name, **kw)
            self.render_s[f"{name}:{kw.get('n_train')}"] = round(time.perf_counter() - t0, 3)
        return self.cache[key]

    def __enter__(self):
        self.mod.load_dataset = self.load
        return self

    def __exit__(self, *exc):
        self.mod.load_dataset = self.orig


def ft_snapshot(trainer) -> dict:
    """Parameters, Adam moments (by name) and the per-epoch losses, on the host."""
    names = [n for n, _ in trainer.model.named_parameters()]
    opt = trainer.state.optimizer.state_dict(names)
    out = {f"param/{n}": p.detach().float().cpu() for n, p in trainer.model.named_parameters()}
    for key in ("mu", "nu", "trace"):
        out.update({f"{key}/{n}": t.float().cpu() for n, t in opt[key].items()})
    return {"tensors": out, "step": trainer.state.step,
            "losses": [r["train_loss"] for r in trainer.history]}


def ft_diff(a: dict, b: dict) -> float:
    """Largest absolute difference of two snapshots (inf if they do not
    even hold the same steps)."""
    if a["step"] != b["step"] or a["tensors"].keys() != b["tensors"].keys():
        return math.inf
    return max(float((a["tensors"][k] - b["tensors"][k]).abs().max()) for k in a["tensors"])


def ft_loss_diff(want: list, got: list) -> float:
    if len(want) != len(got):
        return math.inf
    return max((abs(x - y) for x, y in zip(want, got)), default=0.0)


def ft_fit(Trainer, cfg, device, epochs=None, resume_step=None, fault=None, **kw):
    """One fit of ``cfg`` (its schedule sized for ``cfg.epochs``), running
    ``epochs`` of them; ``resume_step``: restore that step first (without
    ``resume``); ``fault(trainer)``: a planted fault, applied after the
    restore.  Returns the trainer, closed."""
    t = Trainer(cfg, device=device, **kw)
    if resume_step is not None:
        t.restore_checkpoint(step=resume_step)
    if fault is not None:
        fault(t)
    if epochs is not None:
        t.config = t.config.replace(epochs=epochs)
    t.fit()
    t.close()
    return t


def fault_fresh_moments(trainer) -> None:
    """Planted: the resume restores the parameters but not Adam's moments."""
    for t in trainer.state.optimizer.mu + trainer.state.optimizer.nu:
        t.zero_()


def fault_data_order_from_zero(trainer) -> None:
    """Planted: the resume restarts the data order at epoch 0."""
    seed = trainer._epoch_seed
    trainer._epoch_seed = lambda epoch, *rest: seed(epoch - 1, *rest)


FT_FAULTS = {"fault_fresh_moments": fault_fresh_moments,
             "fault_data_order_from_zero": fault_data_order_from_zero}


def ft_resume_check(Trainer, cfg, tmp: Path, device) -> dict:
    """(a): two uninterrupted runs of ``cfg`` (``FT_EPOCHS`` epochs, a
    checkpoint each) give the run-to-run floor; one epoch then a resume
    for the rest in a fresh Trainer must end within it (final parameters,
    moments, per-epoch losses); each planted fault, resumed from the same
    first-epoch step, must not."""
    full = [ft_fit(Trainer, cfg.replace(checkpoint_dir=str(tmp / f"full{i}")), device)
            for i in (0, 1)]
    want = ft_snapshot(full[0])
    floor = ft_diff(want, ft_snapshot(full[1]))
    loss_floor = ft_loss_diff(want["losses"], ft_snapshot(full[1])["losses"])
    part = ft_fit(Trainer, cfg.replace(checkpoint_dir=str(tmp / "resumed")), device, epochs=1)
    first = part.state.step
    resumed = ft_fit(Trainer, cfg.replace(checkpoint_dir=str(tmp / "resumed"), resume=True),
                     device, epochs=FT_EPOCHS - 1)
    got = ft_snapshot(resumed)
    rec = {"floor": floor, "loss_floor": loss_floor, "first_step": first,
           "final_step": got["step"], "diff": ft_diff(want, got),
           "loss_diff": ft_loss_diff(want["losses"][1:], got["losses"]),
           "passed": None, "faults": {}, "save_timings": full[0]._ckpt.timings,
           "trainers": {"full": full[0], "resumed": resumed}}
    rec["passed"] = rec["diff"] <= floor and rec["loss_diff"] <= loss_floor
    for name, fault in FT_FAULTS.items():
        bad = ft_snapshot(ft_fit(Trainer, cfg.replace(checkpoint_dir=str(tmp / "resumed")),
                                 device, epochs=FT_EPOCHS - 1, resume_step=first,
                                 fault=fault))
        diff = ft_diff(want, bad)
        loss_diff = ft_loss_diff(want["losses"][1:], bad["losses"])
        rec["faults"][name] = {"diff": diff, "loss_diff": loss_diff,
                               "fails_gate": not (diff <= floor and loss_diff <= loss_floor)}
    return rec


def ft_cfg(get_preset, **kw):
    """The phase's LeNet run: the preset with the fused kernels, every epoch
    (no early stop), a checkpoint each epoch."""
    return get_preset(FT_PRESET).replace(fused_xent=True, synthetic=True, quiet=True,
                                         target_accuracy=None, epochs=FT_EPOCHS,
                                         checkpoint_every=1, **kw)


def preempt_child(directory: str) -> int:
    """``chip_smoke.py --preempt-child DIR``: the preset under a
    ``PreemptionHandler`` with no periodic checkpoint; prints its epoch
    records as they land, then one ``ft_child`` line (summary, the
    checkpoint's timings, the steps on disk)."""
    from distributed_tensorflow_ibm_mnist_tpu_torch.core.trainer import Trainer
    from distributed_tensorflow_ibm_mnist_tpu_torch.utils.config import get_preset
    from distributed_tensorflow_ibm_mnist_tpu_torch.utils.elastic import PreemptionHandler

    cfg = get_preset(FT_PRESET).replace(
        fused_xent=True, synthetic=True, target_accuracy=None, epochs=6,
        checkpoint_dir=directory, checkpoint_every=0)
    with PreemptionHandler() as handler, Trainer(cfg, device="cuda") as trainer:
        summary = trainer.fit(preemption=handler)
        print(json.dumps({"kind": "ft_child", "summary": summary, "installed": handler.installed,
                          "timings": trainer._ckpt.timings, "steps": trainer._ckpt.all_steps(),
                          "step": trainer.state.step}), flush=True)
    return 0


def ft_preemption(tmp: Path) -> dict:
    """(b): a child process trains the preset under a PreemptionHandler
    and gets a real SIGTERM after its first epoch record: it must exit 0,
    preempted, with one checkpoint; then the CLI's ``--resume`` in a fresh
    process must reach 0.99 from it."""
    import signal

    ckpt = tmp / "preempt"
    t0 = time.perf_counter()
    child = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--preempt-child",
                              str(ckpt)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
    sent_at, lines = None, []
    try:
        for line in child.stdout:
            lines.append(line)
            if sent_at is None and '"kind": "epoch"' in line:
                child.send_signal(signal.SIGTERM)
                sent_at = time.perf_counter() - t0
        rc = child.wait(timeout=300)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    err = child.stderr.read()
    child.stderr.close()
    out = [json.loads(x) for x in lines if x.startswith("{")]
    final = next((r for r in out if r.get("kind") == "ft_child"), {})
    check(rc == 0 and final, f"the preempted child exited {rc}: {err[-2000:]}")
    metrics = tmp / "resume.jsonl"
    t1 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "distributed_tensorflow_ibm_mnist_tpu_torch.launch.cli",
         "--preset", FT_PRESET, "--resume", "--set", f"checkpoint_dir={ckpt}",
         "--set", "fused_xent=True", "--set", "synthetic=True", "--set", "epochs=2",
         "--set", "quiet=True", "--set", f"metrics_path={metrics}"],
        capture_output=True, text=True, timeout=300)
    resume_s = time.perf_counter() - t1
    check(res.returncode == 0, f"the CLI resume exited {res.returncode}: {res.stderr[-2000:]}")
    summary = json.loads(res.stdout.strip().splitlines()[-1])
    records = [json.loads(x) for x in metrics.read_text().splitlines()]
    resumed_at = [r["step"] for r in records if r["kind"] == "resume"]
    save = final["timings"][-1] if final.get("timings") else {}
    return {"child_rc": rc, "sigterm_after_s": round(sent_at, 3) if sent_at else None,
            "handler_installed": final.get("installed"),
            "preempted": final.get("summary", {}).get("preempted"),
            "preempted_step": final.get("step"), "checkpoints": final.get("steps"),
            "epochs_before_preemption": final.get("summary", {}).get("epochs_run"),
            "save_wall_s": save.get("landed_s"), "save_blocked_s": save.get("blocked_s"),
            "resume_cli_rc": res.returncode, "resumed_at_step": resumed_at,
            "resume_best_test_accuracy": summary.get("best_test_accuracy"),
            "resume_cli_s": round(resume_s, 3)}


def ft_stream(torch, Trainer, cfg, fa, xent) -> dict:
    """(d): ``cfg`` in stream mode through the native Prefetcher, chunk 8
    and 1, its first epoch held to device mode's per-step losses on the
    same permutation (a device-mode Trainer of ``cfg``: ``out["device"]``),
    and to 0.99."""
    device_trainer = Trainer(cfg, device="cuda")
    want = device_trainer._epoch(device_trainer._epoch_seed(0))["loss"].float().cpu()
    out = {"device": device_trainer}
    for chunk in (8, 1):
        t = Trainer(cfg.replace(input_mode="stream", stream_chunk=chunk), device="cuda")
        seen = []
        epoch = t._epoch
        t._epoch = lambda seed, pre=None: seen.append(epoch(seed, pre)) or seen[-1]
        reset_counts(fa, xent)
        summary = t.fit()
        counts = read_counts(fa, xent)
        got = seen[0]["loss"].float().cpu()
        out[chunk] = {"trainer": t, "summary": summary, "launches": counts,
                      "loss_diff": float((got - want).abs().max()),
                      "steps": t.state.step}
        t._epoch = epoch
    return out


def ft_remat_resnet(torch, Trainer, get_preset, steps_mod) -> dict:
    """(e), ResNet-50: ``FT_RESNET_BATCHES`` steps of cifar_resnet50_dp32
    (dp=1, batch 4096) per configuration of ``FT_REMAT``: peak memory,
    s/step, the first step's loss and running statistics.  A configuration
    that does not fit is recorded as such."""
    base = get_preset("cifar_resnet50_dp32").replace(
        dp=1, synthetic=True, quiet=True, epochs=1, n_test=512,
        n_train=FT_RESNET_BATCHES * 4096)
    out = {}
    for name, (remat, accum) in FT_REMAT.items():
        torch.cuda.empty_cache()
        t = Trainer(base.replace(remat=remat, grad_accum=accum), device="cuda")
        step = steps_mod.make_train_step(t.model, t.state.optimizer, grad_accum=accum,
                                         remat=remat is True)
        gen = torch.Generator(device="cuda").manual_seed(0)
        perm = torch.randperm(t.train_images.shape[0], generator=gen, device="cuda")
        batches = perm[: FT_RESNET_BATCHES * 4096].view(FT_RESNET_BATCHES, 4096)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rec = {"remat": remat, "grad_accum": accum, "oom": False}
        try:
            times = []
            for i, idx in enumerate(batches):
                t0 = time.perf_counter()
                m = step(t.state, {"image": t.train_images.index_select(0, idx),
                                   "label": t.train_labels.index_select(0, idx)})
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                if i == 0:
                    rec["first_loss"] = float(m["loss"])
                    rec["stats"] = {k: b.detach().cpu().clone()
                                    for k, b in t.model.named_buffers()}
            rec["s_per_step"] = round(statistics.mean(times[1:]), 4)
            rec["first_step_s"] = round(times[0], 4)
            rec["peak_mem_gb"] = round(torch.cuda.max_memory_allocated() / 1e9, 3)
        except torch.OutOfMemoryError as e:
            rec.update(oom=True, error=str(e).splitlines()[0][:200],
                       peak_mem_gb=round(torch.cuda.max_memory_allocated() / 1e9, 3))
        del t, step
        gc.collect()
        torch.cuda.empty_cache()
        out[name] = rec
    return out


def ft_resnet_reference(torch, Trainer, get_preset) -> list:
    """Two plain forwards of the first batch at grad_accum=1 (no backward,
    so it fits whatever the step does): the first-step loss and running
    statistics a remat step must equal, and the floor between two runs."""
    base = get_preset("cifar_resnet50_dp32").replace(
        dp=1, synthetic=True, quiet=True, epochs=1, n_test=512,
        n_train=FT_RESNET_BATCHES * 4096)
    from distributed_tensorflow_ibm_mnist_tpu_torch.core.steps import make_loss_fn

    refs = []
    for _ in range(2):
        t = Trainer(base, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)
        idx = torch.randperm(t.train_images.shape[0], generator=gen, device="cuda")[:4096]
        with torch.no_grad():
            loss, _ = make_loss_fn(t.model)({"image": t.train_images.index_select(0, idx),
                                             "label": t.train_labels.index_select(0, idx)})
        refs.append({"first_loss": float(loss),
                     "stats": {k: b.detach().cpu().clone() for k, b in t.model.named_buffers()}})
        del t
        torch.cuda.empty_cache()
    return refs


def stats_diff(a: dict, b: dict) -> float:
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def ft_remat_lm(torch, Trainer, RunConfig, fa, xent) -> dict:
    """(e), the LM: bench_lm8k for ``FT_LM_STEPS`` steps, plain and with
    block_remat: tokens/s/chip, peak memory, K3/K4 launches."""
    out = {}
    for name, remat in (("plain", False), ("block_remat", "blocks")):
        cfg = RunConfig(**{**LM_CFG, "n_train": FT_LM_STEPS * LM_CFG["batch_size"],
                           "remat": remat})
        t = Trainer(cfg, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(fa, xent)
        summary = t.fit()
        counts = read_counts(fa, xent)
        peak = torch.cuda.max_memory_allocated() / 1e9
        tp = t.measure_throughput(epochs=1)
        out[name] = {"steps": t.state.step, "launches": counts, "peak_mem_gb": round(peak, 3),
                     "train_loss": summary["epochs_run"] and t.history[0]["train_loss"],
                     "eval_batches": -(-cfg.n_test // cfg.eval_batch_size),
                     "tokens_per_sec_per_chip": tp["tokens_per_sec_per_chip"],
                     "s_per_step": round(cfg.batch_size / tp["images_per_sec"], 4)}
        del t
        torch.cuda.empty_cache()
    return out


def phase_fault_tolerant_training(torch, fa, xent, port, steps_mod, tmp: Path) -> dict:
    """The fault-tolerance and input layer (sub-phases (a)-(f), one line each)."""
    import distributed_tensorflow_ibm_mnist_tpu_torch.core.trainer as trainer_mod
    from distributed_tensorflow_ibm_mnist_tpu_torch.data import native, synthetic
    from distributed_tensorflow_ibm_mnist_tpu_torch.utils.chaos import (
        FaultInjector,
        FaultPlan,
        FaultSpec,
    )
    from distributed_tensorflow_ibm_mnist_tpu_torch.utils.elastic import run_with_recovery

    Trainer, get_preset, RunConfig = port
    card = {"card": torch.cuda.get_device_name(0), "nvidia_smi": nvidia_smi_line()}
    torch.backends.cudnn.deterministic = True  # one algorithm per shape: run-to-run floor
    torch.backends.cudnn.benchmark = False
    result: dict = {}
    with SharedData(trainer_mod) as shared:
        cfg = ft_cfg(get_preset)
        # (a) resume equals the uninterrupted run
        t0 = time.perf_counter()
        reset_counts(fa, xent)
        a = ft_resume_check(Trainer, cfg, tmp / "a", "cuda")
        launches = read_counts(fa, xent)
        trainers = a.pop("trainers")
        rec = {"phase": "fault_tolerant_training", "sub": "a_resume", **card,
               "config": {"preset": FT_PRESET, "fused_xent": True, "epochs": FT_EPOCHS,
                          "checkpoint_every": 1, "cudnn_deterministic": True,
                          "data_backend": os.environ.get("DTM_DATA_BACKEND")},
               **a, "launches_all_runs": launches, "wall_s": round(time.perf_counter() - t0, 3),
               "data_render_s": dict(shared.render_s)}
        emit(rec)
        check(a["passed"], f"the resumed run is {a['diff']} / {a['loss_diff']} off the "
              f"uninterrupted one, past the floor {a['floor']} / {a['loss_floor']}")
        for name, f in a["faults"].items():
            check(f["fails_gate"], f"the planted {name} passed the resume gate: {f}")
        fits = (2 * a["final_step"] + a["first_step"]  # two full runs, the first epoch,
                + (1 + len(FT_FAULTS)) * (a["final_step"] - a["first_step"]))  # the resumes
        check(launches["xent_fwd"] == launches["xent_bwd"] == fits,
              f"K1/K2 launched {launches} times over (a)'s fits, not once a step ({fits})")
        result["a"] = rec

        # (c) torn newest step, and a train-step NaN under run_with_recovery
        t0 = time.perf_counter()
        full = trainers["full"]
        ck = tmp / "a" / "full0"
        steps = sorted(int(p.name) for p in ck.iterdir() if p.name.isdigit())
        newest = ck / str(steps[-1])
        victim = max(newest.iterdir(), key=lambda p: p.stat().st_size)
        with open(victim, "r+b") as f:
            f.truncate(victim.stat().st_size // 2)
        walker = Trainer(cfg.replace(checkpoint_dir=str(ck)), device="cuda")
        landed = walker.restore_checkpoint()
        skipped = walker._ckpt.skipped
        walker.close()
        inj = FaultInjector(FaultPlan(seed=11, faults=(
            FaultSpec(site="train-step", kind="nan", at=(1,)),)))
        made = []

        def make():
            made.append(Trainer(cfg.replace(checkpoint_dir=str(tmp / "c_chaos")),
                                device="cuda", chaos=inj))
            return made[-1]

        summary = run_with_recovery(make, max_restarts=2, backoff_base_s=0.0)
        made[-1].close()
        chaos_diff = ft_diff(ft_snapshot(full), ft_snapshot(made[-1]))
        rec = {"phase": "fault_tolerant_training", "sub": "c_torn_and_chaos", **card,
               "steps_on_disk": steps, "torn_file": victim.name, "landed_on": landed,
               "skipped": skipped, "chaos_restarts": summary["restarts"],
               "chaos_fired": inj.summary(), "chaos_final_step": made[-1].state.step,
               "chaos_diff": chaos_diff, "floor": a["floor"],
               "wall_s": round(time.perf_counter() - t0, 3)}
        emit(rec)
        check(landed == steps[-2], f"the walk landed on {landed}, not {steps[-2]}")
        check(len(skipped) == 1 and skipped[0][0] == steps[-1], f"walk reasons {skipped}")
        check(summary["restarts"] == 1 and chaos_diff <= a["floor"],
              f"the NaN-chaos run ends {chaos_diff} off the fault-free one (floor {a['floor']})")
        result["c"] = rec

        # (d) stream input through the native prefetcher
        t0 = time.perf_counter()
        streams = ft_stream(torch, Trainer, get_preset(FT_PRESET).replace(
            fused_xent=True, synthetic=True, quiet=True, epochs=2), fa, xent)
        device_trainer = streams.pop("device")
        s8 = streams[8]["trainer"]
        tp_stream = s8.measure_throughput(epochs=1)
        tp_device = device_trainer.measure_throughput(epochs=1)

        def stream_epoch():
            t = time.perf_counter()
            s8._epoch(s8._epoch_seed(7))["loss"][-1].item()
            return time.perf_counter() - t

        prof = profile_run(torch, stream_epoch, "stream epoch (chunk 8)",
                           {"h2d_device_s": "Memcpy HtoD", "xent_fwd_device_s": "xent_fwd"},
                           host_ops=False)
        chunks = -(-s8.steps_per_epoch // 8)
        templates = synthetic._glyphs_to_array(synthetic._DIGIT_GLYPHS)
        render = {}
        for backend in ("numpy", "native"):
            t1 = time.perf_counter()
            synthetic._make_split(templates, 60_000, 1, backend=backend,
                                  **FT_MNIST_RENDER)
            render[backend] = round(time.perf_counter() - t1, 3)
        rec = {"phase": "fault_tolerant_training", "sub": "d_stream", **card,
               "native_available": native.available(),
               **{f"chunk{c}": {"loss_diff_vs_device": s["loss_diff"], "steps": s["steps"],
                                "best_test_accuracy": s["summary"]["best_test_accuracy"],
                                "epochs_run": s["summary"]["epochs_run"],
                                "time_to_target_s": s["summary"]["time_to_target_s"],
                                "launches": s["launches"]} for c, s in streams.items()},
               "images_per_sec_per_chip": {"stream8": tp_stream["images_per_sec_per_chip"],
                                           "device": tp_device["images_per_sec_per_chip"]},
               "busy_share_stream8": prof["device_busy_share"],
               "h2d_ms_per_chunk": (round(prof["h2d_device_s"] * 1e3 / chunks, 4)
                                    if prof["h2d_device_s"] is not None else None),
               "profile": prof, "render_60k_s": render, "floor": a["floor"],
               "wall_s": round(time.perf_counter() - t0, 3)}
        emit(rec)
        for c, s in streams.items():
            check(s["loss_diff"] <= a["loss_floor"],
                  f"stream chunk {c} losses {s['loss_diff']} off device mode's")
            check(s["summary"]["best_test_accuracy"] >= 0.99,
                  f"stream chunk {c} reached {s['summary']['best_test_accuracy']}")
            check(s["launches"]["xent_fwd"] == s["launches"]["xent_bwd"] == s["steps"],
                  f"stream chunk {c}: launches {s['launches']} != steps {s['steps']}")
        result["d"] = rec
        for s in streams.values():
            s["trainer"].close()
        device_trainer.close()

        # (e) remat: ResNet-50 at batch 4096, then the LM with block_remat
        t0 = time.perf_counter()
        runs = ft_remat_resnet(torch, Trainer, get_preset, steps_mod)
        refs = ft_resnet_reference(torch, Trainer, get_preset)
        ref_floor = max(abs(refs[0]["first_loss"] - refs[1]["first_loss"]),
                        stats_diff(refs[0]["stats"], refs[1]["stats"]))
        plain1 = runs["plain_ga1"]
        ref = plain1 if not plain1["oom"] else refs[0]
        gates = {}
        for name in ("remat_ga1", "blocks_ga1"):
            r = runs[name]
            gates[name] = None if r["oom"] else {
                "loss_diff": abs(r["first_loss"] - ref["first_loss"]),
                "stats_diff": stats_diff(r["stats"], ref["stats"])}
        lm = ft_remat_lm(torch, Trainer, RunConfig, fa, xent)
        rec = {"phase": "fault_tolerant_training", "sub": "e_remat", **card,
               "resnet50": {k: {kk: vv for kk, vv in v.items() if kk != "stats"}
                            for k, v in runs.items()},
               "reference": "plain_ga1 step" if not plain1["oom"] else
               "plain grad_accum=1 forward (the plain step did not fit)",
               "reference_floor": ref_floor, "gates": gates, "lm": lm,
               "wall_s": round(time.perf_counter() - t0, 3)}
        emit(rec)
        for name, g in gates.items():
            check(g is not None, f"{name} did not fit: {runs[name]}")
            check(g["loss_diff"] <= ref_floor and g["stats_diff"] <= ref_floor,
                  f"{name}'s first step is {g} off the plain step (floor {ref_floor}): "
                  "BatchNorm moved twice?")
        for name, r in lm.items():
            per_step = 2 if name == "block_remat" else 1  # the recompute runs K3 again
            want_k3 = DEPTH * (per_step * r["steps"] + r["eval_batches"])
            check(r["launches"]["flash_fwd"] == want_k3,
                  f"LM {name}: K3 {r['launches']['flash_fwd']} != {want_k3}")
            check(r["launches"]["flash_bwd_fused"] == DEPTH * r["steps"],
                  f"LM {name}: K4 {r['launches']['flash_bwd_fused']} != {DEPTH * r['steps']}")
        result["e"] = rec

        # (f) profile_dir on a 2-epoch LeNet fit
        t0 = time.perf_counter()
        prof_dir = tmp / "profile"
        pcfg = cfg.replace(checkpoint_dir=None, epochs=2, n_train=FT_PROFILE_TRAIN,
                           profile_dir=str(prof_dir))
        with Trainer(pcfg, device="cuda") as t:
            t.fit()
        trace = prof_dir / "trace.json"
        names = [e.get("name", "") for e in json.loads(trace.read_text())["traceEvents"]]
        rec = {"phase": "fault_tolerant_training", "sub": "f_profile", **card,
               "trace_bytes": trace.stat().st_size, "events": len(names),
               "xent_fwd_events": sum("xent_fwd" in n for n in names),
               "n_train": FT_PROFILE_TRAIN, "wall_s": round(time.perf_counter() - t0, 3)}
        emit(rec)
        check(rec["events"] > 0 and rec["xent_fwd_events"] > 0,
              f"the fit's trace holds no xent_fwd event: {rec}")
        result["f"] = rec
    torch.backends.cudnn.deterministic = False

    # (b) preemption with a real signal, in child processes
    t0 = time.perf_counter()
    b = ft_preemption(tmp)
    rec = {"phase": "fault_tolerant_training", "sub": "b_preemption", **card, **b,
           "async_save_blocked_s": [round(x["blocked_s"], 4) for x in a["save_timings"]],
           "async_save_landed_s": [round(x["landed_s"], 4) for x in a["save_timings"]
                                   if x["landed_s"] is not None],
           "wall_s": round(time.perf_counter() - t0, 3)}
    emit(rec)
    check(b["preempted"] is True and b["handler_installed"],
          f"the child was not preempted by its SIGTERM: {b}")
    check(b["checkpoints"] == [b["preempted_step"]], f"checkpoints {b['checkpoints']}")
    check(b["resumed_at_step"] == [b["preempted_step"]], f"the CLI resumed at {b}")
    check((b["resume_best_test_accuracy"] or 0) >= 0.99,
          f"the resumed CLI run reached {b['resume_best_test_accuracy']}")
    result["b"] = rec
    return result


# Each kernel's design as it stands: its bf16 instances on the tensor
# cores (mma.sync on cp.async-fed tiles, or wgmma on TMA-fed tiles), or
# "scalar" for CUDA-core float32 FMAs.  The flash kernels' float32
# instances stay scalar (the tensor cores have no float32 product that
# keeps the 1e-4 checks).
# ---------------------------------------------------------------- serving tier

# the serving LM at full width (bench.py:254-262), served by 3 replicas on
# the one card, each with router_soak.py's engine shape
TIER_MODEL = dict(num_classes=256, dim=512, depth=DEPTH, heads=8, attn="flash")
TIER_ENGINE = dict(slots=8, max_len=1024, decode_ahead=2, kv_page_size=16)
TIER_BUCKETS = SLICE_SEQS
TIER_REPLICAS = 3
# (a): the LM fitted in float32 on the retrieval set, one short epoch (W1),
# then one more after a resume (W2); S=512 takes the fused backward route
TIER_FIT = dict(name="serving_tier_lm", model="causal_lm", dataset="retrieval",
                dataset_kwargs={"vocab": 256, "seq_len": 512}, n_train=64, n_test=16,
                batch_size=8, epochs=1, quiet=True, eval_batch_size=8, lr=3e-4)
TIER_WARM = ([1, 2, 3], 4)  # the request each replica serves inside its factory
TIER_WAVE, TIER_BRIDGE = 10, 3  # router_soak.py's wave and bridge sizes
TIER_SHARED = 64  # even prompts share a 64-token head (4 pages): radix hits
TIER_CALIB, TIER_OPEN, TIER_PUMP = 24, 48, 12  # daemon requests per leg
TIER_PAIRS = 3  # (f): interleaved off/on pairs
TIER_WAIT_S = 300.0  # any single wait, drain or join: generous, never load-bearing


def tier_prompts(torch, seed: int, n: int) -> list:
    """``n`` (prompt, budget) pairs: 16-512 tokens of 1-255, even ones
    sharing a seeded head, budgets 16-32."""
    rng = torch.Generator().manual_seed(seed)
    head = torch.randint(1, 256, (TIER_SHARED,), generator=torch.Generator().manual_seed(7))
    out = []
    for i in range(n):
        body = torch.randint(1, 256, (int(torch.randint(16, 449, (1,), generator=rng)),),
                             generator=rng)
        toks = torch.cat([head, body]) if i % 2 == 0 else body
        out.append((toks.tolist(), 16 + 8 * (i % 3)))
    return out


def tier_engine(get_model, InferenceEngine, torch, params, dtype, **kw):
    """One replica's engine: a fresh full-width model in ``dtype`` holding
    ``params`` (a state_dict; load_state_dict casts it)."""
    model = get_model("causal_lm", dtype=dtype, device="cuda", **TIER_MODEL)
    return InferenceEngine(model, params, buckets=TIER_BUCKETS, device="cuda",
                           **TIER_ENGINE, **kw)


def tier_reference(torch, make, wave) -> list:
    """Fault-free single-engine greedy outputs of ``wave``."""
    eng = make()
    reqs = [eng.submit(p, max_new=b) for p, b in wave]
    eng.run()
    eng.close()
    check(all(r.status == "done" for r in reqs), "a reference request did not finish")
    return [list(r.generated) for r in reqs]


def prefill_spans(tracer) -> int:
    """Closed ``prefill`` spans so far: one per whole-prompt (K3) prefill."""
    return int(tracer.summary()["phases"].get("serving/prefill", {}).get("n", 0))


def pools_refcount_zero(router) -> bool:
    """Every live engine's pool holds only radix-owned pages and every trie
    node is unreferenced (no request holds a page)."""
    for rep in router.replicas:
        if not rep.alive or rep.engine._pool is None:
            continue
        eng, stack = rep.engine, [rep.engine._radix.root]
        while stack:
            node = stack.pop()
            if node.ref != 0:
                return False
            stack.extend(node.children.values())
        if eng._pool.allocated != eng._radix.n_blocks:
            return False
    return True


def open_loop(daemon, wave, rate_rps: float, seed: int, ttft_slo_s, QueueFull) -> tuple:
    """bench_slo.py's Poisson open loop: submit on the arrival clock, never
    waiting on the tier; returns ([(request, stream)], rejected)."""
    import random

    rng = random.Random(seed)
    accepted, rejected = [], 0
    t_next = time.monotonic()
    for p, b in wave:
        t_next += rng.expovariate(rate_rps)
        lag = t_next - time.monotonic()
        if lag > 0:
            time.sleep(lag)
        stream: list = []
        try:
            dr = daemon.submit(p, b, ttft_slo_s=ttft_slo_s,
                               callback=lambda dr, tok, s=stream: s.append(int(tok)))
        except QueueFull:  # SLOUnmeetable included: shed at submit
            rejected += 1
            continue
        accepted.append((dr, stream))
    return accepted, rejected


def daemon_leg(torch, fa, xent, build, tier, name: str, wave, *, rate_rps=None,
               ttft_slo_s=None, policy=None, chaos=None, liveness_s=60.0) -> dict:
    """One daemon run over a fresh prewarmed bf16 router: closed loop (all
    submitted at once) or a Poisson open loop at ``rate_rps``.  Gates
    exact conservation, exactly-once streams, a clean drain with no open
    span and every pool at refcount zero, K3 == depth x whole-prompt
    prefills, and zero builds or loads after the prewarm."""
    ServingDaemon, Tracer, CompileTracker, QueueFull = tier
    tracer = Tracer()
    router = build(tracer=tracer, chaos=chaos)
    router.prewarm()
    tracker = CompileTracker.install()
    built0 = tracker.snapshot()
    daemon = ServingDaemon(router, policy=policy, max_queue=256,
                           liveness_timeout_s=liveness_s, watchdog_interval_s=0.05)
    try:
        spans0 = prefill_spans(tracer)
        reset_counts(fa, xent)
        daemon.start()
        t0 = time.monotonic()
        if rate_rps is None:
            accepted, rejected = [], 0
            for p, b in wave:
                stream: list = []
                accepted.append((daemon.submit(
                    p, b, callback=lambda dr, tok, s=stream: s.append(int(tok))), stream))
        else:
            accepted, rejected = open_loop(daemon, wave, rate_rps, len(name), ttft_slo_s,
                                           QueueFull)
        for dr, _ in accepted:
            check(dr.wait(TIER_WAIT_S), f"(e) {name}: a request never ended")
        wall = time.monotonic() - t0
        drained = daemon.drain(timeout=TIER_WAIT_S)
        torch.cuda.synchronize()
        launches = read_counts(fa, xent)["flash_fwd"]
        spans = prefill_spans(tracer) - spans0
        cons = daemon.conservation()
        pools = pools_refcount_zero(router)
    finally:
        daemon.close()
    built = CompileTracker.delta(tracker.snapshot(), built0)
    done = [(dr, s) for dr, s in accepted if dr.status == "done"]
    ttfts = sorted(dr.first_token_t - dr.submit_t for dr, _ in done)
    met = sum(1 for dr, _ in done
              if ttft_slo_s is None or dr.first_token_t - dr.submit_t <= ttft_slo_s)
    tokens = sum(len(dr.tokens) for dr, _ in done)
    rec = {"leg": name, "offered": len(wave), "accepted": len(accepted),
           "shed": rejected, "done": len(done), "wall_s": round(wall, 4),
           "rate_rps": None if rate_rps is None else round(rate_rps, 4),
           "ttft_slo_s": None if ttft_slo_s is None else round(ttft_slo_s, 5),
           "throughput_rps": round(len(done) / wall, 4),
           "goodput_rps": round(met / wall, 4), "slo_met": met,
           "tokens_per_sec": round(tokens / wall, 3),
           "ttft_p50_s": round(statistics.median(ttfts), 5) if ttfts else None,
           "ttft_p99_s": (round(ttfts[min(len(ttfts) - 1, int(0.99 * len(ttfts)))], 5)
                          if ttfts else None),
           "conservation": cons, "drained_clean": drained, "pools_zero": pools,
           "open_spans": tracer.open_spans, "failovers": router.failovers,
           "flash_launches": launches, "whole_prompt_prefills": spans,
           "builds_after_prewarm": built["n_compiled_programs"],
           "loads_after_prewarm": built["n_loads"],
           "counters": {k: daemon.counters[k] for k in ("pump_faults", "pump_wedges")}}
    check(cons["conserved"] and cons["outstanding"] == 0
          and cons["submitted"] + cons["rejected"] == len(wave),
          f"(e) {name}: conservation broken {cons}")
    check(all(s == dr.tokens == list(dr.rr.generated) for dr, s in done),
          f"(e) {name}: a stream differs from its output (not exactly-once)")
    check(drained and tracer.open_spans == 0 and pools,
          f"(e) {name}: unclean drain (drained {drained}, open spans "
          f"{tracer.open_spans}, pools zero {pools})")
    check(launches == DEPTH * spans, f"(e) {name}: K3 launched {launches} times, "
          f"expected depth x whole-prompt prefills = {DEPTH * spans}")
    check(built["n_compiled_programs"] == 0 and built["n_loads"] == 0,
          f"(e) {name}: a build or load after the prewarm: {built}")
    return {**rec, "accepted_requests": accepted}


def phase_serving_tier(torch, fa, xent, port, tmp: Path) -> dict:
    """The host serving tier (router, replicas, weight watcher, daemon,
    tracer, telemetry) at the serving LM's full width, 3 replicas sharing
    the card: router_soak.py's story (a)-(d), bench_slo.py's open loop (e)
    and the tracer/telemetry cost (f).  One line per part."""
    from distributed_tensorflow_ibm_mnist_tpu_torch.serving import (
        DeadlineAwarePolicy,
        QueueFull,
        Router,
        ServingDaemon,
        WeightWatcher,
    )
    from distributed_tensorflow_ibm_mnist_tpu_torch.utils.chaos import (
        FaultInjector,
        FaultPlan,
        FaultSpec,
    )
    from distributed_tensorflow_ibm_mnist_tpu_torch.utils.telemetry import Telemetry
    from distributed_tensorflow_ibm_mnist_tpu_torch.utils.tracing import (
        CompileTracker,
        Tracer,
        validate_trace,
    )

    Trainer, RunConfig, get_model, InferenceEngine = port
    f32, bf16 = torch.float32, torch.bfloat16
    out: dict = {}

    # ---- (a) W1: the LM fitted in float32 and checkpointed; references
    cfg = RunConfig(**TIER_FIT, checkpoint_dir=str(tmp / "tier_ck"),
                    model_kwargs={**{k: TIER_MODEL[k] for k in ("dim", "depth", "heads",
                                                                 "attn")}, "dtype": f32})
    fits = {}
    trainer = Trainer(cfg, device="cuda")
    reset_counts(fa, xent)
    s1 = trainer.fit()
    torch.cuda.synchronize()
    fits["w1"] = {"steps": trainer.state.step, "launches": read_counts(fa, xent),
                  "train_loss": trainer.history[-1]["train_loss"],
                  "total_time_s": s1["total_time_s"]}
    step1, w1 = trainer.state.step, trainer._decode_params()
    trainer.close()
    wave1, bridge, wave2 = (tier_prompts(torch, s, n) for s, n in
                            ((11, TIER_WAVE), (12, TIER_BRIDGE), (13, TIER_WAVE)))

    def f32_engine(params, **kw):
        return tier_engine(get_model, InferenceEngine, torch, params, f32, **kw)

    want1 = tier_reference(torch, lambda: f32_engine(w1), wave1)

    # ---- (b) failover under chaos, calibrated like router_soak.py
    def warm(eng):
        eng.submit(*TIER_WARM[:1], max_new=TIER_WARM[1])
        while eng.has_work:
            eng.step()
        return eng

    calib = FaultInjector(FaultPlan())
    warm(f32_engine(w1, chaos=calib, stall_timeout_s=None)).close()
    n_warm = calib.events("serving-step")
    inj = FaultInjector(FaultPlan(seed=0, faults=(
        FaultSpec(site="serving-step", kind="transient", at=(3 * n_warm + 4,)),
        FaultSpec(site="router-dispatch", kind="io", at=(2,)),
        FaultSpec(site="weight-swap", kind="io", at=(0,)))))
    tracer = Tracer()

    def make_engine(tid):
        return warm(f32_engine(w1, stall_timeout_s=None, chaos=inj, tracer=tracer,
                               trace_tid=tid))

    router = Router(make_engine, TIER_REPLICAS, chaos=inj, tracer=tracer)
    streams: dict = {}
    spans0 = prefill_spans(tracer)
    reset_counts(fa, xent)
    t0 = time.perf_counter()
    rrs = [router.submit(p, max_new=b, callback=lambda rr, tok: streams.setdefault(
        rr.id, []).append(int(tok))) for p, b in wave1]
    router.run_until_done(max_steps=100_000)
    torch.cuda.synchronize()
    wave1_s = time.perf_counter() - t0
    k3_wave1 = read_counts(fa, xent)["flash_fwd"]
    dense1 = prefill_spans(tracer) - spans0
    failed = [rep.index for rep in router.replicas if rep.state == "failed"]
    check(all(rr.status == "done" for rr in rrs), "(b) a wave-1 request did not finish")
    check([list(rr.generated) for rr in rrs] == want1,
          "(b) wave 1 under chaos differs from the fault-free engine")
    check(all(streams.get(rr.id, []) == list(rr.generated) for rr in rrs),
          "(b) a stream differs from its output (not exactly-once)")
    check(router.failovers == 1 and failed == [1],
          f"(b) failovers {router.failovers}, failed replicas {failed} (want one: 1)")
    check(k3_wave1 == DEPTH * dense1, f"(b) K3 launched {k3_wave1} times, expected "
          f"depth x whole-prompt prefills = {DEPTH * dense1}")
    first_spawn = router.replicas[1].spawn_s
    respawn_s = router.restart(1)
    check(router.replicas[1].state == "healthy" and router.replicas[1].spawns == 2,
          "(b) restart did not respawn replica 1")
    radix = router.summary()
    out["b"] = {"phase": "serving_tier", "part": "b_failover", "replicas": TIER_REPLICAS,
                "engine": TIER_ENGINE, "buckets": list(TIER_BUCKETS), "dtype": "float32",
                "requests": len(rrs), "warm_steps": n_warm, "wall_s": round(wave1_s, 4),
                "failovers": router.failovers, "failed_replica": failed[0],
                "redispatches": sum(rr.redispatches for rr in rrs),
                "dispatch_excluded": sum(1 for rr in rrs if rr.excluded),
                "tokens_identical": True, "exactly_once": True,
                "flash_launches": k3_wave1, "whole_prompt_prefills": dense1,
                "radix_hits": radix["radix_hits"], "radix_misses": radix["radix_misses"],
                "spawn_s_first": round(first_spawn, 4), "spawn_s_restart": round(respawn_s, 4),
                "spawn_s_by_replica": [[round(s, 4) for s in r.spawn_history]
                                       for r in router.replicas]}
    emit(out["b"])

    # ---- (c) W2: the trainer resumes; hot swap with bridge traffic in flight
    trainer = Trainer(cfg.replace(resume=True), device="cuda")
    reset_counts(fa, xent)
    s2 = trainer.fit()
    torch.cuda.synchronize()
    fits["w2"] = {"steps": trainer.state.step - step1, "launches": read_counts(fa, xent),
                  "train_loss": trainer.history[-1]["train_loss"],
                  "total_time_s": s2["total_time_s"]}
    step2, w2 = trainer.state.step, trainer._decode_params()
    trainer.close()
    for name, fit in fits.items():
        steps, counts = fit["steps"], fit["launches"]
        check(counts["flash_bwd_fused"] == DEPTH * steps and counts["flash_bwd_grouped"]
              == counts["flash_bwd_dkv"] == counts["flash_bwd_dq"] == 0,
              f"(a) {name} fit: backward launches {counts}, expected K4 == depth x "
              f"{steps} steps and no other")
        check(math.isfinite(fit["train_loss"]), f"(a) {name}: non-finite loss")
    want2 = tier_reference(torch, lambda: f32_engine(w2), wave2)
    bridge_w1 = tier_reference(torch, lambda: f32_engine(w1), bridge)
    bridge_w2 = tier_reference(torch, lambda: f32_engine(w2), bridge)
    brs = [router.submit(p, max_new=b) for p, b in bridge]
    for _ in range(2):  # the bridge's decode genuinely starts
        router.step()
    watcher = WeightWatcher(cfg.checkpoint_dir, None, router)
    poll1 = watcher.poll()  # W2 found intact; the first swap aborted by chaos
    poll2 = watcher.poll()  # the straggler retried: rollout complete
    router.run_until_done(max_steps=100_000)
    check(poll1 is None and poll2 == step2 and router.swapped_steps == [step2]
          and all(r.weight_step == step2 for r in router.replicas),
          f"(c) rollout: polls {poll1}, {poll2}, swapped {router.swapped_steps}")
    check(all(rr.status == "done" for rr in brs), "(c) a bridge request dropped")
    check(all(list(rr.generated) in (bridge_w1[i], bridge_w2[i]) for i, rr in enumerate(brs)),
          "(c) a bridge output is neither the W1 nor the W2 reference")
    rrs2 = [router.submit(p, max_new=b) for p, b in wave2]
    router.run_until_done(max_steps=100_000)
    check([list(rr.generated) for rr in rrs2] == want2,
          "(c) wave 2 differs from W2's single-engine reference")
    check({rr.replica for rr in rrs2} == set(range(TIER_REPLICAS)),
          "(c) wave 2 did not reach every replica")
    dropped = sum(rr.status != "done" for rr in router.requests)
    check(dropped == 0, f"(c) {dropped} requests dropped")
    out["c"] = {"phase": "serving_tier", "part": "c_hot_swap", "step_w1": step1,
                "step_w2": step2, "polls": [poll1, poll2],
                "swapped_steps": list(router.swapped_steps), "bridge": len(brs),
                "bridge_on_w2": sum(list(rr.generated) == bridge_w2[i]
                                    for i, rr in enumerate(brs)),
                "wave2_replicas": sorted({rr.replica for rr in rrs2}),
                "dropped": dropped, "fits": fits, "chaos": inj.summary()}
    emit(out["c"])

    # ---- (d) the timeline
    router.close()
    path = tmp / "tier_trace.json"
    tracer.export_trace(str(path))
    problems = validate_trace(str(path))
    doc = json.loads(path.read_text())["traceEvents"]
    tracks = {e["args"]["name"] for e in doc if e.get("ph") == "M"
              and e.get("name") == "thread_name"}
    instants = {e["name"] for e in doc if e.get("ph") == "i"}
    want_instants = {"replica_spawn", "replica_failed", "failover_redispatch",
                     "dispatch_fault", "swap_aborted", "weight_swap"}
    check(problems == [], f"(d) the exported trace is invalid: {problems[:5]}")
    check({"router", *(f"replica {i}" for i in range(TIER_REPLICAS))} <= tracks,
          f"(d) missing tracks: {tracks}")
    check(want_instants <= instants, f"(d) missing instants: {want_instants - instants}")
    check(tracer.open_spans == 0, f"(d) {tracer.open_spans} spans open after the drain")
    out["d"] = {"phase": "serving_tier", "part": "d_trace", "events": len(doc),
                "dropped": tracer.dropped, "open_spans": tracer.open_spans,
                "tracks": len(tracks), "instants": sorted(instants & want_instants)}
    emit(out["d"])

    # ---- (e) the daemon over a fresh bf16 tier: calibrate R, then the
    # open loop at 0.5 R and 1.5 R, then a pump raise and a pump wedge
    def build(tracer=None, chaos=None):
        def make(tid):
            return tier_engine(get_model, InferenceEngine, torch, w2, bf16,
                               tracer=tracer, trace_tid=tid, chaos=chaos)
        return Router(make, TIER_REPLICAS, tracer=tracer, chaos=chaos)

    tier = (ServingDaemon, Tracer, CompileTracker, QueueFull)
    calib_leg = daemon_leg(torch, fa, xent, build, tier, "calibrate",
                           tier_prompts(torch, 21, TIER_CALIB))
    rate = calib_leg["done"] / calib_leg["wall_s"]
    p50 = calib_leg["ttft_p50_s"]
    legs = [calib_leg]
    for name, mult, slo_mult, seed in (("open_0.5R", 0.5, 20.0, 22), ("open_1.5R", 1.5, 4.0, 23)):
        legs.append(daemon_leg(
            torch, fa, xent, build, tier, name, tier_prompts(torch, seed, TIER_OPEN),
            rate_rps=mult * rate, ttft_slo_s=slo_mult * p50,
            policy=DeadlineAwarePolicy(concurrency=TIER_REPLICAS * TIER_ENGINE["slots"])))
    for kind in ("raise", "wedge"):
        pump = FaultInjector(FaultPlan(seed=5, faults=(
            FaultSpec(site="daemon-pump", kind=kind, at=(0,)),)))
        leg = daemon_leg(torch, fa, xent, build, tier, f"pump_{kind}",
                         tier_prompts(torch, 24, TIER_PUMP), chaos=pump,
                         liveness_s=60.0 if kind == "raise" else 2.0)
        check(leg["failovers"] == 1 and leg["done"] == TIER_PUMP,
              f"(e) pump_{kind}: failovers {leg['failovers']}, done {leg['done']}")
        legs.append(leg)
    # bf16 records agreement only: near-ties may flip between the paged
    # extend and K3 (ROADMAP.md queue 3, divergences 3 and 5)
    calib_ref = tier_reference(torch, lambda: tier_engine(
        get_model, InferenceEngine, torch, w2, bf16), tier_prompts(torch, 21, TIER_CALIB))
    got = [list(dr.tokens) for dr, _ in calib_leg["accepted_requests"]]
    agree = sum(a == b for g, w in zip(got, calib_ref) for a, b in zip(g, w))
    out["e"] = {"phase": "serving_tier", "part": "e_daemon", "dtype": "bf16",
                "service_rps": round(rate, 4), "ttft_p50_calibrated_s": p50,
                "bf16_token_agreement_vs_single_engine": round(
                    agree / sum(len(w) for w in calib_ref), 4),
                "legs": [{k: v for k, v in leg.items() if k != "accepted_requests"}
                         for leg in legs]}
    emit(out["e"])

    # ---- (f) the tracer's and telemetry's cost: the bf16 router's wave with
    # both off and both on, in interleaved pairs (ABBA order)
    tel = Telemetry(interval_s=0.05, jsonl_path=str(tmp / "tier_telemetry.jsonl"))
    on_tracer = Tracer()

    def build_f(on: bool):
        def make(tid):
            return tier_engine(get_model, InferenceEngine, torch, w2, bf16, trace_tid=tid,
                               **({"tracer": on_tracer, "telemetry": tel} if on else {}))
        return Router(make, TIER_REPLICAS, **({"tracer": on_tracer, "telemetry": tel}
                                              if on else {}))

    routers = {False: build_f(False), True: build_f(True)}
    for r in routers.values():
        r.prewarm()
    tracker = CompileTracker.install()
    built0 = tracker.snapshot()

    def wave_s(on: bool, wave) -> float:
        r = routers[on]
        torch.cuda.synchronize()
        t = time.perf_counter()
        rs = [r.submit(p, max_new=b) for p, b in wave]
        r.run_until_done(max_steps=100_000)
        torch.cuda.synchronize()
        check(all(x.status == "done" for x in rs), "(f) a request did not finish")
        return time.perf_counter() - t

    pairs = []
    for i in range(TIER_PAIRS):
        wave = tier_prompts(torch, 31 + i, 24)
        order = (False, True) if i % 2 == 0 else (True, False)
        t = {on: wave_s(on, wave) for on in order}
        pairs.append({"off_s": round(t[False], 4), "on_s": round(t[True], 4),
                      "ratio": round(t[True] / t[False], 4), "order": ["on" if o else "off"
                                                                        for o in order]})
    built = CompileTracker.delta(tracker.snapshot(), built0)
    for r in routers.values():
        r.close()
    tel.close()
    ratios = [p["ratio"] for p in pairs]
    check(built["n_compiled_programs"] == 0 and built["n_loads"] == 0,
          f"(f) a build or load after the prewarm: {built}")
    check(on_tracer.open_spans == 0 and tel.samples > 0,
          f"(f) open spans {on_tracer.open_spans}, telemetry samples {tel.samples}")
    out["f"] = {"phase": "serving_tier", "part": "f_overhead", "pairs": pairs,
                "ratio_median": statistics.median(ratios),
                "ratio_spread": round(max(ratios) - min(ratios), 4),
                "telemetry_samples": tel.samples, "trace_events": len(on_tracer.events()),
                "builds_after_prewarm": built["n_compiled_programs"],
                "loads_after_prewarm": built["n_loads"]}
    emit(out["f"])
    return {"fits": fits, "k3_wave1": k3_wave1, "dense_wave1": dense1,
            "daemon_launches": {leg["leg"]: leg["flash_launches"] for leg in legs}}



# ---------------------------------------------------------------- serving edge

# the serving LM at full width (TIER_MODEL) behind the tier's outer edge:
# the front door, the request journal, the autoscaler and the
# disaggregated prefill/decode tier.  EDGE_DEVICE and the widths below are
# module constants so the phase rehearses on the CPU at a toy width
EDGE_DEVICE = "cuda"
EDGE_MODEL = TIER_MODEL
EDGE_ENGINE = dict(slots=8, max_len=1024, kv_page_size=16)  # the radix trie on
EDGE_BUCKETS = SLICE_SEQS
EDGE_REPLICAS = 3
EDGE_VOCAB = 256
EDGE_WAIT_S = 300.0  # any single wait, join or drain: generous, never load-bearing
EDGE_NEW = 16  # (a) budget per request
EDGE_PARITY = 6  # (a) prompts of 3-16 tokens (under one page: never a radix hit)
EDGE_WIRE = 16  # (a) requests of the wire-cost wave, each way
EDGE_SSE_CLIENTS = 6  # (a) SSE clients connected through the pump fault
EDGE_FLOOD = 24  # (a) concurrent unary clients against a 4-deep admission bound
EDGE_CRASH_CLIENTS = 6  # (b) keyed SSE clients at the SIGKILL
EDGE_CRASH_NEW = 64
EDGE_JOURNAL_WAVE = 24  # (b) requests per fsync policy
EDGE_SCALE_WAVE = 48  # (c) the backlog
EDGE_LULL_S = 60.0  # (c) the longest wait for a scale-down in the lull
EDGE_DRIP = dict(long_len=448, long_new=16, short_len=24, short_new=8, n_longs=12,
                 n_shorts=6, short_every=3)  # (d): bench_disagg.py's drip, full width
EDGE_ROLES = ["prefill", "decode", "decode"]
EDGE_STEPS = 5000  # (d) router steps, at most


def edge_prompts(torch, seed: int, n: int, lo: int, hi: int) -> list:
    """``n`` prompts of ``lo``-``hi`` tokens of 1..vocab-1, from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(1, EDGE_VOCAB, (int(torch.randint(lo, hi + 1, (1,), generator=g)),),
                          generator=g).tolist() for _ in range(n)]


def edge_sampling(i: int):
    """Even requests greedy, odd ones seeded-sampled."""
    return None if i % 2 == 0 else {"temperature": 0.8, "top_k": 20, "seed": 100 + i}


def edge_engine(get_model, InferenceEngine, torch, dtype, role="both", **kw):
    """One replica's engine: the serving LM from its seed (every replica,
    and a child process, builds the same weights) in ``dtype``."""
    model = get_model("causal_lm", dtype=dtype, device=EDGE_DEVICE, **EDGE_MODEL)
    return InferenceEngine(model, buckets=EDGE_BUCKETS, device=EDGE_DEVICE, role=role,
                           **EDGE_ENGINE, **kw)


def edge_router(mods, torch, dtype, n=EDGE_REPLICAS, roles=None, **kw):
    """A prewarmed router of ``n`` replicas; ``kw`` reach every engine and
    (tracer, telemetry, chaos) the router too."""
    get_model, InferenceEngine, Router = mods["get_model"], mods["InferenceEngine"], mods["Router"]

    def make(tid, index):  # a scale-up's replica (index >= n) serves both roles
        role = roles[index] if roles is not None and index < n else "both"
        return edge_engine(get_model, InferenceEngine, torch, dtype, role=role,
                           trace_tid=tid, **kw)

    router = Router(make, n, roles=roles,
                    **{k: kw[k] for k in ("tracer", "telemetry", "chaos") if k in kw})
    router.prewarm()
    return router


def edge_drain(daemon, tracer, router, what: str) -> dict:
    """Drain a daemon, then gate: exact conservation, no open span, every
    pool at refcount zero."""
    check(daemon.drain(timeout=EDGE_WAIT_S), f"{what}: the drain timed out")
    cons = daemon.conservation()
    check(cons["conserved"] and cons["outstanding"] == 0, f"{what}: conservation {cons}")
    check(pools_refcount_zero(router), f"{what}: a pool is not at refcount zero")
    daemon.close()
    if tracer is not None:
        check(tracer.open_spans == 0, f"{what}: {tracer.open_spans} spans open")
    return cons


def sse_events(cli, prompt, max_new, **kw) -> dict:
    """One SSE request: its (event id, token) pairs, terminal, TTFT and wall."""
    t0 = time.perf_counter()
    pairs, ttft = [], None
    for tok in cli.stream(prompt, max_new, **kw):
        if ttft is None:
            ttft = time.perf_counter() - t0
        pairs.append((cli.last_event_id, tok))
    return {"pairs": pairs, "terminal": cli.last_terminal, "ttft_s": ttft,
            "wall_s": time.perf_counter() - t0}


def exactly_once(pairs, n_tokens) -> bool:
    """Event ids 0..n-1, each once, and as many as the terminal counts."""
    return [eid for eid, _ in pairs] == list(range(len(pairs))) and len(pairs) == n_tokens


def wire_wave(torch, daemon, port, prompts, over_http: bool, FrontDoorClient) -> dict:
    """``prompts`` all at once, one thread each, over SSE or
    ``daemon.stream``: TTFT p50/p99 and tokens/s."""
    import threading

    res: dict = {}

    def one(i, p):
        if over_http:
            r = sse_events(FrontDoorClient("127.0.0.1", port, timeout=EDGE_WAIT_S), p, 32)
            res[i] = (r["ttft_s"], len(r["pairs"]))
        else:
            t0 = time.perf_counter()
            dr = daemon.submit(p, 32)
            toks, ttft = [], None
            for tok in daemon.stream(dr, timeout=EDGE_WAIT_S):
                ttft = ttft if ttft is not None else time.perf_counter() - t0
                toks.append(tok)
            res[i] = (ttft, len(toks))

    threads = [threading.Thread(target=one, args=(i, p)) for i, p in enumerate(prompts)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=EDGE_WAIT_S)
    wall = time.perf_counter() - t0
    check(len(res) == len(prompts), "(a) a wire-wave request did not finish")
    ttfts = sorted(r[0] for r in res.values())
    return {"ttft_p50_s": round(statistics.median(ttfts), 6),
            "ttft_p99_s": round(ttfts[min(len(ttfts) - 1, int(0.99 * len(ttfts)))], 6),
            "tokens": sum(r[1] for r in res.values()), "wall_s": round(wall, 6),
            "tokens_per_s": round(sum(r[1] for r in res.values()) / wall, 3)}


def edge_frontdoor(torch, fa, xent, mods) -> dict:
    """(a): the front door over three bf16 replicas."""
    import threading

    FrontDoor, FrontDoorClient = mods["FrontDoor"], mods["FrontDoorClient"]
    ServingDaemon, SamplingParams = mods["ServingDaemon"], mods["SamplingParams"]
    bf16 = torch.bfloat16
    tracer, tel = mods["Tracer"](), mods["Telemetry"](interval_s=0.05)
    router = edge_router(mods, torch, bf16, tracer=tracer, telemetry=tel)
    tracker = mods["CompileTracker"].install()
    built0 = tracker.snapshot()
    daemon = ServingDaemon(router, max_queue=256, watchdog_interval_s=0.05).start()
    fd = FrontDoor(daemon).start_in_thread()
    cli = FrontDoorClient("127.0.0.1", fd.port, timeout=EDGE_WAIT_S)
    spans0 = prefill_spans(tracer)
    reset_counts(fa, xent)
    try:
        # unary == SSE == daemon.stream, greedy and seeded-sampled
        parity = 0
        for i, p in enumerate(edge_prompts(torch, 41, EDGE_PARITY, 3, 16)):
            for sampling in (None, {"temperature": 0.8, "top_k": 20, "seed": 300 + i}):
                kw = {} if sampling is None else {"sampling": sampling}
                unary = cli.generate(p, EDGE_NEW, **kw)
                check(cli.last_status == 200, f"(a) unary status {cli.last_status}: {unary}")
                sse = sse_events(cli, p, EDGE_NEW, **kw)
                check(sse["terminal"]["status"] == "done"
                      and exactly_once(sse["pairs"], sse["terminal"]["n_tokens"]),
                      f"(a) SSE stream {sse['terminal']}")
                dr = daemon.submit(p, EDGE_NEW, sampling=None if sampling is None
                                   else SamplingParams(**sampling))
                ref = list(daemon.stream(dr, timeout=EDGE_WAIT_S))
                check(unary["tokens"] == [t for _, t in sse["pairs"]] == ref,
                      f"(a) unary / SSE / daemon.stream differ for prompt {i} {sampling}")
                parity += 1
        # the wire's host cost: one wave over SSE and over daemon.stream, ABBA
        wave = edge_prompts(torch, 42, EDGE_WIRE, 64, 256)
        wire = {"sse": [], "daemon_stream": []}
        for over_http in (True, False, False, True):
            wire["sse" if over_http else "daemon_stream"].append(
                wire_wave(torch, daemon, fd.port, wave, over_http, FrontDoorClient))
        text = cli.metrics()
        check(cli.last_status == 200 and "dtm_frontdoor_requests" in text
              and "dtm_tokens_generated" in text,
              "(a) one /metrics scrape lacks the front door's or the tier's counters")
        health = cli.healthz()
        check(health["status"] == "ok" and health["healthy"] == EDGE_REPLICAS,
              f"(a) healthz {health.get('status')}")
    finally:
        fd.stop()
    k3 = read_counts(fa, xent)["flash_fwd"]
    dense = prefill_spans(tracer) - spans0
    cons = edge_drain(daemon, tracer, router, "(a) parity")
    check(k3 == DEPTH * dense and dense > 0,
          f"(a) K3 launched {k3} times, expected depth x whole-prompt prefills {DEPTH * dense}")
    built = mods["CompileTracker"].delta(tracker.snapshot(), built0)
    tel.close()

    # a daemon-pump raise while SSE clients are connected
    tracer2 = mods["Tracer"]()
    pump = mods["FaultInjector"](mods["FaultPlan"](seed=5, faults=(
        mods["FaultSpec"](site="daemon-pump", kind="raise", at=(0,)),)))
    router2 = edge_router(mods, torch, bf16, tracer=tracer2)
    daemon2 = ServingDaemon(router2, max_queue=256, chaos=pump,
                            watchdog_interval_s=0.05).start()
    fd2 = FrontDoor(daemon2).start_in_thread()
    streams: dict = {}

    def client(i, p):
        c = FrontDoorClient("127.0.0.1", fd2.port, timeout=EDGE_WAIT_S)
        kw = {} if edge_sampling(i) is None else {"sampling": edge_sampling(i)}
        streams[i] = sse_events(c, p, 32, **kw)

    try:
        threads = [threading.Thread(target=client, args=(i, p)) for i, p in
                   enumerate(edge_prompts(torch, 43, EDGE_SSE_CLIENTS, 32, 256))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=EDGE_WAIT_S)
    finally:
        fd2.stop()
    check(len(streams) == EDGE_SSE_CLIENTS and all(
        s["terminal"] is not None and s["terminal"]["status"] == "done"
        and exactly_once(s["pairs"], s["terminal"]["n_tokens"]) for s in streams.values()),
        "(a) an SSE stream through the pump fault did not end done exactly once")
    pump_faults = daemon2.counters["pump_faults"]
    check(pump_faults == 1 and router2.failovers == 1,
          f"(a) pump faults {pump_faults}, failovers {router2.failovers}")
    edge_drain(daemon2, tracer2, router2, "(a) pump fault")

    # backpressure: a 4-deep admission bound under a flood of unary clients
    tracer3 = mods["Tracer"]()
    router3 = edge_router(mods, torch, bf16, n=1, tracer=tracer3)
    daemon3 = ServingDaemon(router3, max_queue=4, watchdog_interval_s=0.05,
                            policy=mods["DeadlineAwarePolicy"](concurrency=4)).start()
    fd3 = FrontDoor(daemon3).start_in_thread()
    results: list = []

    def flood(p):
        c = FrontDoorClient("127.0.0.1", fd3.port, timeout=EDGE_WAIT_S)
        body = c.generate(p, EDGE_NEW, deadline_s=EDGE_WAIT_S)
        results.append((c.last_status, c.last_headers, body))

    try:
        warm = FrontDoorClient("127.0.0.1", fd3.port, timeout=EDGE_WAIT_S)
        check(warm.generate([1, 2, 3], EDGE_NEW).get("status") == "done",
              "(a) the backpressure tier's warm request failed")  # the wait predictor warms
        threads = [threading.Thread(target=flood, args=(p,)) for p in
                   edge_prompts(torch, 44, EDGE_FLOOD, 32, 256)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=EDGE_WAIT_S)
    finally:
        fd3.stop()
    codes = sorted(r[0] for r in results)
    rejected = [r for r in results if r[0] in (429, 503)]
    hinted = [r for r in rejected if "retry-after" in r[1]]
    check(len(results) == EDGE_FLOOD and set(codes) <= {200, 429, 503} and rejected,
          f"(a) flood status codes {codes}")
    check(all(r[1]["retry-after"].isdigit() and int(r[1]["retry-after"]) >= 1 for r in hinted)
          and hinted, "(a) a rejection without an integer Retry-After")
    cons3 = daemon3.conservation()
    check(cons3["submitted"] == 1 + codes.count(200),
          f"(a) submitted {cons3['submitted']} != accepted {1 + codes.count(200)}")
    cons3 = edge_drain(daemon3, tracer3, router3, "(a) backpressure")
    check(cons3["done"] == cons3["submitted"], f"(a) backpressure: {cons3}")
    check(built["n_compiled_programs"] == 0 and built["n_loads"] == 0,
          f"(a) a build or load after the prewarm: {built}")
    return {"phase": "serving_edge", "part": "a_frontdoor", "dtype": "bf16",
            "replicas": EDGE_REPLICAS, "engine": EDGE_ENGINE, "parity_requests": parity,
            "transports_identical": True, "wire": wire,
            "wire_ttft_p50_ratio": round(
                statistics.median(w["ttft_p50_s"] for w in wire["sse"])
                / statistics.median(w["ttft_p50_s"] for w in wire["daemon_stream"]), 4),
            "wire_tokens_per_s_ratio": round(
                statistics.median(w["tokens_per_s"] for w in wire["sse"])
                / statistics.median(w["tokens_per_s"] for w in wire["daemon_stream"]), 4),
            "flash_launches": k3, "whole_prompt_prefills": dense,
            "conservation": {k: cons[k] for k in ("submitted", "done", "cancelled", "failed")},
            "pump_fault": {"clients": EDGE_SSE_CLIENTS, "pump_faults": pump_faults,
                           "failovers": 1, "exactly_once": True},
            "backpressure": {"offered": EDGE_FLOOD, "codes": {c: codes.count(c) for c in set(codes)},
                             "retry_after": sorted({r[1]["retry-after"] for r in hinted}),
                             "rejected_with_hint": daemon3.counters["rejected_with_hint"],
                             "conserved": True},
            "metrics_bytes": len(text), "builds_after_prewarm": built["n_compiled_programs"],
            "loads_after_prewarm": built["n_loads"]}


def edge_crash_config(dtype_name: str) -> dict:
    return {"device": EDGE_DEVICE, "dtype": dtype_name, "model": EDGE_MODEL,
            "engine": EDGE_ENGINE, "buckets": list(EDGE_BUCKETS), "replicas": EDGE_REPLICAS}


def edge_daemon_from(cfg: dict, journal):
    """The (b) tier from its config: a journaled daemon over prewarmed
    replicas (the child's, and the parent's recovered one)."""
    import torch

    from distributed_tensorflow_ibm_mnist_tpu_torch.models import get_model
    from distributed_tensorflow_ibm_mnist_tpu_torch.serving import (
        InferenceEngine,
        Router,
        ServingDaemon,
    )

    dtype = getattr(torch, cfg["dtype"])

    def make(tid):
        model = get_model("causal_lm", dtype=dtype, device=cfg["device"], **cfg["model"])
        return InferenceEngine(model, buckets=tuple(cfg["buckets"]), device=cfg["device"],
                               trace_tid=tid, **cfg["engine"])

    router = Router(make, cfg["replicas"])
    router.prewarm()
    return ServingDaemon(router, max_queue=256, journal=journal, watchdog_interval_s=0.05)


def serve_child(directory: str) -> int:
    """``chip_smoke.py --serve-child DIR``: the (b) tier of ``DIR/config.json``
    with a journal (fsync ``always``), the front door and fsync'd telemetry;
    publishes its port in ``DIR/port`` and serves until it is killed."""
    import threading

    from distributed_tensorflow_ibm_mnist_tpu_torch.serving import FrontDoor, RequestJournal
    from distributed_tensorflow_ibm_mnist_tpu_torch.utils.telemetry import Telemetry

    work = Path(directory)
    cfg = json.loads((work / "config.json").read_text())
    daemon = edge_daemon_from(cfg, RequestJournal(str(work / "journal"),
                                                  fsync_policy="always")).start()
    fd = FrontDoor(daemon, keepalive_s=5.0).start_in_thread()
    tele = Telemetry(interval_s=0.1, jsonl_path=str(work / "telemetry.jsonl"), fsync=True)
    tele.register_source("daemon", daemon.summary)
    tele.sample()  # the black box holds a line before the first client connects

    def black_box():
        while True:
            time.sleep(0.1)
            tele.sample()

    threading.Thread(target=black_box, daemon=True).start()
    (work / "port.tmp").write_text(str(fd.port))
    os.replace(work / "port.tmp", work / "port")
    while True:  # the parent's SIGKILL is the only way out
        time.sleep(1.0)


def edge_crash(torch, mods, tmp: Path) -> dict:
    """(b): a child serves with a journal and is SIGKILLed while keyed SSE
    clients are mid-stream; the parent recovers from the journal alone and
    the clients resume; then a torn tail, then the journal's cost per fsync
    policy."""
    import signal
    import threading

    FrontDoor, FrontDoorClient = mods["FrontDoor"], mods["FrontDoorClient"]
    RequestJournal, recover, scan_journal = (mods["RequestJournal"], mods["recover"],
                                             mods["scan_journal"])
    digest, SamplingParams = mods["transcript_digest"], mods["SamplingParams"]
    cfg = edge_crash_config("float32")
    work = tmp / "crash"
    work.mkdir()
    (work / "config.json").write_text(json.dumps(cfg))
    jdir = str(work / "journal")
    err = open(work / "child.err", "w")
    t_spawn = time.perf_counter()
    child = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--serve-child",
                              str(work)], stdout=subprocess.DEVNULL, stderr=err)
    try:
        deadline = time.monotonic() + EDGE_WAIT_S
        while not (work / "port").exists():
            check(child.poll() is None, f"(b) the serving child died at start: "
                  f"{(work / 'child.err').read_text()[-2000:]}")
            check(time.monotonic() < deadline, "(b) the serving child did not start")
            time.sleep(0.05)
        spawn_s = time.perf_counter() - t_spawn
        port = int((work / "port").read_text())
        prompts = edge_prompts(torch, 51, EDGE_CRASH_CLIENTS, 16, 200)
        results: dict = {}
        lock = threading.Lock()

        def client(i):
            c = FrontDoorClient("127.0.0.1", port, timeout=EDGE_WAIT_S)
            kw = {} if edge_sampling(i) is None else {"sampling": edge_sampling(i)}
            rec = {"pairs": [], "terminal": None, "error": None, "last_event_id": None}
            with lock:
                results[i] = rec
            try:
                for tok in c.stream(prompts[i], EDGE_CRASH_NEW, idempotency_key=f"crash-{i}",
                                    deadline_s=EDGE_WAIT_S, **kw):
                    with lock:
                        rec["pairs"].append((c.last_event_id, tok))
                        rec["last_event_id"] = c.last_event_id
            except Exception as e:  # the SIGKILL severs the socket mid-read
                rec["error"] = type(e).__name__
            rec["terminal"] = c.last_terminal

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(EDGE_CRASH_CLIENTS)]
        for t in threads:
            t.start()
        # kill once streaming has begun and the journal (the generation
        # side's truth) still holds unretired work
        kill_deadline = time.monotonic() + EDGE_WAIT_S
        while time.monotonic() < kill_deadline:
            with lock:
                seen = sum(len(r["pairs"]) for r in results.values())
            if seen >= 2:
                scan = scan_journal(jdir)
                if any(v["retired"] is None for v in scan.requests.values()):
                    break
            time.sleep(0.005)
        child.send_signal(signal.SIGKILL)
        child.wait(timeout=60)
        t_kill = time.perf_counter()
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        err.close()
    for t in threads:
        t.join(timeout=EDGE_WAIT_S)
    with lock:
        tokens_at_kill = sum(len(r["pairs"]) for r in results.values())

    # recovery, in this process, from nothing but the journal directory
    t_rec = time.perf_counter()
    rec = recover(jdir, lambda: edge_daemon_from(cfg, RequestJournal(
        jdir, fsync_policy="always")), resubmit_timeout_s=EDGE_WAIT_S)
    recover_s = time.perf_counter() - t_rec
    incomplete = len(rec.requests)
    check(rec.wait(timeout=EDGE_WAIT_S), "(b) a replayed request did not finish")
    replay_s = time.perf_counter() - t_rec
    check(incomplete >= 1, "(b) no request was incomplete at the kill")
    daemon2 = rec.daemon
    fd2 = FrontDoor(daemon2, idempotency_bindings=rec.bindings).start_in_thread()
    try:
        resumed = 0
        for i in range(EDGE_CRASH_CLIENTS):
            got = results[i]
            if got["terminal"] is not None and got["terminal"].get("status") == "done":
                continue
            resumed += 1
            c = FrontDoorClient("127.0.0.1", fd2.port, timeout=EDGE_WAIT_S)
            kw = {} if edge_sampling(i) is None else {"sampling": edge_sampling(i)}
            for tok in c.stream(prompts[i], EDGE_CRASH_NEW, idempotency_key=f"crash-{i}",
                                last_event_id=got["last_event_id"], deadline_s=EDGE_WAIT_S,
                                **kw):
                got["pairs"].append((c.last_event_id, tok))
            got["terminal"] = c.last_terminal
    finally:
        fd2.stop()
    # the uncrashed reference: the same requests, fresh, on the recovered tier
    refs = [daemon2.submit(p, EDGE_CRASH_NEW, sampling=None if edge_sampling(i) is None
                           else SamplingParams(**edge_sampling(i)))
            for i, p in enumerate(prompts)]
    check(all(dr.wait(timeout=EDGE_WAIT_S) and dr.status == "done" for dr in refs),
          "(b) a reference request did not finish")
    lost = gaps = divergent = mismatched = 0
    for i, dr in enumerate(refs):
        got = results[i]
        lost += not (got["terminal"] is not None and got["terminal"].get("status") == "done")
        stitched: dict = {}
        for eid, tok in got["pairs"]:
            divergent += eid in stitched and stitched[eid] != tok
            stitched[eid] = tok
        ids = sorted(stitched)
        gaps += ids != list(range(len(dr.tokens)))
        mismatched += digest([stitched[k] for k in ids]) != digest(list(dr.tokens))
    check(lost == 0 and gaps == 0 and divergent == 0 and mismatched == 0,
          f"(b) lost {lost}, gapped {gaps}, divergent duplicates {divergent}, digests "
          f"differing {mismatched}")
    check(daemon2.drain(timeout=EDGE_WAIT_S) and daemon2.conservation()["conserved"],
          "(b) the recovered tier did not drain conserved")
    daemon2.close()
    tele_lines = sum(1 for ln in (work / "telemetry.jsonl").read_text().splitlines()
                     if ln.strip()) if (work / "telemetry.jsonl").exists() else 0
    check(tele_lines >= 1, "(b) the killed child's fsync'd telemetry is empty")

    # a torn tail: the retired record of one request is torn; the scan drops
    # exactly it and the reopened request replays to done
    tdir = str(work / "torn")
    torn = mods["FaultInjector"](mods["FaultPlan"](seed=0, faults=(
        mods["FaultSpec"](site="journal-write", kind="torn", at=(2,)),)))
    one = {**cfg, "replicas": 1}
    d = edge_daemon_from(one, RequestJournal(tdir, fsync_policy="always", chaos=torn))
    d.journal_hw_interval_s = 1e9  # admitted, the final mark, retired: 3 appends
    d.start()
    dr = d.submit(prompts[0], EDGE_NEW)
    check(dr.wait(timeout=EDGE_WAIT_S) and dr.status == "done", "(b) the torn leg's request")
    d.drain(timeout=EDGE_WAIT_S)
    d.close()
    scan = scan_journal(tdir)
    check(scan.records_dropped == 1 and scan.torn_tail and len(scan.incomplete()) == 1,
          f"(b) torn tail: {scan.report()}")
    rec2 = recover(tdir, lambda: edge_daemon_from(one, RequestJournal(tdir)))
    check(rec2.wait(timeout=EDGE_WAIT_S) and [r.dr.status for r in rec2.requests] == ["done"]
          and rec2.requests[0].dr.total_tokens == len(dr.tokens),
          "(b) the torn request did not replay to done")
    rec2.daemon.close()

    # the journal's cost per fsync policy: a daemon-native wave, the share of
    # its wall the appends took (self-measured: append_s is the appending
    # thread's CPU time plus the I/O it awaited) and one timed fsync
    policies = {}
    wave = edge_prompts(torch, 52, EDGE_JOURNAL_WAVE, 16, 256)
    for policy in ("never", "interval", "always"):
        j = RequestJournal(str(work / f"j_{policy}"), fsync_policy=policy)
        d = edge_daemon_from(cfg, j).start()
        t0 = time.perf_counter()
        drs = [d.submit(p, 32) for p in wave]
        check(all(x.wait(timeout=EDGE_WAIT_S) and x.status == "done" for x in drs),
              f"(b) the {policy} wave did not finish")
        wall = time.perf_counter() - t0
        st = j.stats()
        t_sync = time.perf_counter()
        j.sync()
        sync_ms = (time.perf_counter() - t_sync) * 1e3
        d.drain(timeout=EDGE_WAIT_S)
        d.close()
        policies[policy] = {"records": st["records"], "bytes": st["bytes"],
                            "fsyncs": st["fsyncs"], "append_s": round(st["append_s"], 6),
                            "wall_s": round(wall, 6),
                            "append_share": round(st["append_s"] / wall, 6),
                            "us_per_append": round(st["append_s"] / st["records"] * 1e6, 3),
                            "one_fsync_ms": round(sync_ms, 4)}
    check(policies["interval"]["append_share"] <= 0.02,
          f"(b) the interval policy's append share {policies['interval']['append_share']} > 2%")
    return {"phase": "serving_edge", "part": "b_crash", "dtype": "float32",
            "clients": EDGE_CRASH_CLIENTS, "max_new": EDGE_CRASH_NEW,
            "child_spawn_s": round(spawn_s, 3), "tokens_seen_at_kill": tokens_at_kill,
            "incomplete_at_kill": incomplete, "recover_s": round(recover_s, 4),
            "replay_done_s": round(replay_s, 4),
            "kill_to_replayed_s": round(time.perf_counter() - t_kill, 4),
            "clients_resumed": resumed, "lost": lost, "gaps": gaps,
            "divergent_duplicates": divergent, "digest_parity": True,
            "scan": rec.scan.report(), "telemetry_lines_post_mortem": tele_lines,
            "torn_tail": {"records_dropped": scan.records_dropped, "torn_tail": scan.torn_tail,
                          "replayed_to_done": True},
            "journal": policies}


def edge_autoscale(torch, fa, xent, mods) -> dict:
    """(c): a backlog scales a one-replica bf16 tier up, a lull retires a
    replica (drain first), a second backlog brings it back warm."""
    ServingDaemon, Autoscaler = mods["ServingDaemon"], mods["Autoscaler"]
    tracer = mods["Tracer"]()
    router = edge_router(mods, torch, torch.bfloat16, n=1, tracer=tracer)
    tracker = mods["CompileTracker"].install()
    built0 = tracker.snapshot()
    daemon = ServingDaemon(router, max_queue=256, watchdog_interval_s=0.02).start()
    asc = Autoscaler(daemon, min_replicas=1, max_replicas=EDGE_REPLICAS,
                     up_backlog_per_slot=1.0, down_occupancy=0.25, hysteresis_up=2,
                     hysteresis_down=4, interval_s=0.05)
    spans0 = prefill_spans(tracer)
    reset_counts(fa, xent)
    asc.start()
    waves = []
    try:
        for seed in (61, 62):
            downs0 = sum(e["action"] == "down" for e in asc.events)
            drs = [daemon.submit(p, 32) for p in
                   edge_prompts(torch, seed, EDGE_SCALE_WAVE, 16, 256)]
            check(all(dr.wait(timeout=EDGE_WAIT_S) for dr in drs), "(c) a request timed out")
            check(all(dr.status == "done" for dr in drs), "(c) a request was dropped")
            waves.append(len(drs))
            # the lull: wait for a retire to drain and close
            deadline = time.monotonic() + EDGE_LULL_S
            while time.monotonic() < deadline and not (
                    sum(e["action"] == "down" for e in asc.events) > downs0
                    and not router._retiring):
                time.sleep(0.02)
    finally:
        asc.stop()
    summ = asc.summary()
    downs = [e for e in asc.events if e["action"] == "down"]
    ups = [e for e in asc.events if e["action"] == "up"]
    check(summ["scale_ups"] >= 2 and summ["scale_downs"] >= 1 and not router._retiring,
          f"(c) the autoscaler's actions: {summ}")
    check(summ["warm_ups"] >= 1, "(c) no scale-up reused a retired replica")
    k3 = read_counts(fa, xent)["flash_fwd"]
    dense = prefill_spans(tracer) - spans0
    cons = edge_drain(daemon, tracer, router, "(c)")
    built = mods["CompileTracker"].delta(tracker.snapshot(), built0)
    check(cons["done"] == cons["submitted"] == sum(waves) and cons["failed"] == 0,
          f"(c) conservation {cons}")
    check(built["n_compiled_programs"] == 0 and built["n_loads"] == 0,
          f"(c) a build or load after the prewarm: {built}")
    check(k3 == DEPTH * dense, f"(c) K3 {k3} != depth x whole-prompt prefills {DEPTH * dense}")
    return {"phase": "serving_edge", "part": "c_autoscale", "dtype": "bf16",
            "waves": waves, "actions": [(e["action"], e["replica"], e["warm"]) for e in asc.events],
            "scale_ups": summ["scale_ups"], "scale_downs": summ["scale_downs"],
            "warm_ups": summ["warm_ups"], "spawn_s": summ["spawn_s"],
            "spawn_s_cold": [round(e["spawn_s"], 6) for e in ups if not e["warm"]],
            "spawn_s_warm": [round(e["spawn_s"], 6) for e in ups if e["warm"]],
            "retired": [e["replica"] for e in downs], "retires": router.retires,
            "chip_seconds": summ["chip_seconds"], "dropped": 0,
            "conservation": {k: cons[k] for k in ("submitted", "done", "cancelled", "failed")},
            "flash_launches": k3, "whole_prompt_prefills": dense,
            "builds_after_prewarm": built["n_compiled_programs"],
            "loads_after_prewarm": built["n_loads"]}


def drip_arrivals(torch, with_longs: bool) -> list:
    """bench_disagg.py's schedule at full width: long k arrives at step k,
    short j at step 1 + 3j, longs first within a step."""
    d = EDGE_DRIP
    longs = edge_prompts(torch, 71, d["n_longs"], d["long_len"], d["long_len"])
    shorts = edge_prompts(torch, 72, d["n_shorts"], d["short_len"], d["short_len"])
    arr = [{"step": k, "kind": "long", "prompt": p, "max_new": d["long_new"]}
           for k, p in enumerate(longs) if with_longs]
    arr += [{"step": 1 + d["short_every"] * j, "kind": "short", "prompt": p,
             "max_new": d["short_new"]} for j, p in enumerate(shorts)]
    return sorted(arr, key=lambda a: (a["step"], a["kind"] != "long"))


def drip_drive(router, arrivals) -> list:
    """The step-pumped loop: each arrival just before its step; the step
    of every request's first delivered token."""
    cur, recs, i = [0], [], 0
    while i < len(arrivals) or router.outstanding:
        while i < len(arrivals) and arrivals[i]["step"] <= cur[0]:
            a = arrivals[i]
            i += 1
            rec = {"kind": a["kind"], "submit_step": cur[0], "first_step": None, "stream": []}

            def cb(rr, tok, rec=rec):
                rec["stream"].append(int(tok))
                if rec["first_step"] is None:
                    rec["first_step"] = cur[0]

            rec["rr"] = router.submit(a["prompt"], a["max_new"], callback=cb)
            recs.append(rec)
        router.step()
        cur[0] += 1
        check(cur[0] <= EDGE_STEPS, f"(d) the drip ran past {EDGE_STEPS} steps")
    check(all(r["rr"].status == "done" for r in recs), "(d) a drip request did not finish")
    return recs


def short_ttft_p99(recs) -> float:
    steps = sorted(r["first_step"] - r["submit_step"] + 1 for r in recs if r["kind"] == "short")
    return float(steps[min(len(steps) - 1, int(0.99 * len(steps)))])


def k3_by_replica(fa, router, packets: list) -> dict:
    """Count K3 launches per replica (each engine's step and landing, on
    the one thread that pumps the router) and record each landed packet."""
    counts = {rep.index: 0 for rep in router.replicas}
    for rep in router.replicas:
        eng = rep.engine

        def step(orig=eng.step, i=rep.index):
            n0 = fa.flash_attention_fwd.launches
            try:
                return orig()
            finally:
                counts[i] += fa.flash_attention_fwd.launches - n0

        def admit(packet, orig=eng.admit_prefilled, i=rep.index):
            n0 = fa.flash_attention_fwd.launches
            try:
                ok = orig(packet)
            finally:
                counts[i] += fa.flash_attention_fwd.launches - n0
            if ok:
                packets.append({"pages": packet.n_pages, "bytes": packet.payload_bytes,
                                "gather_ms": packet.gather_s * 1e3,
                                "install_ms": (packet.install_s or 0.0) * 1e3})
            return ok

        eng.step, eng.admit_prefilled = step, admit
    return counts


def edge_disagg(torch, fa, xent, mods) -> dict:
    """(d): prefill(1) + decode(2) against 3 x both on the mixed drip."""
    f32, bf16 = torch.float32, torch.bfloat16
    out: dict = {"phase": "serving_edge", "part": "d_disagg", "roles": EDGE_ROLES,
                 "drip": EDGE_DRIP}
    tracer = mods["Tracer"]()
    disagg = edge_router(mods, torch, f32, roles=EDGE_ROLES, tracer=tracer)
    packets: list = []
    counts = k3_by_replica(fa, disagg, packets)
    control = drip_drive(disagg, drip_arrivals(torch, with_longs=False))
    h0 = disagg.handoffs
    spans0 = prefill_spans(tracer)
    reset_counts(fa, xent)
    counts.update({i: 0 for i in counts})
    loaded = drip_drive(disagg, drip_arrivals(torch, with_longs=True))
    k3_total = read_counts(fa, xent)["flash_fwd"]
    dense = prefill_spans(tracer) - spans0
    handoffs = disagg.handoffs - h0
    check(handoffs == len(loaded), f"(d) handoffs {handoffs} != requests {len(loaded)}")
    check(all(r["stream"] == list(r["rr"].generated) for r in loaded),
          "(d) a disaggregated stream is not exactly-once")
    by_role = {"prefill": counts[0], "decode": [counts[1], counts[2]]}
    check(counts[1] == counts[2] == 0, f"(d) K3 ran on a decode replica: {by_role}")
    check(counts[0] == k3_total == DEPTH * dense and dense >= EDGE_DRIP["n_longs"],
          f"(d) K3 {by_role}, total {k3_total}, whole-prompt prefills {dense}")
    check(pools_refcount_zero(disagg) and all(not rep.engine._outbox
                                              for rep in disagg.replicas),
          "(d) a disaggregated pool is not at refcount zero")
    disagg.close()
    check(tracer.open_spans == 0, f"(d) {tracer.open_spans} spans open")
    mono = edge_router(mods, torch, f32)
    mcounts = k3_by_replica(fa, mono, [])
    mono_recs = drip_drive(mono, drip_arrivals(torch, with_longs=True))
    mono.close()
    want = [list(r["rr"].generated) for r in mono_recs]
    check([list(r["rr"].generated) for r in loaded] == want,
          "(d) the float32 disaggregated streams differ from the monolithic tier's")
    p99 = {"control": short_ttft_p99(control), "loaded": short_ttft_p99(loaded),
           "monolithic": short_ttft_p99(mono_recs)}
    check(p99["loaded"] <= 1.15 * p99["control"],
          f"(d) short TTFT p99 in router steps: loaded {p99['loaded']} > 1.15 x control "
          f"{p99['control']}")
    # a kv-handoff fault on the first delivery
    inj = mods["FaultInjector"](mods["FaultPlan"](seed=5, faults=(
        mods["FaultSpec"](site="kv-handoff", kind="io", at=(0,)),)))
    chaos = edge_router(mods, torch, f32, roles=EDGE_ROLES, chaos=inj)
    recs_x = drip_drive(chaos, drip_arrivals(torch, with_longs=True))
    check(chaos.handoff_faults == 1 and all(
        r["stream"] == list(r["rr"].generated) for r in recs_x)
        and [list(r["rr"].generated) for r in recs_x] == want,
        f"(d) kv-handoff fault: faults {chaos.handoff_faults}, streams not exactly-once "
        "or not the monolithic tier's")
    check(pools_refcount_zero(chaos), "(d) a pool held pages after the handoff fault")
    redispatches = sum(r["rr"].redispatches for r in recs_x)
    chaos.close()
    # bf16: agreement between the tiers, recorded (queue 3, items 3 and 5)
    bf = []
    for roles in (EDGE_ROLES, None):
        r = edge_router(mods, torch, bf16, roles=roles)
        bf.append([list(x["rr"].generated) for x in
                   drip_drive(r, drip_arrivals(torch, with_longs=True))])
        r.close()
    agree = sum(a == b for g, w in zip(*bf) for a, b in zip(g, w))
    out.update({
        "requests": len(loaded), "handoffs": handoffs, "tokens_identical_f32": True,
        "flash_launches_by_role": by_role, "flash_launches_monolithic": sum(mcounts.values()),
        "whole_prompt_prefills": dense,
        "short_ttft_p99_steps": p99,
        "ttft_ratio": round(p99["loaded"] / p99["control"], 4),
        "kv_handoff_fault": {"faults": 1, "redispatches": redispatches, "exactly_once": True,
                             "pools_zero": True},
        "handoff_packets": {
            "n": len(packets), "pages_per_packet": statistics.median(p["pages"] for p in packets),
            "bytes_per_packet_p50": statistics.median(p["bytes"] for p in packets),
            "gather_ms_p50": round(statistics.median(p["gather_ms"] for p in packets), 4),
            "gather_ms_max": round(max(p["gather_ms"] for p in packets), 4),
            "install_ms_p50": round(statistics.median(p["install_ms"] for p in packets), 4),
            "install_ms_max": round(max(p["install_ms"] for p in packets), 4)},
        "bf16_token_agreement": round(agree / sum(len(w) for w in bf[1]), 4)})
    return out


def phase_serving_edge(torch, fa, xent, tmp: Path) -> dict:
    """The serving tier's edge at the serving LM's full width: (a) the
    front door, (b) a SIGKILL and the journal's recovery, (c) the
    autoscaler, (d) the disaggregated tier.  One line per part."""
    from distributed_tensorflow_ibm_mnist_tpu_torch import serving
    from distributed_tensorflow_ibm_mnist_tpu_torch.models import get_model
    from distributed_tensorflow_ibm_mnist_tpu_torch.utils import chaos
    from distributed_tensorflow_ibm_mnist_tpu_torch.utils.telemetry import Telemetry
    from distributed_tensorflow_ibm_mnist_tpu_torch.utils.tracing import CompileTracker, Tracer

    mods = {name: getattr(serving, name) for name in serving.__all__}
    mods.update(get_model=get_model, Telemetry=Telemetry, Tracer=Tracer,
                CompileTracker=CompileTracker, FaultInjector=chaos.FaultInjector,
                FaultPlan=chaos.FaultPlan, FaultSpec=chaos.FaultSpec)
    out = {}
    for part, run in (("a", lambda: edge_frontdoor(torch, fa, xent, mods)),
                      ("b", lambda: edge_crash(torch, mods, tmp)),
                      ("c", lambda: edge_autoscale(torch, fa, xent, mods)),
                      ("d", lambda: edge_disagg(torch, fa, xent, mods))):
        t0 = time.perf_counter()
        out[part] = run()
        out[part]["part_s"] = round(time.perf_counter() - t0, 3)
        emit(out[part])
    return out


MMA_SYNC = "tensor-core bf16: mma.sync on cp.async-fed tiles"
DESIGN = {"flash_fwd": MMA_SYNC, "flash_bwd_fused": MMA_SYNC, "flash_bwd_grouped": MMA_SYNC,
          "flash_bwd_dkv": MMA_SYNC,
          "flash_bwd_dq": "tensor-core bf16: wgmma on TMA-fed tiles, setmaxnreg",
          "xent_fwd": "scalar", "xent_bwd": "scalar"}


def main() -> int:
    if sys.argv[1:2] == ["--preempt-child"]:  # (b)'s child process
        return preempt_child(sys.argv[2])
    if sys.argv[1:2] == ["--serve-child"]:  # serving_edge (b)'s child process
        return serve_child(sys.argv[2])
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    # every synthetic split of the run (and of its child processes and
    # ranks) renders with the native C++ renderer unless the caller says
    # otherwise: ~20x the numpy renderer, which took ~70 s of set-up
    os.environ.setdefault("DTM_DATA_BACKEND", "native")
    try:
        from distributed_tensorflow_ibm_mnist_tpu_torch.core.generate import (
            init_cache,
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
        from distributed_tensorflow_ibm_mnist_tpu_torch.core.generate import _pick_rows
        from distributed_tensorflow_ibm_mnist_tpu_torch.serving import (
            InferenceEngine,
            SamplingParams,
        )
        from distributed_tensorflow_ibm_mnist_tpu_torch.serving import sampling
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
    features = phase_serving_features(
        torch, fa, xent,
        (get_model, InferenceEngine, make_prefill, SamplingParams, sampling, _pick_rows))
    spec_quant_chunk = phase_serving_spec_quant_chunk(
        torch, fa, xent,
        (get_model, InferenceEngine, make_prefill, SamplingParams, sampling, init_cache))
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
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ft_") as tmp:
        ft = phase_fault_tolerant_training(torch, fa, xent, (Trainer, get_preset, RunConfig),
                                           steps_mod, Path(tmp))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tier_") as tmp:
        tier = phase_serving_tier(torch, fa, xent,
                                  (Trainer, RunConfig, get_model, InferenceEngine), Path(tmp))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_edge_") as tmp:
        edge = phase_serving_edge(torch, fa, xent, Path(tmp))

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

    def ft_xent_launches(name):
        """K1/K2 on the fault_tolerant_training runs: every fit of (a), and
        each stream fit of (d), at LeNet's (128, 10)."""
        d = ft["d"]
        return {"a_all_fits": ft["a"]["launches_all_runs"][name],
                **{f"d_stream_{c}": d[c]["launches"][name] for c in ("chunk8", "chunk1")}}

    k3_entry = entry("flash_fwd", "flash_fwd.cu", "ops/flash_attention.py:208",
                     serving["flash_launches"], k3["max_abs_err"], k3["timed"], "by_seq")
    # K3 at the LM training shape, launches on the LM training run
    k3_entry["lm_training"] = {**{k: flash_timed["flash_fwd"][k] for k in timing_keys},
                               "launches": lm["launches"]["flash_fwd"]}
    k3_entry["vit_training"] = on_vit("flash_fwd", vit_kernels["fwd_err"])
    # K3's launches on each serving_features run (every whole-prompt prefill)
    k3_entry["serving_features"] = {
        f"{sub}_{run}": rec["flash_launches"]
        for sub, runs in features.items() for run, rec in runs.items()}
    # ... and on each serving_spec_quant_chunk run: (e) int8, (f) spec, (g)
    # chunked prefill (0: every prompt goes through the extend program)
    k3_entry["serving_spec_quant_chunk"] = {
        **{f"e_{name}": rec["flash_launches"] for name, rec in spec_quant_chunk["e"].items()
           if "flash_launches" in rec},
        **{f"f_{group}_{name}": rec["flash_launches"]
           for group, runs in spec_quant_chunk["f"].items() for name, rec in runs.items()},
        **{f"g_{name}": rec["flash_launches"] for name, rec in spec_quant_chunk["g"].items()}}
    # K3/K4 on the fault_tolerant_training (e) LM runs, plain and block_remat
    # (K3 again in each block's recompute)
    ft_lm = {name: {k: r["launches"][k] for k in ("flash_fwd", "flash_bwd_fused")}
             for name, r in ft["e"]["lm"].items()}
    k3_entry["fault_tolerant_training_lm"] = {n: c["flash_fwd"] for n, c in ft_lm.items()}
    k4_entry = bwd_entry("flash_bwd_fused", "ops/flash_attention.py:340",
                         lm["launches"]["flash_bwd_fused"])
    k4_entry["fault_tolerant_training_lm"] = {n: c["flash_bwd_fused"] for n, c in ft_lm.items()}
    # K3 on the serving tier: (b)'s wave under chaos and each (e) daemon
    # leg, depth x whole-prompt prefills each; the float32 fits' forward too.
    # K4 on the tier's W1 and W2 fits (float32, S=512, the fused route)
    k3_entry["serving_tier"] = {
        "b_wave1": tier["k3_wave1"], "b_whole_prompt_prefills": tier["dense_wave1"],
        **{f"e_{name}": n for name, n in tier["daemon_launches"].items()},
        **{f"a_fit_{name}": f["launches"]["flash_fwd"] for name, f in tier["fits"].items()}}
    k4_entry["serving_tier_fits"] = {name: f["launches"]["flash_bwd_fused"]
                                     for name, f in tier["fits"].items()}
    # K3 on the serving edge: (a) the front door's tier and (c) the
    # autoscaled tier (depth x whole-prompt prefills each), and (d) the
    # disaggregated tier by replica role (decode replicas: 0) beside the
    # monolithic tier's
    k3_entry["serving_edge"] = {
        "a_frontdoor": edge["a"]["flash_launches"], "c_autoscale": edge["c"]["flash_launches"],
        "d_disagg_by_role": edge["d"]["flash_launches_by_role"],
        "d_monolithic": edge["d"]["flash_launches_monolithic"]}
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
         "vit_training": on_vit_xent("xent_fwd"), "dp_launches": dp_launches(0),
         "fault_tolerant_training": ft_xent_launches("xent_fwd"),
         "launch_floor_ms": xk["launch_floor_ms"]},
        {**entry("xent_bwd", "xent.cu", "ops/xent.py:53", counts["xent_bwd"],
                 xk["max_abs_err"]["xent_bwd"], xk["timed"]["xent_bwd"], "by_shape"),
         "vit_training": on_vit_xent("xent_bwd"), "dp_launches": dp_launches(1),
         "fault_tolerant_training": ft_xent_launches("xent_bwd"),
         "launch_floor_ms": xk["launch_floor_ms"]},
    ], "launch_floor_ms": xk["launch_floor_ms"]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                             "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
