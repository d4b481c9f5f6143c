#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

Builds every kernel from ``src/repro_torch/csrc``, drives the port's main
paths (online path selection, the serving runtime around it, six served
language models, and training InternLM2-1.8B, Llama-4-Scout and
RecurrentGemma-2B) through the entry points a user calls, and holds every
kernel against its plain torch version on the card.  Phases, one JSON
line each:

1. ``device``: the card (``nvidia-smi`` name and power limit) and the kernel
   build time with ptxas' registers and spills for every kernel, and the
   kernels whose wgmma instructions ptxas serialized.
2. ``kernels``: each kernel against its plain version (the attention
   kernels element by element in bf16, and at 1e-5 on the same inputs in
   fp32; see ``attention_kernels`` and ``gmm_kernels``; rglru_scan bit for
   bit, ``scan_kernels``, with its plan and the route its C launcher
   reported, and no ptxas spill in ``rglru_scan.cu``),
   with its time per call (CUDA events around back-to-back calls, so at
   small shapes the wrapper's host overhead is part of it), the plain
   version's time, the least time the card could take (``bound_ms``) and
   one PyTorch call that computes the same function as a library yardstick
   the port never calls: ``torch.topk(q @ c.T, k)`` for retrieval_topk,
   ``scaled_dot_product_attention`` for the attention kernels (bf16, at the
   served and long prefill and decode shapes of the attention models: the
   encoder-decoder's non-causal encoder and cross-attention, the latter
   one row at a time at decode, among them) and
   ``torch.bmm`` for moe_gmm (at the Llama-4-Scout prefill and decode
   shapes); rglru_scan and dsqe_score have no such call.  Three kernels
   have two variants, chosen by one rule each (``kernel.route``): moe_gmm,
   flash_attention and decode_attention a tensor-core one (bf16) and an
   FFMA one (fp32, and bf16 shapes the tensor-core one cannot take).  Every
   checked shape must take the first, and the second is timed beside it on
   the same inputs through its explicit route.  retrieval_topk and
   dsqe_score share one rule on k: the tiled route (k <= 64) or the select
   route (above), for every width; each checked shape must move its route's
   counter (deployment k 100 and knn 100 take the select route, d 2049 the
   tiled one with 4-byte row copies), and the first port's warp-per-row
   kernel is timed beside them on the same inputs where it takes them (its
   explicit route).  The selection and decode_attention rows also log their
   grid (query tile and splits) and ``graph_ms``, device time per call
   replayed from a CUDA graph, beside the library's.  decode_attention's
   lse twin (``decode_attention_lse``) runs on caches cut into 2 or 16
   slices by ``slot0``, as each rank of a cache sharded along its slots
   runs it: every slice against the plain twin, a slice past cache_len
   exactly 0 with lse NEG_INF, and the slices merged by lse against the
   whole-cache kernel (``split_row``).
3. ``serve``: online path selection.  ``handle_batch`` over the held-out
   queries under mixed SLOs, with the launch counters set to 0 just before
   (after two timed warm-up ``select_batch`` calls on the same batch) and
   read just after.  Every request must be answered, retrieval_topk must
   have launched once per selection pass, all on the tiled variant, and
   every row must decide as the
   same selector's numpy engine does.  ``select_batch`` runs retrieve +
   score as two stages (as the reference's fused program does), so
   dsqe_score launches no time on the served path; after the counters are
   read it is run once on the selector's stage state and must reproduce the
   fused pass's scores and set ids (``dsqe_score_check_launches``: 1).
4. ``tenants``: ``build_multi_server(["automotive", "smarthome"])`` behind
   the ``TenantRouter`` (``drive_router_async``): four tenants with Zipf(1.1)
   shares of every held-out query, in the deadline, standard and batch SLO
   classes, on two admission shards.  The accounting identities (offered ==
   admitted + shed, admitted == served + failed, per tenant and summed), a
   typed reason for every shed request, and per domain every served row
   deciding as that domain's numpy engine.  Mixed-domain buckets select
   through the domain-sharded pass, which launches no selection kernel.
   Then a single-domain router over the serve phase's selector: one tiled
   retrieval_topk per bucket.
5. ``adaptation``: ``build_server("smarthome")`` with the adaptation plane
   pumped by hand.  A wave at a 4 s SLO, then the edge device throttles
   (tflops and bandwidth / 4) and waves are served and the plane pumped
   until it swaps a re-explored table in; the swapped rows must be
   evaluated, and selection and serving after the swap must decide as a
   numpy twin built on the new table.  Then 2 reader threads run the
   kernel-backed pass while 24 swaps publish: every decision's expected
   latency must belong to the version it reports, and
   ``kernel_trace_count`` must not move.
6. ``placements``: ``serve --placements --use-kernel --batch``, the
   placement-extended path space served in one ``handle_batch`` against the
   numpy engine; P and the placed paths are logged.
   In phases 4-6 the launch counters are set to 0 just before each driven
   run and read just after: tiled retrieval_topk launches must equal the
   kernel-backed passes (counted apart, at the selector), dsqe_score none.
7. ``retrieval``: context retrieval at deployment size, the store's device
   path ``VectorStore(emb, device="cuda").search_batch(Q, k,
   use_kernel=True)`` over 1 500 007 chunks x d 256 for 64 queries, at k 16
   (tiled route) and k 100 (select route) (``retrieval_phase``).  On a
   corpus of integers in [-3, 3] (exact fp32 products) with planted
   duplicate rows, ids and scores equal the host ``search_batch`` exactly
   and every tie gives its lowest ids; on unit rows ids are equal wherever
   the host's k-th and (k+1)-th scores part by more than 1e-5, scores
   within 1e-5.  One launch per call on the route's counter, and a second
   call reuses the resident corpus.  Logged: the entry point's time per
   call, the kernel's by CUDA events and from a graph, the host path's, the
   plain version's and ``torch.topk(q @ c.T, k)``'s, the bound and the
   grid.  ``--seed`` seeds both corpora (default 0).
8. ``model``: the edge-tier LM, InternLM2-1.8B at its published widths in
   bf16 with seeded random weights, served through
   ``launch.steps.build_prefill_step`` / ``build_decode_step``: a prefill of
   8 prompts of 1024 tokens, then 150 greedy decode steps (the system's
   nominal response length).  The counters are set to 0 before each and
   read after: 24 flash_attention launches for the prefill, 24 x 150
   decode_attention launches for the decode, all on the tensor-core
   variants (as every moe_gmm, flash_attention and decode_attention launch
   of the served models must be).  Decode logits at three steps must
   match the full forward's last-token logits (rel < 2e-2), and no logit
   may be NaN.
9. ``moe_model``: the MoE cloud tier, Llama-4-Scout at its published widths
   with 12 of 48 layers (``moe_phase``): exact moe_gmm / flash / decode
   launch counts, the share of assignments dropped by capacity, and
   prefill -> decode on a dropless twin.
10. ``hybrid_model``: the hybrid edge tier, RecurrentGemma-2B whole
   (``hybrid_phase``): exact rglru_scan / flash / decode launch counts (the
   scan's on the route ``scan_plan`` names) and prefill -> decode through a
   wrapped ring.
11. ``xlstm_model``: the smallest edge SLM, xLSTM-125M whole
   (``xlstm_phase``): no attention launches, prefill -> decode by teacher
   forcing (the mLSTM prefill takes whole 256-token chunks only).
12. ``encdec_model``: SeamlessM4T-medium whole (``encdec_phase``): 4096
   stub audio frames encoded once by the prefill step, a 128-token decoder
   prefix, exact flash / decode launch counts (encoder, decoder and cross
   attention) and prefill -> decode on the served encoder output.
13. ``train_model``: InternLM2-1.8B trained at full width in bf16 through
   ``launch.train.train`` (``train_phase``): B 4 x S 4096 in 2 microbatches,
   4 AdamW steps; exact per-step launches of the flash forward's lse twin
   (96: 24 layers x 2 microbatches x 2 under remat) and of the flash
   backward kernel (48), finite losses and grad norms, one profiled step
   (its backward device time split into the delta, dK/dV and dQ kernels);
   the backward kernel against its plain version at the training and long
   shapes and at RecurrentGemma-2B's (MQA G 10, hd 256, window 2048: the
   wide tensor-core pair) (a bf16 bound, bit-equal repeats, lse within
   1e-5); an fp32
   2-layer twin's loss and grads against the plain attention; and restart
   from a checkpoint against an uninterrupted run.
14. ``train_tp``: the same training on an explicit (1, 1) ``DeviceMesh``
   over a one-rank ``nccl`` world (``train_tp_phase``): parameters and
   AdamW state DTensors placed by ``ShardingPolicy``, the flash kernels on
   each rank's shard; 3 steps whose losses match ``train_model``'s within
   rel 1e-5 (bit equality logged), the same exact launches, step ms beside
   ``train_model``'s, one profiled step; ``compressed_psum`` on the last
   step's gradients bit-equal to ``decompress_tree(compress_tree(g))``;
   ``reshard_restore`` of a 2-layer step-2 checkpoint bit-equal.
15. ``train_moe``: Llama-4-Scout at full width cut to 2 of 48 layers,
   trained through ``launch.steps.build_train_step`` with the uncut model's
   Adafactor and 4 microbatches (``train_moe_phase``): B 4 x S 4096, 3
   steps; exact per-step moe_gmm forward and backward and flash launches,
   all tensor-core; moe_gmm's backward against its plain version
   (``gmm_bwd_kernels``), an fp32 1-layer twin's loss and grads against the
   plain moe_gmm and attention, and two loss-and-grad passes bit-equal.
16. ``train_hybrid``: RecurrentGemma-2B uncut trained through
   ``launch.train.train`` (``train_hybrid_phase``): B 2 x S 4096 in 2
   microbatches, 3 AdamW steps; exact per-step rglru_scan forward and
   backward launches, every one on the producer route ``scan_plan`` names,
   and flash launches (the backward on the wide tensor-core pair
   at hd 256, none on FFMA), the profiled step's backward split by kernel;
   the scan's backward bit-equal to its plain version
   (``scan_bwd_kernels``), an fp32 3-layer twin, and restart from a
   checkpoint.
17. ``vlm_model``: LLaVA-NeXT-34B at full width and depth (``vlm_phase``):
   576 stub patch embeddings in the first prompt slots, exact flash /
   decode launch counts, prefill -> decode.
18. ``split``: the split-inference draft's ``DraftState.attend`` through the
   decode_attention kernel against its numpy readout (atol 1e-6).
19. ``dryrun``: ``python -m repro_torch.launch.dryrun --mesh single`` on
   InternLM2-1.8B and RecurrentGemma-2B ``decode_32k`` (their caches sharded
   along the slots over 16 model ranks) and InternLM2-1.8B ``train_4k``, on
   the host's CPU in processes of their own (``dryrun_phase``): each must
   report ``ok``; trace seconds, rank-0 bytes, FLOPs and collectives are
   logged (host counts of a fake 256-rank world).

Then the card's ``nvidia-smi`` line, one ``{"kernels": [...]}`` line (each
kernel's launches on the served and trained runs, by variant where it has
two: retrieval_topk's are summed over phases 3-7, flash_attention's
training forwards are its ``lse_tc`` variant; the three backwards stand as
``*_bwd`` entries, the flash backward at hd 256 apart as
``flash_attention_bwd_wide``; decode_attention's lse twin as
``decode_attention_lse``, its count read on every served and trained run
and held at 0 there: no one-card path runs it), and
last ``{"ok": true, "device": {...}}``.  Any failed check raises, and the
script exits non-zero without the result lines.  It needs a CUDA device and
the rest of the repository beside it.
"""
from __future__ import annotations

import contextlib
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Data-sheet peaks (H100 SXM5), keyed by the exact name the card reports:
# HBM bytes/s, fp32 CUDA-core FLOP/s (the selection kernels' fp32 FFMA) and
# the bf16 dense tensor-core FLOP/s (the rate a bf16 attention could reach).
PEAKS = {"NVIDIA H100 80GB HBM3": (3.35e12, 66.9e12, 989e12)}
TIE = 1e-5  # values this close may order either way under fp32 rounding
VARIANTS = ("tc", "ffma")  # the kernels with two variants count each apart
SCAN_ROUTES = ("tma", "cp_async")  # rglru_scan's producers, counted apart
DECODE_LSE = "decode_attention_lse"  # decode's lse twin in the kernels line


def op_variants(op) -> tuple:
    """The counted variants of a kernel op: tc / ffma, the scan's producer
    routes, or none."""
    if hasattr(op, "launches_tc"):
        return VARIANTS
    return SCAN_ROUTES if hasattr(op, "launches_tma") else ()
ATOL = 1e-5  # unit-vector similarities and vote sums of <= k such terms
TRIALS, LOOP = 5, 20
ROW_MAX_D = 1024  # widths the warp-per-row kernels are timed at (they refuse
# above about 1600: their corpus tile must fit shared memory)


T0 = time.perf_counter()


def log(phase: str, **fields) -> None:
    """One JSON line, with the seconds since the script started (``t_s``:
    the per-phase seconds are the differences)."""
    print(json.dumps({"phase": phase,
                      "t_s": round(time.perf_counter() - T0, 1), **fields}),
          flush=True)


ATTN_F32_ATOL = 1e-5  # fp32 attention: one softmax summed in another order
# fp32 moe_gmm and rglru_scan: max |out - ref| over max |ref|
# (tests/test_kernels.py's moe_gmm bound; the scan runs the same recurrence)
F32_REL = 1e-5
REL_DECODE = 2e-2  # prefill -> decode logits, tests/test_models.py's bound
OUT_TOKENS = 150  # decode steps of every served model (core/pipeline.py)
SCOUT_LAYERS = 12  # of 48: 12 x 4.4 GB of bf16 layers + 4.1 GB embed and head
TWIN_LAYERS = 2  # the Scout fp32 twin: 2 x 8.8 GB + 8.3 GB embed and head
MLSTM_CHUNK = 256  # the mLSTM prefill's chunk (models/blocks.py)
VLM_TWIN_LAYERS = 4  # LLaVA's fp32 twin: 4 x 2.2 GB + 3.9 GB embed, head, frontend
KERNEL_NAMES = ("flash_attention_kernel", "flash_attention_tc_kernel",
                "decode_partial_kernel", "decode_combine_kernel",
                "decode_attention_tc_kernel", "decode_tc_combine_kernel",
                "retrieval_topk_kernel", "retrieval_topk_tiled_kernel",
                "retrieval_topk_merge_kernel", "retrieval_topk_scores_kernel",
                "retrieval_topk_select_kernel", "dsqe_score_kernel",
                "dsqe_score_merge_kernel", "dsqe_score_select_kernel",
                "moe_gmm_kernel", "moe_gmm_tc_kernel", "moe_gmm_bwd_tc_kernel",
                "rglru_scan_kernel", "rglru_scan_bwd_kernel",
                "flash_bwd_delta_kernel", "flash_bwd_dkdv_wgmma_kernel",
                "flash_bwd_dq_wgmma_kernel", "flash_bwd_dkdv_wgmma_wide_kernel",
                "flash_bwd_dq_wgmma_wide_kernel", "flash_bwd_sum_kernel",
                "flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel")
# the routed ("tc") flash backward: its delta kernel and the wgmma pair (hd
# <= 128), and at hd above 128 the wide pair with its split-sum kernel
BWD_KERNELS = ("flash_bwd_delta_kernel", "flash_bwd_dkdv_wgmma_kernel",
               "flash_bwd_dq_wgmma_kernel")
BWD_WIDE_KERNELS = ("flash_bwd_delta_kernel",
                    "flash_bwd_dkdv_wgmma_wide_kernel",
                    "flash_bwd_dq_wgmma_wide_kernel", "flash_bwd_sum_kernel")


def peaks(name: str) -> tuple[float, float, float]:
    if name not in PEAKS:
        raise RuntimeError(f"no data-sheet peaks for {name!r}")
    return PEAKS[name]


def time_ms(torch, fn, trials: int = TRIALS, loop: int = LOOP) -> float:
    """Per-call time: CUDA events around ``loop`` back-to-back calls,
    divided by ``loop``; the median of ``trials`` such loops, after warmup.
    Calls of tens of ms take fewer loops."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(loop):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / loop)
    return statistics.median(times)


def graph_ms(torch, fn, loop: int = LOOP, trials: int = TRIALS) -> float:
    """Device time per call: ``loop`` calls captured in one CUDA graph,
    replayed ``trials`` times (median), so the wrapper's host overhead,
    which ``time_ms`` includes at small shapes, drops out."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(loop):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / loop)
    del graph
    return statistics.median(times)


def check_topk(torch, vals, ids, q, corpus, k, where):
    """Kernel top-k against the plain version.  Ids must be equal except
    where the plain version's values at that position lie within TIE of a
    neighbour, or of the (k+1)-th value at the boundary; there the kernel's
    id must score, by the plain GEMM, within TIE of the plain value."""
    from repro_torch.kernels.retrieval_topk.ref import retrieval_topk_ref

    n = corpus.shape[0]
    rv, ri = retrieval_topk_ref(q, corpus, k=min(k + 1, n))
    rv, ri, nxt = rv[:, :k], ri[:, :k], rv[:, k:k + 1]
    err = float((vals - rv).abs().max())
    if err > ATOL:
        raise AssertionError(f"{where}: values differ by {err}")
    if not ((ids >= 0) & (ids < n)).all():
        raise AssertionError(f"{where}: id out of range")
    near = torch.zeros_like(rv, dtype=torch.bool)
    near[:, 1:] |= (rv[:, 1:] - rv[:, :-1]).abs() <= TIE
    near[:, :-1] |= (rv[:, 1:] - rv[:, :-1]).abs() <= TIE
    if nxt.shape[1]:
        near |= (rv[:, k - 1:k] - nxt).abs() <= TIE
    diff = ids != ri
    if (diff & ~near).any():
        raise AssertionError(f"{where}: {int((diff & ~near).sum())} ids differ "
                             "away from any near-tie")
    rows, cols = torch.nonzero(diff, as_tuple=True)
    if rows.numel():
        got = (q[rows] * corpus[ids[rows, cols].long()]).sum(1)
        if float((got - rv[rows, cols]).abs().max()) > 2 * TIE:
            raise AssertionError(f"{where}: a near-tie swap picked a far row")
    return err, int(diff.sum())


def check_dsqe(torch, scores, set_id, args, knn, where):
    """Kernel scores against the plain version: set ids equal, the same
    entries masked to exactly NEG_INF, and scores within ATOL except in
    rows whose k-th and (k+1)-th train similarities lie within TIE."""
    from repro_torch.kernels.common import NEG_INF
    from repro_torch.kernels.dsqe_score.ref import dsqe_score_ref
    from repro_torch.kernels.retrieval_topk.ref import retrieval_topk_ref

    q, train = args[0], args[2]
    rs, rid = dsqe_score_ref(*args, knn=knn)
    if not torch.equal(set_id, rid):
        raise AssertionError(f"{where}: set ids differ")
    masked = rs < NEG_INF / 2
    if not torch.equal(scores < NEG_INF / 2, masked):
        raise AssertionError(f"{where}: feasibility masks differ")
    if not (scores[masked] == NEG_INF).all():
        raise AssertionError(f"{where}: a masked entry is not NEG_INF")
    tv, _ = retrieval_topk_ref(q, train, k=min(knn + 1, train.shape[0]))
    tie_rows = torch.zeros(q.shape[0], dtype=torch.bool, device=q.device)
    if tv.shape[1] > knn:
        tie_rows = (tv[:, knn - 1] - tv[:, knn]).abs() <= TIE
    keep = ~masked & ~tie_rows[:, None]
    err = float((scores - rs)[keep].abs().max()) if keep.any() else 0.0
    if err > ATOL:
        raise AssertionError(f"{where}: scores differ by {err}")
    return err, int(tie_rows.sum())


def unit(torch, gen, shape, device):
    x = torch.randn(shape, generator=gen, device=device)
    return (x / torch.linalg.norm(x, dim=-1, keepdim=True)).contiguous()


def deployment_tables(torch, gen, dev, B, d, K, N, P):
    """Seeded selection tables at deployment scale: each train row votes
    one path with an accuracy weight, containment is 0/1, SLOs mixed."""
    pathw = torch.zeros((N, P), device=dev)
    pathw[torch.arange(N, device=dev),
          torch.randint(0, P, (N,), generator=gen, device=dev)] = \
        0.3 + 0.7 * torch.rand(N, generator=gen, device=dev)
    u = lambda *s: torch.rand(s, generator=gen, device=dev)
    slo = torch.stack([6.0 * u(B), 0.012 * u(B)], dim=1).contiguous()
    return (unit(torch, gen, (B, d), dev), unit(torch, gen, (K, d), dev),
            unit(torch, gen, (N, d), dev), pathw, (u(K, P) < 0.6).float(),
            0.1 + 4.9 * u(P), 0.01 * u(P), 1e-3 * u(P), (u(P) < 0.9).float(),
            slo)


def ptxas_report(log: str) -> list[dict]:
    """Registers and spill bytes of every kernel entry in the build log."""
    out, entry, spill = [], None, 0
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            mangled = m.group(1)
            name = next((k for k in KERNEL_NAMES if k in mangled), mangled)
            args = ["bf16"] if "bfloat16" in mangled else (
                ["f32"] if name + "If" in mangled else [])
            args += re.findall(r"Li(\d+)E", mangled)  # int template args
            if name.startswith("flash"):
                args += ["lse"] * ("Lb1E" in mangled)  # the training twin
            else:  # moe_gmm_kernel's operand layouts (A MN-major, B K-major)
                args += re.findall(r"Lb([01])E", mangled)
            entry = f"{name}<{','.join(args)}>" if args else name
            spill = 0
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and entry:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry:
            out.append({"kernel": entry, "registers": int(m.group(1)),
                        "spill_bytes": spill})
            entry = None
    return out


def wgmma_serialized(log: str) -> list[str]:
    """Kernels in whose build ptxas serialized the wgmma instructions (each
    then waits for the one before it)."""
    out = []
    for ln in log.splitlines():
        if "serialized" in ln and "wgmma" in ln:
            name = next((k for k in KERNEL_NAMES if k in ln), ln[-120:])
            if name not in out:
                out.append(name)
    return out


def bound(bw, flops_rate, nbytes, flops):
    t_bytes, t_ops = nbytes / bw, flops / flops_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def cost_bound(bw, flops_rate, cost):
    """``bound`` of a kernel module's ``cost(...)``, (FLOPs, bytes): the
    count the dry run reads too."""
    flops, nbytes = cost
    return bound(bw, flops_rate, nbytes, flops)


def attention_kernels(torch, dev, gen, bw, bf16) -> dict:
    """Both attention kernels against their plain versions at the served
    and long shapes of InternLM2-1.8B (H = 16, Kv = 8, hd = 128), on the same
    bf16 inputs in bf16 and widened to fp32.  Returns the served shapes'
    numbers per kernel."""
    import torch.nn.functional as F

    from repro_torch.kernels.common import KERNEL_DTYPES, sm_count
    from repro_torch.kernels.decode_attention import kernel as decode_kernel
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import (decode_attention_ref,
                                                          slot_visible)
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import (flash_attention_ref,
                                                         visible,
                                                         visible_pairs)

    H, Kv, hd, dt = 16, 8, 128, torch.bfloat16
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev).to(dt)
    sms = sm_count(dev)
    summary = {}

    def check_bf16(out, ref, ref_abs_v, where):
        """Element by element, |out - ref| <= 2^-7 |ref| + 2^-8 (P|v|)_i.
        The first term covers the two roundings of the output to bf16 (one
        bf16 ulp is at most 2^-7 of the value); the second the rounding of
        each weight p to bf16 before the P.V product (at most 2^-9 of p, in
        the kernel and, for decode, in the plain version too), summed with
        the weights over |v|: ``ref_abs_v`` is the plain version on |v|.
        Returns (max |out - ref|, max of |out - ref| / limit)."""
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        lim = 2.0 ** -7 * ref.float().abs() + 2.0 ** -8 * ref_abs_v.float()
        ratio = float((diff / lim).max())
        if not ratio <= 1.0:  # NaN fails too
            raise AssertionError(f"{where}: bf16 kernel exceeds its limit by "
                                 f"{ratio}x (max |diff| {float(diff.max())})")
        return float(diff.max()), ratio

    def check_f32(out, ref, where):
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        if not err <= ATTN_F32_ATOL:
            raise AssertionError(f"{where}: fp32 kernel differs from the "
                                 f"plain version by {err}")
        return err

    def flash_row(where, B, S, H, Kv, hd, masks, loops=(), Skv=None):
        """One prefill shape, S query rows against ``Skv`` keys (S when not
        given): bf16 against the plain version (the served route, which
        must be the tensor-core variant), fp32 (the FFMA variant) at 1e-5,
        and the times of the served route, the plain version, the FFMA
        variant on the same bf16 inputs (its explicit route), and SDPA with
        the same mask.  Bound: 4 hd FLOPs per visible (query, key) pair, q,
        k, v read and out written once."""
        Skv = S if Skv is None else Skv
        q = randn(B, S, H, hd)
        k, v = randn(B, Skv, Kv, hd), randn(B, Skv, Kv, hd)
        tc0 = flash_attention.launches_tc
        out = flash_attention(q, k, v, **masks)
        if flash_attention.launches_tc != tc0 + 1:
            raise AssertionError(f"{where}: bf16 did not take the "
                                 "tensor-core variant")
        err, ratio = check_bf16(out, flash_attention_ref(q, k, v, **masks),
                                flash_attention_ref(q, k, v.abs(), **masks),
                                where)
        del out
        qf, kf, vf = q.float(), k.float(), v.float()
        err32 = check_f32(flash_attention(qf, kf, vf, **masks),
                          flash_attention_ref(qf, kf, vf, **masks), where)
        del qf, kf, vf
        ms = time_ms(torch, lambda: flash_attention(q, k, v, **masks))
        ffma_ms = time_ms(torch, lambda: flash_kernel.launch(
            q, k, v, "ffma", **masks), *loops)
        plain = time_ms(torch, lambda: flash_attention_ref(q, k, v, **masks),
                        *loops)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if masks.get("window"):
            mask = visible(S, Skv, device=dev, **masks)
            lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True))
        else:  # causal or none; a chunk of 8192 does not cut these S
            lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=masks["causal"], enable_gqa=True))
        pairs = visible_pairs(S, Skv, **masks)
        b_ms, b_by = cost_bound(bw, bf16, flash_kernel.cost(
            B, S, Skv, H, Kv, hd, 2, **masks))
        row = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                   bound_by=b_by, library_ms=lib_ms)
        log("kernels", kernel="flash_attention", shape=where, B=B, S=S,
            Skv=Skv, H=H, Kv=Kv, hd=hd, dtype="bf16", **masks, variant="tc",
            visible_pairs=pairs, bf16_limit_ratio=ratio,
            fp32_max_abs_err=err32, ffma_ms=ffma_ms, **row)
        return row

    causal = dict(causal=True, window=0, chunk_attn=0)
    summary["flash_attention"] = flash_row("served prefill", 8, 1024, H, Kv,
                                           hd, causal)
    flash_row("long prefill", 1, 8192, H, Kv, hd, causal, loops=(3, 5))

    def decode_row(where, B, W, clen, H, Kv, hd, masks, loops=()):
        """One decode shape: bf16 against the plain version (the served
        route, which must be the tensor-core variant), fp32 (the FFMA
        variant) at 1e-5, and the times of the served route (per call, and
        as device time replayed from a CUDA graph), the plain version, the
        FFMA variant on the same bf16 inputs (its explicit route), and SDPA
        with the same mask; both variants also through their explicit
        route (``route_ms``, ``route_graph_ms``).  Bound: the visible slots
        of K and V read once, q read and out written; 4 G FLOPs per cached
        element pair."""
        q = randn(B, 1, H, hd)
        kc, vc = randn(B, W, Kv, hd), randn(B, W, Kv, hd)
        cl = torch.tensor(clen, dtype=torch.int32, device=dev)
        variant = decode_kernel.route(q.dtype, H // Kv, hd)
        tc0 = decode_attention.launches_tc
        out = decode_attention(q, kc, vc, cl, **masks)
        if variant != "tc" or decode_attention.launches_tc != tc0 + 1:
            raise AssertionError(f"{where}: bf16 did not take the "
                                 "tensor-core variant")
        err, ratio = check_bf16(
            out, decode_attention_ref(q, kc, vc, clen, **masks),
            decode_attention_ref(q, kc, vc.abs(), clen, **masks), where)
        del out
        qf, kf, vf = q.float(), kc.float(), vc.float()
        err32 = check_f32(decode_attention(qf, kf, vf, cl, **masks),
                          decode_attention_ref(qf, kf, vf, clen, **masks),
                          where)
        del qf, kf, vf
        op = lambda: decode_attention(q, kc, vc, cl, **masks)
        ms, dev_ms = time_ms(torch, op), graph_ms(torch, op)
        # both variants through their explicit route, per call and as
        # device time: like for like, without the op's input checks
        by_route = {v: lambda v=v: decode_kernel.launch(
            q, kc, vc, cl.reshape(1), KERNEL_DTYPES[q.dtype], v, **masks)
            for v in ("tc", "ffma")}
        route_ms = {v: time_ms(torch, fn, *loops) for v, fn in by_route.items()}
        route_graph_ms = {v: graph_ms(torch, fn, *loops)
                          for v, fn in by_route.items()}
        plain = time_ms(torch, lambda: decode_attention_ref(
            q, kc, vc, clen, **masks), *loops)
        visible = slot_visible(W, clen, device=dev, **masks)
        mask = visible[None, None, None, :]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, kc, vc))
        sdpa = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)
        lib_ms, lib_dev_ms = time_ms(torch, sdpa), graph_ms(torch, sdpa)
        live = int(visible.sum())
        b_ms, b_by = cost_bound(bw, bf16, decode_kernel.cost(
            B, H, Kv, hd, live, 2))
        split, n_splits = decode_kernel.tc_splits(B, Kv, W, sms, hd)
        row = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                   bound_by=b_by, library_ms=lib_ms)
        log("kernels", kernel="decode_attention", shape=where, B=B, W=W,
            cache_len=clen, H=H, Kv=Kv, hd=hd, dtype="bf16", **masks,
            variant=variant, split=split, n_splits=n_splits,
            visible_slots=live, bf16_limit_ratio=ratio,
            fp32_max_abs_err=err32, graph_ms=dev_ms, route_ms=route_ms,
            route_graph_ms=route_graph_ms, library_graph_ms=lib_dev_ms,
            **row)
        return row

    dense = dict(ring=False, chunk_attn=0)
    summary["decode_attention"] = decode_row(
        "served decode", 8, 1174, 1024 + 75, H, Kv, hd, dense)
    decode_row("long decode", 32, 32768, 32768, H, Kv, hd, dense,
               loops=(3, 5))
    torch.cuda.empty_cache()

    # the MoE and hybrid models' shapes (Llama-4-Scout: H 40, Kv 8, chunked
    # 8192; RecurrentGemma-2B: MQA with G = 10 at hd 256, window 2048, a
    # wrapped ring at decode): checked and timed as above
    flash_row("llama4-scout served prefill", 8, 1024, 40, 8, 128,
              dict(causal=True, window=0, chunk_attn=8192), loops=(3, 5))
    flash_row("recurrentgemma-2b served prefill", 4, 3072, 10, 1, 256,
              dict(causal=True, window=2048, chunk_attn=0), loops=(3, 5))
    decode_row("llama4-scout served decode", 8, 1174, 1024 + 75, 40, 8, 128,
               dict(ring=True, chunk_attn=8192))
    decode_row("recurrentgemma-2b served decode", 4, 2048, 3072 + 75, 10, 1,
               256, dict(ring=True, chunk_attn=0))
    torch.cuda.empty_cache()

    # the encoder-decoder's and the VLM's shapes (SeamlessM4T-medium: 16
    # heads of 64, a bidirectional encoder over 4096 frames, cross-attention
    # of the 128-token decoder prefix and of each decode row; LLaVA-NeXT-34B:
    # 56 / 8 heads of 128): checked and timed as above
    from repro_torch.configs import ENCDEC_DECODE_SRC_LEN as T
    from repro_torch.configs import ENCDEC_DECODER_PREFIX as P

    full = dict(causal=False, window=0, chunk_attn=0)
    flash_row("seamless-m4t-medium encoder prefill", 8, T, 16, 16, 64, full,
              loops=(3, 5))
    torch.cuda.empty_cache()
    flash_row("seamless-m4t-medium cross prefill", 8, P, 16, 16, 64, full,
              loops=(3, 5), Skv=T)
    flash_row("seamless-m4t-medium cross decode", 8, 1, 16, 16, 64, full,
              Skv=T)
    decode_row("seamless-m4t-medium served decode", 8, P + OUT_TOKENS,
               P + 75, 16, 16, 64, dense)
    flash_row("llava-next-34b served prefill", 4, 1024, 56, 8, 128, causal,
              loops=(3, 5))
    decode_row("llava-next-34b served decode", 4, 1024 + OUT_TOKENS, 1024 + 75,
               56, 8, 128, dense)
    torch.cuda.empty_cache()

    def split_row(where, B, W, clen, H, Kv, hd, masks, ways):
        """decode_attention's lse twin on a cache cut into ``ways`` slices of
        W / ways slots by ``slot0``, as each rank of a cache sharded along
        its slots runs it (``api.local_decode``): every slice against the
        plain twin (out under the bf16 limit, lse within LSE_ATOL; widened to
        fp32, the FFMA twin: out within ATTN_F32_ATOL, lse within
        LSE_ATOL); a dense slice wholly past cache_len must give out 0 and
        lse NEG_INF; the slices merged in fp32 (the max lse m, weights
        e^(lse - m)) against the whole-cache kernel under the bf16 limit.
        Times: the first slice's launch per call and from a CUDA graph, and
        the plain twin's.  Bound: ``kernel.cost`` over that slice's visible
        slots.  No single PyTorch call returns attention with its lse."""
        from repro_torch.kernels.common import NEG_INF
        from repro_torch.kernels.decode_attention.ref import \
            decode_attention_lse_ref

        q = randn(B, 1, H, hd)
        kc, vc = randn(B, W, Kv, hd), randn(B, W, Kv, hd)
        cl = torch.tensor(clen, dtype=torch.int32, device=dev)
        w = W // ways
        whole = decode_attention(q, kc, vc, cl, **masks)
        outs, lses, err, ratio, lse_err, err32, past = [], [], 0., 0., 0., \
            0., 0
        for r in range(ways):
            ks, vs = (t[:, r * w:(r + 1) * w].contiguous() for t in (kc, vc))
            twin = dict(masks, slot0=r * w, slots=W)
            before = decode_attention.launches_lse_tc
            out, lse = decode_attention(q, ks, vs, cl, return_lse=True,
                                        **twin)
            if decode_attention.launches_lse_tc != before + 1:
                raise AssertionError(f"{where}: the twin did not take the "
                                     "tensor-core variant")
            ref, ref_lse = decode_attention_lse_ref(q, ks, vs, clen, **twin)
            if not masks["ring"] and r * w >= clen:  # the limit is 0 there
                past += 1
                if out.abs().max() != 0 or not bool((lse == NEG_INF).all()):
                    raise AssertionError(f"{where} slice {r}: past cache_len "
                                         "but not 0 with lse NEG_INF")
                e, rt = 0.0, 0.0
            else:
                e, rt = check_bf16(out, ref, decode_attention_lse_ref(
                    q, ks, vs.abs(), clen, **twin)[0], f"{where} slice {r}")
            le = float((lse - ref_lse).abs().max())
            if not le <= LSE_ATOL:
                raise AssertionError(f"{where} slice {r}: lse differs from "
                                     f"the plain twin by {le}")
            f32 = (q.float(), ks.float(), vs.float())
            o32, l32 = decode_attention(*f32, cl, return_lse=True, **twin)
            r32, rl32 = decode_attention_lse_ref(*f32, clen, **twin)
            e32 = check_f32(o32, r32, f"{where} slice {r} fp32")
            le32 = float((l32 - rl32).abs().max())
            if not le32 <= LSE_ATOL:
                raise AssertionError(f"{where} slice {r} fp32: lse differs "
                                     f"from the plain twin by {le32}")
            err, ratio, err32 = max(err, e), max(ratio, rt), max(err32, e32)
            lse_err = max(lse_err, le, le32)
            outs.append(out)
            lses.append(lse)
        lse_all = torch.stack(lses)
        wts = torch.exp(lse_all - lse_all.max(0).values)[..., None]
        merged = sum(wt[:, None] * o.float() for wt, o in
                     zip(wts, outs)) / wts.sum(0)[:, None]
        merge_err, merge_ratio = check_bf16(
            merged.to(q.dtype), whole,
            decode_attention_ref(q, kc, vc.abs(), clen, **masks),
            f"{where} merged")
        ks, vs = kc[:, :w].contiguous(), vc[:, :w].contiguous()
        shard = dict(masks, slot0=0, slots=W)
        op = lambda: decode_attention(q, ks, vs, cl, return_lse=True, **shard)
        ms, dev_ms = time_ms(torch, op), graph_ms(torch, op)
        plain = time_ms(torch, lambda: decode_attention_lse_ref(
            q, ks, vs, clen, **shard))
        live = int(slot_visible(w, clen, device=dev, **shard).sum())
        b_ms, b_by = cost_bound(bw, bf16, decode_kernel.cost(
            B, H, Kv, hd, live, 2, with_lse=True))
        row = dict(max_abs_err=max(err, merge_err), ms=ms, plain_ms=plain,
                   bound_ms=b_ms, bound_by=b_by, library_ms=None)
        log("kernels", kernel="decode_attention_lse", shape=where, B=B, W=W,
            slice_slots=w, slices=ways, cache_len=clen, H=H, Kv=Kv, hd=hd,
            dtype="bf16", **masks, variant="tc", slices_past_cache_len=past,
            timed_slice_visible_slots=live, bf16_limit_ratio=ratio,
            merged_max_abs_err=merge_err, merged_limit_ratio=merge_ratio,
            lse_max_abs_err=lse_err, fp32_max_abs_err=err32, graph_ms=dev_ms,
            launches_lse=decode_attention.launches_lse,
            launches_lse_by_variant={v: getattr(
                decode_attention, f"launches_lse_{v}") for v in VARIANTS},
            **row)
        return row

    # decode on a cache sharded along its slots (tp > 1 with Kv % tp != 0:
    # InternLM2's 8 KV heads over 16 ranks, RecurrentGemma-2B's one)
    split_row("internlm2-1.8b decode, 2 slices", 8, 2048, 1174, H, Kv, hd,
              dense, 2)
    summary["decode_attention_lse"] = split_row(
        "internlm2-1.8b decode, 16 slices", 8, 2048, 1174, H, Kv, hd, dense,
        16)
    split_row("recurrentgemma-2b ring decode, 16 slices", 4, 2048, 3072, 10,
              1, 256, dict(ring=True, chunk_attn=0), 16)
    torch.cuda.empty_cache()
    return summary


def gmm_kernels(torch, dev, gen, bw, bf16) -> dict:
    """moe_gmm against its plain version at the shapes the Llama-4-Scout
    path gives it (E 16, D 5120, F 8192; C = 640 rows per expert at the 8 x
    1024 prefill, 8 at decode; gate/up D -> F and down F -> D) and at a
    ragged shape, on bf16 inputs in bf16 and widened to fp32.  bf16, element
    by element: |out - ref| <= 2^-7 |ref| + 1e-5 (|x| . |w|): both sides round
    an fp32 sum of the same products to bf16 (each rounding at most 2^-8 of
    the value), and the two sums differ by far less than 1e-5 of the sum of
    the products' magnitudes.  fp32: max |out - ref| <= F32_REL max |ref|.
    The served shapes must take the tensor-core variant (the ragged one,
    F = 300, takes the FFMA variant by the route's rule); beside its time
    stand the FFMA variant's on the same bf16 inputs (its explicit route)
    and, as library yardstick, ``torch.bmm``.  Returns the served prefill
    gate/up shape's numbers."""
    from repro_torch.kernels.moe_gmm import kernel as gmm_kernel
    from repro_torch.kernels.moe_gmm.ops import moe_gmm
    from repro_torch.kernels.moe_gmm.ref import moe_gmm_ref

    summary = None
    D, Fd = 5120, 8192
    for shape, E, C, K, N in (("served prefill gate/up", 16, 640, D, Fd),
                              ("served prefill down", 16, 640, Fd, D),
                              ("served decode gate/up", 16, 8, D, Fd),
                              ("served decode down", 16, 8, Fd, D),
                              ("ragged", 7, 77, 1000, 300)):
        where = f"moe_gmm/{shape}"
        x = torch.randn((E, C, K), generator=gen, device=dev).to(
            torch.bfloat16)
        w = torch.randn((E, K, N), generator=gen, device=dev).mul_(
            1.0 / math.sqrt(K)).to(torch.bfloat16)
        variant = gmm_kernel.route(x.dtype, K, N)
        if shape.startswith("served") and variant != "tc":
            raise AssertionError(f"{where}: routed to {variant}")
        before = getattr(moe_gmm, f"launches_{variant}")
        out = moe_gmm(x, w).float()
        if getattr(moe_gmm, f"launches_{variant}") != before + 1:
            raise AssertionError(f"{where}: the {variant} count did not move")
        ref = moe_gmm_ref(x, w).float()
        mag = moe_gmm_ref(x.abs().float(), w.abs().float())
        torch.cuda.synchronize()
        diff = (out - ref).abs()
        ratio = float((diff / (2.0 ** -7 * ref.abs() + 1e-5 * mag)).max())
        if not ratio <= 1.0:  # NaN fails too
            raise AssertionError(f"{where}: bf16 kernel exceeds its limit by "
                                 f"{ratio}x (max |diff| {float(diff.max())})")
        err = float(diff.max())
        del out, ref, mag, diff
        xf, wf = x.float(), w.float()
        ref32 = moe_gmm_ref(xf, wf)
        rel32 = float((moe_gmm(xf, wf) - ref32).abs().max()
                      / ref32.abs().max())
        if not rel32 <= F32_REL:
            raise AssertionError(f"{where}: fp32 kernel differs from the "
                                 f"plain version by rel {rel32}")
        del xf, wf, ref32
        loops = (3, 5) if C > 8 else ()  # a prefill call takes tens of ms
        ms = time_ms(torch, lambda: moe_gmm(x, w), *loops)
        ffma_ms = time_ms(torch, lambda: gmm_kernel.launch(x, w, "ffma"),
                          *loops)
        plain = time_ms(torch, lambda: moe_gmm_ref(x, w), *loops)
        lib_ms = time_ms(torch, lambda: torch.bmm(x, w))
        b_ms, b_by = cost_bound(bw, bf16, gmm_kernel.cost(E, C, K, N, 2))
        row = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                   bound_by=b_by, library_ms=lib_ms)
        log("kernels", kernel="moe_gmm", shape=shape, E=E, C=C, D=K, F=N,
            dtype="bf16", variant=variant, bf16_limit_ratio=ratio,
            fp32_rel_err=rel32, ffma_ms=ffma_ms, **row)
        summary = summary or row
        del x, w
    torch.cuda.empty_cache()
    return summary


def scan_route(B, S, R, dtype, backward) -> str:
    """The producer route ``kernel.scan_plan`` names for an rglru_scan
    launch (16-byte aligned tensors, as the model's fresh ones are)."""
    from repro_torch.kernels.rglru_scan.kernel import scan_plan

    return scan_plan(B, S, R, dtype, backward).route


def scan_fields(a, backward) -> dict:
    """rglru_scan's plan at a's shape (route, CH, T, D, shared bytes); the
    callers have checked that the C launcher took that route."""
    from repro_torch.kernels.rglru_scan.kernel import plan_for

    plan = plan_for(a, backward=backward)
    return dict(route=plan.route, CH=plan.ch, T=plan.t, D=plan.d,
                smem_bytes=plan.smem_bytes, blocks=plan.blocks)


def scan_kernels(torch, dev, gen, bw, fp32) -> dict:
    """rglru_scan against its plain version at RecurrentGemma-2B's train
    microbatch (B 1, S 4096, R 2560) and served prefill (B 4, S 3072; the
    model feeds it fp32 decays and inputs), the served prefill in bf16, and
    a ragged shape: bit-equal to the plain loop (both run the same fp32
    recurrence in the same order, rounding the product and the sum apart),
    with the launch on the route ``kernel.scan_plan`` names (the route
    counter the C launcher's report moves).  Each row logs the plan (route,
    CH, T, D).  No single PyTorch call computes the recurrence, so there is
    no library time.  Returns the train row, the shape of most of its
    launches."""
    from repro_torch.kernels.rglru_scan import kernel as scan_kernel
    from repro_torch.kernels.rglru_scan.ops import rglru_scan_op
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

    rows = {}
    f32, bf16 = torch.float32, torch.bfloat16
    for shape, B, S, R, dt in (("train", 1, 4096, 2560, f32),
                               ("served prefill", 4, 3072, 2560, f32),
                               ("served prefill bf16", 4, 3072, 2560, bf16),
                               ("ragged", 3, 1001, 1000, f32)):
        where = f"rglru_scan/{shape}"
        a = torch.rand((B, S, R), generator=gen, device=dev).mul_(0.299).add_(
            0.7).to(dt)  # decays in [0.7, 0.999)
        x = torch.randn((B, S, R), generator=gen, device=dev).to(dt)
        h0 = torch.randn((B, R), generator=gen, device=dev)
        ref = rglru_scan_ref(a, x, h0)
        route = scan_route(B, S, R, dt, False)
        before = getattr(rglru_scan_op, f"launches_{route}")
        got = rglru_scan_op(a, x, h0)
        torch.cuda.synchronize()
        if getattr(rglru_scan_op, f"launches_{route}") != before + 1:
            raise AssertionError(f"{where}: not launched on the {route} "
                                 "route")
        err = float((got - ref).abs().max())
        if not torch.equal(got, ref):
            raise AssertionError(f"{where}: kernel differs from the plain "
                                 f"version by {err}")
        if not torch.equal(rglru_scan_op(a, x, h0), got):
            raise AssertionError(f"{where}: two calls differ")
        del got
        call = lambda: rglru_scan_op(a, x, h0)
        ms, dev_ms = time_ms(torch, call), graph_ms(torch, call)
        plain = time_ms(torch, lambda: rglru_scan_ref(a, x, h0), 3, 2)
        plan = scan_fields(a, False)
        # a and x read once, h0 read, every state written in fp32
        b_ms, b_by = cost_bound(bw, fp32, scan_kernel.cost(
            B, S, R, a.element_size()))
        row = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                   bound_by=b_by, library_ms=None, graph_ms=dev_ms)
        log("kernels", kernel="rglru_scan", shape=shape, B=B, S=S, R=R,
            dtype=str(dt).removeprefix("torch."), bit_equal_plain=True,
            bit_equal_repeat=True, **plan, **row)
        rows[shape] = row
        del a, x, h0, ref
    torch.cuda.empty_cache()
    return rows["train"]


def serve_lm(torch, dev, cfg, params, prompts, out_tokens, ops, watch,
             frontend=None):
    """Serve ``prompts`` through ``launch.steps``: a warm-up prefill and
    decode step (one-time costs: cuBLAS handles, lazy module loads), then a
    timed prefill and ``out_tokens`` greedy decode steps.  Every launch
    counter of the ops in ``ops`` is set to 0 just before the prefill and
    just before the decode loop; each op's ``launches`` (and decode's lse
    twin's, as ``DECODE_LSE``) and its per-variant counters are read just
    after each; every launch of a kernel with two variants must have gone
    to its tensor-core variant.  The logits of the decode steps in
    ``watch`` are kept; none may be NaN or infinite.  ``frontend`` (stub frames of an encoder-decoder, patch embeddings of a
    VLM) goes to the prefill step; an encoder-decoder's prefill returns the
    encoder output, which every decode step takes back."""
    from repro_torch.launch.steps import build_decode_step, build_prefill_step
    from repro_torch.models.config import ShapeSpec

    B, S = prompts.shape
    shape = ShapeSpec("served", S + out_tokens, B, "prefill")
    prefill_step = build_prefill_step(cfg, shape)
    decode_step = build_decode_step(cfg, shape)
    step_in = () if frontend is None else (frontend,)
    logits, cache, *extra = prefill_step(params, prompts, *step_in)
    decode_step(params, logits.argmax(-1, keepdim=True), cache,
                torch.tensor(S + 1, dtype=torch.int32, device=dev), *extra)
    del logits, cache, extra
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def zero():
        for op in ops.values():
            for c in [c for c in vars(op) if c.startswith("launches")]:
                setattr(op, c, 0)

    def counts():
        got = {name: op.launches for name, op in ops.items()}
        if "decode_attention" in ops:
            got[DECODE_LSE] = ops["decode_attention"].launches_lse
        return got

    def variants():
        return {name: {v: getattr(op, f"launches_{v}")
                       for v in op_variants(op)}
                for name, op in ops.items() if op_variants(op)}

    zero()
    t0 = time.perf_counter()
    logits, cache, *extra = prefill_step(params, prompts, *step_in)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = counts()
    prefill_variants = variants()

    kept, generated = {}, []
    token = logits.argmax(-1, keepdim=True)
    cache_len = torch.tensor(S + 1, dtype=torch.int32, device=dev)
    zero()
    t0 = time.perf_counter()
    for t in range(out_tokens):
        generated.append(token)
        logits, cache = decode_step(params, token, cache, cache_len, *extra)
        if t in watch:
            kept[t] = logits.clone()
        token = logits.argmax(-1, keepdim=True)
        cache_len += 1  # on the device: no host sync in the loop
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    decode_launches = counts()
    decode_variants = variants()
    for t, lg in [*kept.items(), ("last", logits)]:
        if not torch.isfinite(lg).all():
            raise AssertionError(f"{cfg.name} decode step {t}: non-finite "
                                 "logits")
    for what, counts, by_variant in (
            ("prefill", prefill_launches, prefill_variants),
            ("decode", decode_launches, decode_variants)):
        for name, n in by_variant.items():
            if "tc" in n and n != {"tc": counts[name], "ffma": 0}:
                raise AssertionError(f"{cfg.name} {what}: {name} launched "
                                     f"{n} by variant, want every one of "
                                     f"{counts[name]} on the tensor cores")
    return dict(batch=B, prompt_tokens=S, prefill_s=prefill_s,
                decode_s=decode_s,
                prefill_launches=prefill_launches,
                decode_launches=decode_launches,
                prefill_variants=prefill_variants,
                decode_variants=decode_variants, watch=kept,
                generated=generated, token=token, cache=cache,
                decode_step=decode_step, decode_extra=tuple(extra),
                frontend=frontend,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def lse_launches(run) -> int:
    """Launches of decode's lse twin in a served run, prefill and decode
    (``check_launches`` holds each at 0)."""
    return run["prefill_launches"][DECODE_LSE] + \
        run["decode_launches"][DECODE_LSE]


def variant_totals(run) -> dict:
    """Launches by variant of a served run, prefill and decode summed."""
    out = {}
    for counts in (run["prefill_variants"], run["decode_variants"]):
        for name, by in counts.items():
            acc = out.setdefault(name, dict.fromkeys(by, 0))
            for v, n in by.items():
                acc[v] += n
    return out


def check_launches(cfg, what, got, want):
    """``got`` (``serve_lm``'s counts) must be ``want``; where ``want``
    counts decode_attention, decode's lse twin must have launched no time
    (no one-card path runs it)."""
    if "decode_attention" in want:
        want = {DECODE_LSE: 0, **want}
    if got != want:
        raise AssertionError(f"{cfg.name} {what} launched {got}, want {want}")


def prefill_decode_rel(torch, params, cfg, prompts, run,
                       limit=REL_DECODE) -> dict:
    """Decode step t ran the token at position S + t: the full forward over
    the first S + t + 1 tokens must give the same last-token logits, within
    rel ``limit`` of the largest logit (None: measured only; a NaN always
    fails)."""
    from repro_torch.models import lm

    S = prompts.shape[1]
    seq = torch.cat([prompts, *run["generated"]], dim=1)
    if cfg.num_encoder_layers:  # the served encoder output
        side = dict(encoder_out=run["decode_extra"][0])
    else:  # a VLM's patches take the first slots again
        side = dict(frontend=run["frontend"])
    rels = {}
    for t, lg in run["watch"].items():
        hidden, _, _ = lm.forward(params, cfg, seq[:, :S + t + 1], **side)
        full = lm.logits_of(params, cfg, hidden)
        rels[str(t)] = float((full - lg).abs().max() / full.abs().max())
    worst = max(rels.values())
    if not (worst < limit if limit is not None else worst == worst):
        raise AssertionError(f"{cfg.name}: decode logits differ from the "
                             f"full forward by rel {rels} (step: rel)")
    return rels


def roofline_fields(cfg, B: int, S: int, kind: str, ms: float) -> dict:
    """A measured step or prefill of ``cfg`` at B x S beside its one-card
    roofline on the H100's terms (``perf/roofline.py: step_share``, the
    analytic cost model): its bound and model-FLOP share."""
    from repro_torch.models.config import ShapeSpec
    from repro_torch.perf.roofline import step_share

    return step_share(cfg, ShapeSpec("run", S, B, kind), ms / 1e3)


def served_fields(torch, cfg, params, run, out_tokens, init_s) -> dict:
    """The served run's log fields, with a profiled window of decode
    steps."""
    B, S = run["batch"], run["prompt_tokens"]
    busy_ms, wall_ms, top = decode_device_time(
        torch, run["decode_step"], params, run["token"], run["cache"], S + 1,
        extra=run["decode_extra"])
    return dict(
        arch=cfg.name, dtype=cfg.dtype, layers=cfg.num_layers,
        d_model=cfg.d_model, heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, params=cfg.param_count(), batch=B,
        prompt_tokens=S, decode_steps=out_tokens, capacity=S + out_tokens,
        init_s=init_s, prefill_ms=1e3 * run["prefill_s"],
        prefill_roofline=roofline_fields(cfg, B, S, "prefill",
                                         1e3 * run["prefill_s"]),
        prefill_tokens_per_s=B * S / run["prefill_s"],
        decode_ms_per_step=1e3 * run["decode_s"] / out_tokens,
        decode_tokens_per_s=B * out_tokens / run["decode_s"],
        profiled_decode_ms_per_step=wall_ms,
        profiled_decode_device_busy_ms_per_step=busy_ms,
        profiled_decode_device_idle_share=(
            None if busy_ms is None else 1.0 - busy_ms / wall_ms),
        profiled_decode_top_kernels=top,
        peak_memory_gb=run["peak_gb"],
        prefill_launches=run["prefill_launches"],
        decode_launches=run["decode_launches"],
        prefill_launches_by_variant=run["prefill_variants"],
        decode_launches_by_variant=run["decode_variants"],
        generated_head=[int(x) for x in torch.cat(run["generated"], 1)[0, :8]])


def init_model(torch, dev, cfg, B, S, seed):
    """Seeded random weights and prompts on the card; (params, prompts,
    seconds)."""
    from repro_torch.models import lm

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    params = lm.init_params(gen, cfg)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            device=dev)
    torch.cuda.synchronize()
    return params, prompts, time.perf_counter() - t0


def model_phase(torch, dev) -> dict:
    """InternLM2-1.8B at full width: prefill 8 x 1024 seeded tokens, then
    150 greedy decode steps, through the serving step builders."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention

    B, S, OUT = 8, 1024, OUT_TOKENS
    cfg = get_config("internlm2-1.8b")
    n_layers = cfg.num_layers
    params, prompts, init_s = init_model(torch, dev, cfg, B, S, seed=1)
    ops = {"flash_attention": flash_attention,
           "decode_attention": decode_attention}
    run = serve_lm(torch, dev, cfg, params, prompts, OUT, ops,
                   watch={0, OUT // 2 - 1, OUT - 1})
    check_launches(cfg, "prefill", run["prefill_launches"],
                   {"flash_attention": n_layers, "decode_attention": 0})
    check_launches(cfg, "decode", run["decode_launches"],
                   {"flash_attention": 0, "decode_attention": n_layers * OUT})
    rels = prefill_decode_rel(torch, params, cfg, prompts, run)
    log("model", **served_fields(torch, cfg, params, run, OUT, init_s),
        prefill_to_decode_rel=rels)
    by_variant, lse = variant_totals(run), lse_launches(run)
    del params, run
    torch.cuda.empty_cache()
    return ({"flash_attention": n_layers, "decode_attention": n_layers * OUT,
             DECODE_LSE: lse}, by_variant)


@contextlib.contextmanager
def patched(obj, name: str, value):
    """``obj.<name>`` is ``value`` while the block runs."""
    orig = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, orig)


@contextlib.contextmanager
def recorded_dispatch(blocks):
    """Record every MoE layer's dispatch inside the block as (router probs,
    slot table, capacity), on the device (no host sync per layer)."""
    seen = []
    plain = blocks.moe_dispatch_indices

    def recording(probs, *, top_k, capacity):
        out = plain(probs, top_k=top_k, capacity=capacity)
        seen.append((probs, out[2], capacity))
        return out

    with patched(blocks, "moe_dispatch_indices", recording):
        yield seen


def moe_twin(torch, cfg, params, prompts, steps, watch) -> dict:
    """Prefill -> greedy decode of a dropless MoE model, each watched decode
    step against the full forward over the same tokens: ``rel``, max |full -
    decode| over max |full| of the last-token logits (over the batch and per
    row); per row the number of layers whose top-1 expert for that token
    differs between the two; and per row the first such layer as [layer,
    the full forward's top-1 minus top-2 router probability there, the
    largest difference between the two runs' router probabilities there]:
    a flip where the margin is within that difference is a near-tie that
    rounding tipped over."""
    from repro_torch.models import blocks, lm

    B, S = prompts.shape
    cap = S + steps
    logits, cache = lm.prefill(params, cfg, prompts, capacity=cap)
    token = logits.argmax(-1, keepdim=True)
    seq, out = [prompts], {}
    for t in range(steps):
        seq.append(token)
        with recorded_dispatch(blocks) as dec:
            logits, cache = lm.decode_step(params, cfg, token, cache,
                                           S + t + 1, capacity=cap)
        if t in watch:
            with recorded_dispatch(blocks) as fwd:
                hidden, _, _ = lm.forward(params, cfg, torch.cat(seq, 1))
            full = lm.logits_of(params, cfg, hidden)
            diff = (full - logits).abs()
            dec_p = torch.stack([p.reshape(B, -1) for p, _, _ in dec])
            fwd_p = torch.stack([p[:, -1] for p, _, _ in fwd])  # (L, B, E)
            flips = dec_p.argmax(-1) != fwd_p.argmax(-1)  # (L, B)
            top2 = fwd_p.topk(2, dim=-1).values
            margin = top2[..., 0] - top2[..., 1]
            gap = (dec_p - fwd_p).abs().amax(-1)
            first = [None] * B
            for layer, b in torch.nonzero(flips).tolist():
                if first[b] is None:
                    first[b] = [layer, float(margin[layer, b]),
                                float(gap[layer, b])]
            out[str(t)] = dict(
                rel=float(diff.max() / full.abs().max()),
                rel_by_row=(diff.amax(-1) / full.abs().amax(-1)).tolist(),
                top1_flips_by_row=flips.sum(0).tolist(),
                first_flip_by_row=first)
        token = logits.argmax(-1, keepdim=True)
    return out


def moe_phase(torch, dev) -> dict:
    """The MoE cloud tier, Llama-4-Scout (16 experts top-1 + a shared
    expert, chunked attention 8192) at its published widths with 12 of its
    48 layers, bf16, seeded random weights: prefill 8 x 1024 tokens at
    capacity factor 1.25, then 150 greedy decode steps.  Launches: 36
    moe_gmm and 12 flash_attention per prefill, 36 moe_gmm and 12
    decode_attention per decode step.

    A prefill that drops tokens by capacity cannot match a full forward over
    a longer sequence (whose capacity differs), so prefill -> decode is held
    on dropless twins (capacity factor 16), 2 x 256 tokens and 16 decode
    steps, watched at steps 0, 7 and 15.  In bf16 a top-1 router near-tie
    can tip either way between the decode step and the full forward, and a
    token whose expert changes at one layer leaves on another path: so the
    bf16 twin (the served weights, 12 layers) is measured and its top-1
    flips counted, and the check, rel < REL_DECODE, is held on an fp32 twin
    of the served weights' first TWIN_LAYERS layers, embedding and head,
    widened to fp32."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.moe_gmm.ops import moe_gmm
    from repro_torch.models import blocks, lm
    from repro_torch.optim.optimizers import tree_map

    B, S, OUT = 8, 1024, OUT_TOKENS
    published = get_config("llama4-scout-17b-a16e")
    cfg = published.with_overrides(num_layers=SCOUT_LAYERS)
    L = cfg.num_layers
    params, prompts, init_s = init_model(torch, dev, cfg, B, S, seed=2)
    torch.cuda.empty_cache()  # the init's fp32 draws

    with recorded_dispatch(blocks) as seen:
        lm.prefill(params, cfg, prompts, capacity=S + OUT)
        dropped = sum(int((slots == p.shape[-1] * c).sum())
                      for p, slots, c in seen)
        assigned = sum(slots.numel() for _, slots, _ in seen)
        capacity = seen[0][2]
    del seen
    ops = {"moe_gmm": moe_gmm, "flash_attention": flash_attention,
           "decode_attention": decode_attention}
    run = serve_lm(torch, dev, cfg, params, prompts, OUT, ops, watch=set())
    check_launches(cfg, "prefill", run["prefill_launches"],
                   {"moe_gmm": 3 * L, "flash_attention": L,
                    "decode_attention": 0})
    check_launches(cfg, "decode", run["decode_launches"],
                   {"moe_gmm": 3 * L * OUT, "flash_attention": 0,
                    "decode_attention": L * OUT})
    fields = served_fields(torch, cfg, params, run, OUT, init_s)
    by_variant, lse = variant_totals(run), lse_launches(run)
    del run

    t_B, t_S, t_OUT = 2, 256, 16
    t_prompts = prompts[:t_B, :t_S].contiguous()
    watch = {0, t_OUT // 2 - 1, t_OUT - 1}
    bf16_twin = moe_twin(torch, cfg.with_overrides(capacity_factor=16.0),
                         params, t_prompts, t_OUT, watch)

    # the fp32 twin: slice the first layers out, free the rest, widen
    units = params["stack"]["units"]  # stacked, or a per-unit list
    units = units[:TWIN_LAYERS] if isinstance(units, list) else tree_map(
        lambda t: t[:TWIN_LAYERS].clone(), units)
    del params["stack"]
    torch.cuda.empty_cache()
    params["stack"] = {"units": units}
    params = tree_map(lambda t: t.float(), params)
    torch.cuda.empty_cache()
    twin = cfg.with_overrides(num_layers=TWIN_LAYERS, dtype="float32",
                              capacity_factor=16.0)
    fp32_twin = moe_twin(torch, twin, params, t_prompts, t_OUT, watch)
    for t, r in fp32_twin.items():
        if not r["rel"] < REL_DECODE:
            raise AssertionError(f"{twin.name} fp32 twin, decode step {t}: "
                                 f"logits differ from the full forward by "
                                 f"rel {r['rel']}")
    log("moe_model", **fields, layers_published=published.num_layers,
        experts=cfg.num_experts, top_k=cfg.experts_per_token,
        moe_d_ff=cfg.moe_d_ff, capacity_factor=cfg.capacity_factor,
        prefill_capacity_per_group=capacity,
        prefill_dropped_share=dropped / assigned,
        moe_gmm_launches=fields["prefill_launches"]["moe_gmm"]
        + fields["decode_launches"]["moe_gmm"],
        dropless_twin=dict(capacity_factor=16.0, batch=t_B, prompt_tokens=t_S,
                           decode_steps=t_OUT, bf16_layers=L,
                           bf16_prefill_to_decode=bf16_twin,
                           fp32_layers=TWIN_LAYERS,
                           fp32_prefill_to_decode=fp32_twin))
    del params
    torch.cuda.empty_cache()
    return ({"moe_gmm": 3 * L * (1 + OUT), "flash_attention": L,
             "decode_attention": L * OUT, DECODE_LSE: lse}, by_variant)


def hybrid_phase(torch, dev) -> dict:
    """The hybrid edge tier, RecurrentGemma-2B ((RG-LRU, RG-LRU, local
    attention) x 8 + 2 RG-LRU; MQA, hd 256, window 2048) at full width and
    depth, bf16, seeded random weights: prefill 4 x 3072 tokens (past the
    window, so the ring is filled at slots pos % 2048 and every decode step
    reads a wrapped ring), then 150 greedy decode steps.  Launches: 18
    rglru_scan and 8 flash_attention per prefill, 8 decode_attention and no
    rglru_scan per decode step (decode runs the closed-form step).
    Prefill -> decode at steps 0, 74 and 149 within REL_DECODE."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.rglru_scan.ops import rglru_scan_op

    B, S, OUT = 4, 3072, OUT_TOKENS
    cfg = get_config("recurrentgemma-2b")
    n_rec = cfg.layer_types.count("rglru")
    n_attn = cfg.layer_types.count("attn")
    params, prompts, init_s = init_model(torch, dev, cfg, B, S, seed=3)
    ops = {"rglru_scan": rglru_scan_op, "flash_attention": flash_attention,
           "decode_attention": decode_attention}
    run = serve_lm(torch, dev, cfg, params, prompts, OUT, ops,
                   watch={0, OUT // 2 - 1, OUT - 1})
    check_launches(cfg, "prefill", run["prefill_launches"],
                   {"rglru_scan": n_rec, "flash_attention": n_attn,
                    "decode_attention": 0})
    check_launches(cfg, "decode", run["decode_launches"],
                   {"rglru_scan": 0, "flash_attention": 0,
                    "decode_attention": n_attn * OUT})
    # the block feeds the scan fp32 decays and inputs (models/blocks.py)
    route = scan_route(B, S, cfg.rnn_state_dim, torch.float32, False)
    check_launches(cfg, "prefill rglru_scan by route",
                   run["prefill_variants"]["rglru_scan"],
                   {r: n_rec * (r == route) for r in SCAN_ROUTES})
    rels = prefill_decode_rel(torch, params, cfg, prompts, run)
    log("hybrid_model",
        **served_fields(torch, cfg, params, run, OUT, init_s),
        rglru_layers=n_rec, attention_layers=n_attn,
        window=cfg.window_size, rnn_state_dim=cfg.rnn_state_dim,
        prefill_to_decode_rel=rels)
    by_variant, lse = variant_totals(run), lse_launches(run)
    del params, run
    torch.cuda.empty_cache()
    return ({"rglru_scan": n_rec, "flash_attention": n_attn,
             "decode_attention": n_attn * OUT, DECODE_LSE: lse}, by_variant)


def stub_frontend(torch, dev, cfg, B, n, seed):
    """Stub modality embeddings (B, n, d_model) in the activation dtype:
    the audio frames or vision patches a config's frontend stands for."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return torch.randn((B, n, cfg.d_model), generator=gen,
                       device=dev).to(cfg.activation_dtype)


def greedy_run(torch, params, cfg, prompts, steps, watch, frontend) -> dict:
    """A prefill of ``prompts`` (with a VLM's ``frontend``) and ``steps``
    greedy decode steps through ``lm`` directly, uncounted: the generated
    tokens and the logits of the steps in ``watch``, in the form
    ``prefill_decode_rel`` reads."""
    from repro_torch.models import lm

    S = prompts.shape[1]
    logits, cache = lm.prefill(params, cfg, prompts, frontend=frontend,
                               capacity=S + steps)
    token, generated, kept = logits.argmax(-1, keepdim=True), [], {}
    for t in range(steps):
        generated.append(token)
        logits, cache = lm.decode_step(params, cfg, token, cache, S + t + 1,
                                       capacity=S + steps)
        if t in watch:
            kept[t] = logits
        token = logits.argmax(-1, keepdim=True)
    return dict(generated=generated, watch=kept, decode_extra=(),
                frontend=frontend)


def teacher_forced_rel(torch, params, cfg, prompts, first, lengths,
                       limit=REL_DECODE) -> dict:
    """Prefill the first ``first`` prompt tokens, then decode the rest of
    the prompt one token at a time; at each length in ``lengths`` the
    decode step's logits against the full forward over the same tokens,
    as max |diff| over max |full|, which must be below ``limit`` (None:
    measured only; a NaN always fails)."""
    from repro_torch.models import lm

    S = prompts.shape[1]
    _, cache = lm.prefill(params, cfg, prompts[:, :first], capacity=S)
    rels = {}
    for n in range(first, max(lengths)):
        logits, cache = lm.decode_step(params, cfg, prompts[:, n:n + 1],
                                       cache, n + 1, capacity=S)
        if n + 1 in lengths:
            hidden, _, _ = lm.forward(params, cfg, prompts[:, :n + 1])
            full = lm.logits_of(params, cfg, hidden)
            rels[str(n + 1)] = float((full - logits).abs().max()
                                     / full.abs().max())
    worst = max(rels.values())
    if not (worst < limit if limit is not None else worst == worst):
        raise AssertionError(f"{cfg.name}: teacher-forced decode logits "
                             f"differ from the full forward by rel {rels} "
                             "(tokens: rel)")
    return rels


def xlstm_phase(torch, dev) -> dict:
    """The smallest edge SLM of ``MODEL_CATALOG``, xlstm-125m whole ((5 mLSTM + 1 sLSTM) x 2, d
    768, 4 heads; mLSTM inner width 1536 in heads of 384), bf16, seeded
    random weights: prefill 8 x 1024 tokens, then 150 greedy decode steps.
    None of the six kernels is on this path (the JAX package has no Pallas
    kernel for these blocks): flash and decode attention must launch 0
    times.  The mLSTM prefill runs chunks of MLSTM_CHUNK tokens and refuses
    a sequence that is not a whole number of them, so no full forward
    exists over the 1025..1174 tokens of the served steps: prefill ->
    decode is checked by teacher forcing instead (prefill 256 prompt
    tokens, decode the other 768 one at a time, compare at 512, 768 and
    1024 tokens).  In bf16 the two schedules part by more than REL_DECODE
    at random weights (each layer turns one-ulp differences of its bf16
    output into larger ones, and the recurrent state keeps them), so the
    bf16 run is measured and the check, rel < REL_DECODE, is held on an
    fp32 twin: the served weights widened to fp32.  One sLSTM layer's
    prefill (a Python loop of 1024 steps) is timed alone."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models import blocks
    from repro_torch.optim.optimizers import tree_map

    B, S, OUT = 8, 1024, OUT_TOKENS
    cfg = get_config("xlstm-125m")
    params, prompts, init_s = init_model(torch, dev, cfg, B, S, seed=4)
    ops = {"flash_attention": flash_attention,
           "decode_attention": decode_attention}
    run = serve_lm(torch, dev, cfg, params, prompts, OUT, ops, watch=set())
    none = {"flash_attention": 0, "decode_attention": 0}
    check_launches(cfg, "prefill", run["prefill_launches"], none)
    check_launches(cfg, "decode", run["decode_launches"], none)
    fields = served_fields(torch, cfg, params, run, OUT, init_s)
    by_variant, lse = variant_totals(run), lse_launches(run)
    del run
    lengths = (2 * MLSTM_CHUNK, 3 * MLSTM_CHUNK, S)
    t0 = time.perf_counter()
    bf16_rels = teacher_forced_rel(torch, params, cfg, prompts, MLSTM_CHUNK,
                                   lengths, limit=None)
    forced_s = time.perf_counter() - t0
    twin = cfg.with_overrides(dtype="float32")
    rels = teacher_forced_rel(torch, tree_map(lambda t: t.float(), params),
                              twin, prompts, MLSTM_CHUNK, lengths)

    j = cfg.block_pattern.index("slstm")
    units = params["stack"]["units"]
    slstm = (units[0] if isinstance(units, list)
             else tree_map(lambda t: t[0], units))[f"b{j}"]
    x = stub_frontend(torch, dev, cfg, B, S, seed=9)  # any (B, S, d) input
    ctx = blocks.BlockCtx(mode="train",
                          positions=torch.arange(S, device=dev)[None])
    blocks.apply_slstm_block(slstm, x[:, :8], ctx, cfg)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blocks.apply_slstm_block(slstm, x, ctx, cfg)
    torch.cuda.synchronize()
    slstm_ms = 1e3 * (time.perf_counter() - t0)
    inner = 2 * cfg.d_model
    log("xlstm_model", **fields, block_pattern=list(cfg.block_pattern),
        mlstm_inner=inner, mlstm_head_dim=inner // cfg.num_heads,
        mlstm_chunk=MLSTM_CHUNK, slstm_layer_prefill_ms=slstm_ms,
        teacher_forced=dict(prefill_tokens=MLSTM_CHUNK,
                            decode_steps=S - MLSTM_CHUNK,
                            bf16_seconds=forced_s,
                            bf16_prefill_to_decode_rel=bf16_rels,
                            fp32_prefill_to_decode_rel=rels))
    del params, x
    torch.cuda.empty_cache()
    return {**none, DECODE_LSE: lse}, by_variant


def encdec_phase(torch, dev) -> dict:
    """The speech tier, seamless-m4t-medium whole (12 bidirectional encoder
    layers over stub audio frames, 12 decoder layers with
    cross-attention; d 1024, 16 heads of 64, vocab 256206), bf16, seeded
    random weights: 8 x 4096 frames (ENCDEC_DECODE_SRC_LEN) and an 8 x 128
    decoder prefix (ENCDEC_DECODER_PREFIX) through the enc-dec prefill
    step, which encodes once and returns the encoder output, then 150
    greedy decode steps that take it back.  Launches: 36 flash_attention
    per prefill (12 encoder, non-causal over 4096 frames; 12 decoder,
    causal; 12 cross, 128 rows against 4096 frames), 12 decode_attention
    and 12 flash_attention (cross, one row against 4096 frames) per decode
    step.  Prefill -> decode at steps 0, 74 and 149 within REL_DECODE,
    against the full decoder forward on the served encoder output."""
    from repro_torch.configs import (ENCDEC_DECODE_SRC_LEN,
                                     ENCDEC_DECODER_PREFIX, get_config)
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention

    B, S, T, OUT = 8, ENCDEC_DECODER_PREFIX, ENCDEC_DECODE_SRC_LEN, OUT_TOKENS
    cfg = get_config("seamless-m4t-medium")
    L, Le = cfg.num_layers, cfg.num_encoder_layers
    params, prompts, init_s = init_model(torch, dev, cfg, B, S, seed=5)
    frames = stub_frontend(torch, dev, cfg, B, T, seed=6)
    ops = {"flash_attention": flash_attention,
           "decode_attention": decode_attention}
    run = serve_lm(torch, dev, cfg, params, prompts, OUT, ops,
                   watch={0, OUT // 2 - 1, OUT - 1}, frontend=frames)
    check_launches(cfg, "prefill", run["prefill_launches"],
                   {"flash_attention": Le + 2 * L, "decode_attention": 0})
    check_launches(cfg, "decode", run["decode_launches"],
                   {"flash_attention": L * OUT, "decode_attention": L * OUT})
    rels = prefill_decode_rel(torch, params, cfg, prompts, run)
    log("encdec_model", **served_fields(torch, cfg, params, run, OUT, init_s),
        encoder_layers=Le, source_frames=T,
        source_frames_per_s=B * T / run["prefill_s"],
        prefill_to_decode_rel=rels)
    by_variant, lse = variant_totals(run), lse_launches(run)
    del params, run, frames
    torch.cuda.empty_cache()
    return ({"flash_attention": Le + 2 * L + L * OUT,
             "decode_attention": L * OUT, DECODE_LSE: lse}, by_variant)


def vlm_phase(torch, dev) -> dict:
    """The VLM family, llava-next-34b at full width and depth (60 layers, d 7168, 56 / 8
    heads of 128, d_ff 20480, vocab 64000; 68.9 GB of bf16 weights),
    seeded random weights: 4 prompts of 1024 tokens whose first 576 slots
    are stub patch embeddings (the VLM prefill step merges them), then 150
    greedy decode steps.  Launches: 60 flash_attention per prefill, 60
    decode_attention per decode step.  Prefill -> decode at steps 0, 74
    and 149 within REL_DECODE against the full forward, whose first 576
    slots are the same patches.

    At 60 bf16 layers that difference is above REL_DECODE (one-ulp
    differences of the bf16 hidden state grow with depth: InternLM2's 24
    layers give ~1.4e-2), so the served run's is measured, and the check,
    rel < REL_DECODE at the same steps, is held on an fp32 twin: the served
    weights' first VLM_TWIN_LAYERS layers, embedding, head and frontend
    projection, widened to fp32, on the same prompts and patches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.optim.optimizers import tree_map

    B, S, OUT = 4, 1024, OUT_TOKENS
    cfg = get_config("llava-next-34b")
    L, P = cfg.num_layers, cfg.frontend_len
    params, prompts, init_s = init_model(torch, dev, cfg, B, S, seed=7)
    torch.cuda.empty_cache()  # the init's fp32 draws
    patches = stub_frontend(torch, dev, cfg, B, P, seed=8)
    ops = {"flash_attention": flash_attention,
           "decode_attention": decode_attention}
    run = serve_lm(torch, dev, cfg, params, prompts, OUT, ops,
                   watch={0, OUT // 2 - 1, OUT - 1}, frontend=patches)
    check_launches(cfg, "prefill", run["prefill_launches"],
                   {"flash_attention": L, "decode_attention": 0})
    check_launches(cfg, "decode", run["decode_launches"],
                   {"flash_attention": 0, "decode_attention": L * OUT})
    watch = set(run["watch"])
    bf16_rels = prefill_decode_rel(torch, params, cfg, prompts, run,
                                   limit=None)
    fields = served_fields(torch, cfg, params, run, OUT, init_s)
    by_variant, lse = variant_totals(run), lse_launches(run)
    del run

    # the fp32 twin: slice the first layers out, free the rest, widen
    n = min(VLM_TWIN_LAYERS, L)
    units = params["stack"]["units"]  # stacked, or a per-unit list
    units = units[:n] if isinstance(units, list) else \
        tree_map(lambda t: t[:n].clone(), units)
    del params["stack"]
    torch.cuda.empty_cache()
    params["stack"] = {"units": units}
    params = tree_map(lambda t: t.float(), params)
    torch.cuda.empty_cache()
    twin = cfg.with_overrides(num_layers=n, dtype="float32")
    twin_run = greedy_run(torch, params, twin, prompts, OUT, watch,
                          patches.float())
    rels = prefill_decode_rel(torch, params, twin, prompts, twin_run)
    log("vlm_model", **fields, patch_slots=P,
        weights_gb=cfg.param_count() * 2 / 1e9,
        bf16_prefill_to_decode_rel=bf16_rels,
        fp32_twin=dict(layers=n, prefill_to_decode_rel=rels))
    del params, twin_run, patches
    torch.cuda.empty_cache()
    return ({"flash_attention": L, "decode_attention": L * OUT,
             DECODE_LSE: lse}, by_variant)


# -- training ------------------------------------------------------------------

TRAIN_STEPS = 4  # optimizer steps of the full-width run
TRAIN_B, TRAIN_S, TRAIN_MB = 4, 4096, 2  # SHAPE_SUITE's train_4k length
TRAIN_LONG_S = 8192  # the backward kernel's long shape (B 1)
TWIN_TRAIN_LAYERS = 2  # the fp32 twin and the restart run: 2 layers, full width
LSE_ATOL = 1e-5  # the lse forward against its plain version
F32_GRAD_REL = 1e-4  # fp32 twin grads: within 1e-4 of each leaf's max |g|
F32_LOSS_REL = 1e-5
RESTART_ATOL = 1e-4  # tests/test_fault_tolerance.py::test_train_restart_determinism
# Llama-4-Scout trained at full width cut to 2 of 48 layers: 6.47 B params,
# bf16 weights and grads and the fp32 grad accumulator (52 GB), beside one
# 1 x 4096 microbatch under per-unit remat
SCOUT_TRAIN_LAYERS = 2
SCOUT_TRAIN_B, SCOUT_TRAIN_S = 4, 4096  # in the uncut model's 4 microbatches
MOE_TWIN_LAYERS = 1  # Scout's fp32 twin at full width (4.27 B params)
HYBRID_TRAIN_B, HYBRID_TRAIN_S, HYBRID_TRAIN_MB = 2, 4096, 2  # past the window
HYBRID_TWIN_LAYERS = 3  # one (rglru, rglru, attn) pattern: twin and restart
MOE_HYBRID_STEPS = 3  # optimizer steps of the Scout and RecurrentGemma runs


def cut_layers(n: int):
    """``repro_torch.configs.get_config`` hands out its configs cut to ``n``
    layers while the block runs (``launch.train.train`` takes an arch
    name)."""
    import repro_torch.configs as configs

    orig = configs.get_config
    return patched(configs, "get_config",
                   lambda name: orig(name).with_overrides(num_layers=n))


@contextlib.contextmanager
def timed_writes():
    """Seconds and bytes of every checkpoint write (``Checkpointer._write``,
    the thread's part of ``save_async``) while the block runs."""
    from repro_torch.checkpoint.checkpointer import Checkpointer

    orig = Checkpointer._write
    writes = []

    def wrapper(self, step, leaves, treedef):
        t0 = time.perf_counter()
        out = orig(self, step, leaves, treedef)
        writes.append(dict(step=step, ms=1e3 * (time.perf_counter() - t0),
                           bytes=sum(f.stat().st_size
                                     for f in out.iterdir())))
        return out

    with patched(Checkpointer, "_write", wrapper):
        yield writes


def plain_attention():
    """The model's prefill attention through the plain version on the card
    (``flash_attention_ref``, differentiated by autograd) while the block
    runs: the reference the fp32 twins' kernels are held against."""
    import repro_torch.models.layers as layers
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    return patched(layers, "flash_attention", flash_attention_ref)


@contextlib.contextmanager
def together(*contexts):
    """Every context of ``contexts`` entered while the block runs."""
    with contextlib.ExitStack() as stack:
        for c in contexts:
            stack.enter_context(c)
        yield


def plain_moe_gmm():
    """The MoE FFN's products through the plain version (``moe_gmm_ref``,
    differentiated by autograd) while the block runs."""
    from repro_torch.kernels.moe_gmm.ref import moe_gmm_ref
    from repro_torch.models import blocks

    return patched(blocks, "moe_gmm", moe_gmm_ref)


def plain_scan():
    """The RG-LRU recurrence through the plain loop (``rglru_scan_ref``,
    differentiated by autograd) while the block runs."""
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
    from repro_torch.models import blocks

    return patched(blocks, "rglru_scan_op", rglru_scan_ref)


@contextlib.contextmanager
def recorded_experts(blocks):
    """Record the experts every router's top-k picks inside the block, call
    by call (a unit under remat picks twice)."""
    seen = []
    plain = blocks._top_k

    def recording(probs, k):
        vals, idx = plain(probs, k)
        seen.append(idx)
        return vals, idx

    with patched(blocks, "_top_k", recording):
        yield seen


@contextlib.contextmanager
def replayed_experts(blocks, seen):
    """Every router's top-k takes the experts of ``seen`` call by call, at
    this run's probabilities; ``flips[0]`` counts the picks this run's own
    top-k would have changed (a near-tie that rounding tipped)."""
    plain = blocks._top_k
    calls, flips = iter(seen), [0]

    def replaying(probs, k):
        idx = next(calls)
        flips[0] += int((plain(probs, k)[1] != idx).sum())
        return probs.gather(-1, idx), idx

    with patched(blocks, "_top_k", replaying):
        yield flips


# every launch counter a train step may move, by op
TRAIN_COUNTERS = {
    "flash_attention": ("launches", "launches_tc", "launches_ffma",
                        "launches_lse", "launches_lse_tc", "launches_lse_ffma",
                        "launches_bwd", "launches_bwd_tc",
                        "launches_bwd_ffma"),
    "moe_gmm": ("launches", "launches_tc", "launches_ffma", "launches_bwd",
                "launches_bwd_tc", "launches_bwd_ffma"),
    "rglru_scan_op": ("launches", "launches_tma", "launches_cp_async",
                      "launches_bwd", "launches_bwd_tma",
                      "launches_bwd_cp_async"),
    "decode_attention": ("launches", "launches_lse", "launches_lse_tc",
                         "launches_lse_ffma"),
}


def train_ops() -> dict:
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.moe_gmm.ops import moe_gmm
    from repro_torch.kernels.rglru_scan.ops import rglru_scan_op

    return {"flash_attention": flash_attention, "moe_gmm": moe_gmm,
            "rglru_scan_op": rglru_scan_op,
            "decode_attention": decode_attention}


def read_counts(ops) -> dict:
    """Every train counter as ``"<op>.<counter>"``."""
    return {f"{op}.{c}": getattr(ops[op], c)
            for op, cs in TRAIN_COUNTERS.items() for c in cs}


def want_counts(moved: dict) -> dict:
    """Every train counter: ``moved``'s values, 0 for the rest."""
    want = {f"{op}.{c}": 0 for op, cs in TRAIN_COUNTERS.items() for c in cs}
    unknown = set(moved) - set(want)
    if unknown:
        raise KeyError(f"not train counters: {sorted(unknown)}")
    want.update(moved)
    return want


class StepWatch:
    """The ``on_step`` of a driven train run: every train counter is set to
    0 at ``start()``, and each step's launches (the counters after the step
    minus before) and metrics are kept; step ``profiled`` runs under the
    profiler (device kernels only)."""

    def __init__(self, torch, profiled: int):
        from torch.profiler import ProfilerActivity, profile

        self.torch, self.profiled, self.ops = torch, profiled, train_ops()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.steps, self.per_step = [], []

    def start(self) -> None:
        for op, cs in TRAIN_COUNTERS.items():
            for c in cs:
                setattr(self.ops[op], c, 0)
        self.last = read_counts(self.ops)

    def __call__(self, i: int, metrics: dict) -> None:
        self.torch.cuda.synchronize()
        now = read_counts(self.ops)
        self.per_step.append({k: now[k] - self.last[k] for k in now})
        self.last = now
        self.steps.append(dict(step=i, **metrics))
        if i == self.profiled - 1:
            self.prof.start()
        elif i == self.profiled:
            self.prof.stop()

    def check(self, what: str, want: dict) -> dict:
        """Every step launched exactly ``want`` and has a finite loss and
        grad norm; the launches summed over the run."""
        moved = lambda counts: {k: v for k, v in counts.items() if v}
        for i, got in enumerate(self.per_step):
            if got != want:
                raise AssertionError(f"{what} step {i} launched "
                                     f"{moved(got)}, want {moved(want)}")
        for s in self.steps:
            loss, norm = s["loss"], s["grad_norm"]
            if not (math.isfinite(loss) and math.isfinite(norm)):
                raise AssertionError(f"{what} step {s['step']}: loss {loss}, "
                                     f"grad norm {norm}")
        return {k: sum(p[k] for p in self.per_step) for k in want}

    def profiled_fields(self, role) -> dict:
        """The profiled step's wall and device busy time, its eight largest
        kernels, and [ms, calls] of the kernels ``role(name)`` names."""
        from torch.autograd import DeviceType

        events = [e for e in self.prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0]
        busy_ms = sum(e.self_device_time_total for e in events) / 1e3
        events.sort(key=lambda e: -e.self_device_time_total)
        split = {}
        for e in events:
            r = role(e.key)
            if r is not None:
                ms_calls = split.setdefault(r, [0.0, 0])
                ms_calls[0] += e.self_device_time_total / 1e3
                ms_calls[1] += e.count
        step_ms = 1e3 * self.steps[self.profiled]["step_s"]
        out = dict(profiled_step_ms=step_ms, profiled_device_busy_ms=busy_ms,
                   profiled_device_idle_share=1.0 - busy_ms / step_ms,
                   profiled_top_kernels=[
                       [e.key[:100], e.self_device_time_total / 1e3, e.count]
                       for e in events[:8]],
                   profiled_ms_calls=split)
        del self.prof
        return out

    def step_fields(self, timed: tuple) -> dict:
        """Step wall ms (the mean of the ``timed`` steps, and every step's),
        losses and grad norms."""
        ms = [1e3 * s["step_s"] for s in self.steps]
        return dict(step_ms=statistics.mean(ms[i] for i in timed),
                    timed_steps=list(timed), step_ms_by_step=ms,
                    losses=[s["loss"] for s in self.steps],
                    grad_norms=[s["grad_norm"] for s in self.steps])


def loss_and_grads(torch, cfg, params, batch):
    """``lm.train_loss`` and the gradient of every leaf, as
    ``build_train_step`` takes them."""
    from repro_torch.models import lm
    from repro_torch.optim.optimizers import tree_leaves, tree_map

    leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, _ = lm.train_loss(leaves, cfg, batch)
    return (float(loss.detach()),
            torch.autograd.grad(loss, tree_leaves(leaves)))


def fp32_twin(torch, dev, cfg, seed, want, plain) -> dict:
    """An fp32 twin at full width: ``lm.train_loss`` and every grad leaf of
    ``cfg`` at B 1 x S 1024, seeded weights and tokens, through the kernels
    (their launches exactly ``want``) against the same with the plain
    versions that ``plain()`` patches in, on the card: loss within
    F32_LOSS_REL, each leaf within F32_GRAD_REL of its max |g|.  The plain
    run takes the kernel run's experts (``replayed_experts``: in an MoE
    model a router near-tie may tip between the two runs), and the picks
    that its own router would have changed are logged."""
    from repro_torch.models import blocks

    params, tokens, _ = init_model(torch, dev, cfg, 1, 1025, seed=seed)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    ops = train_ops()
    before = read_counts(ops)
    with recorded_experts(blocks) as seen:
        loss, grads = loss_and_grads(torch, cfg, params, batch)
    torch.cuda.synchronize()
    after = read_counts(ops)
    launches = {k: after[k] - before[k] for k in after}
    if launches != want_counts(want):
        raise AssertionError(f"{cfg.name} fp32 twin launched "
                             f"{({k: v for k, v in launches.items() if v})}, "
                             f"want {want}")
    with plain(), replayed_experts(blocks, seen) as flips:
        ref_loss, ref_grads = loss_and_grads(torch, cfg, params, batch)
    loss_rel = abs(loss - ref_loss) / abs(ref_loss)
    worst = max(float((g - r).abs().max() / r.abs().max().clamp_min(1e-30))
                for g, r in zip(grads, ref_grads))
    if not (loss_rel <= F32_LOSS_REL and worst <= F32_GRAD_REL):
        raise AssertionError(f"{cfg.name} fp32 twin: loss rel {loss_rel}, "
                             f"worst grad leaf {worst}")
    del params, grads, ref_grads
    torch.cuda.empty_cache()
    return dict(layers=cfg.num_layers, batch=1, seq=1024, loss=loss,
                plain_loss=ref_loss, loss_rel=loss_rel,
                worst_grad_leaf_rel=worst, launches=want,
                replayed_expert_flips=flips[0])


def restart_check(torch, arch: str, layers: int) -> dict:
    """Restart: ``arch`` at full width cut to ``layers`` layers, B 2 x S
    1024, 4 steps uninterrupted against 2 steps with a checkpoint at step 2
    resumed by a fresh ``launch.train.train`` call: final losses within
    RESTART_ATOL (bit equality logged), the checkpoints in a directory
    under ``build/`` that is removed."""
    import shutil

    from repro_torch.launch.train import train

    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    kw = dict(reduced=False, batch=2, seq=1024, log_every=100,
              device="cuda", ckpt_every=2)
    try:
        with cut_layers(layers), timed_writes() as writes:
            full = train(arch, steps=4, **kw)
            train(arch, steps=2, ckpt_dir=str(ckpt_dir), **kw)
            resumed = train(arch, steps=4, ckpt_dir=str(ckpt_dir), **kw)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    diff = abs(full[-1] - resumed[-1])
    if not (len(resumed) == 2 and diff <= RESTART_ATOL):
        raise AssertionError(f"{arch} restart: resumed losses {resumed}, "
                             f"uninterrupted {full}")
    torch.cuda.empty_cache()
    return dict(layers=layers, batch=2, seq=1024, steps=4, checkpoint_step=2,
                uninterrupted=full, resumed=resumed, final_loss_diff=diff,
                bit_equal=full[-1] == resumed[-1], checkpoint_writes=writes,
                bytes_written=sum(w["bytes"] for w in writes))


def sdpa_backward_ms(torch, q, k, v, dout, masks) -> tuple:
    """The flash backward's library yardstick: autograd through
    ``scaled_dot_product_attention`` minus its forward, on (B, H, S, hd)
    views of the same inputs.  A causal mask goes in as ``is_causal`` with
    GQA, on PyTorch's own choice of backend ("default"); a window as a
    boolean ``attn_mask``, where every backend that takes it is timed (flash,
    memory-efficient and cuDNN, each with GQA and with K and V repeated to H
    heads, whose backward then sums the group's gradients; then math) and
    the fastest is named.  Returns (backward ms, forward ms, backend)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.flash_attention.ref import visible

    G = q.shape[2] // k.shape[2]
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    dot = dout.transpose(1, 2)
    if not (masks["window"] or masks["chunk_attn"]):
        cands = [("default", None, False, dict(is_causal=masks["causal"]))]
    else:
        mask = dict(attn_mask=visible(q.shape[1], k.shape[1], device=q.device,
                                      **masks))
        cands = [(b.name, b, rep, mask)
                 for b in (SDPBackend.FLASH_ATTENTION,
                           SDPBackend.EFFICIENT_ATTENTION,
                           SDPBackend.CUDNN_ATTENTION)
                 for rep in (False, True)]
        cands.append(("MATH", SDPBackend.MATH, False, mask))
    best = None
    for name, backend, rep, kw in cands:
        def fwd(rep=rep, kw=kw):
            if rep:
                return F.scaled_dot_product_attention(
                    qt, kt.repeat_interleave(G, 1), vt.repeat_interleave(G, 1),
                    **kw)
            return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True,
                                                  **kw)

        def fwd_bwd(fwd=fwd):
            torch.autograd.grad(fwd(), (qt, kt, vt), dot)

        with (sdpa_kernel([backend]) if backend is not None
              else contextlib.nullcontext()):
            try:  # a backend that cannot take these inputs raises here
                fwd_bwd()
                torch.cuda.synchronize()
            except RuntimeError:
                continue
            with torch.no_grad():
                f_ms = time_ms(torch, fwd, 3, 5)
            b_ms = time_ms(torch, fwd_bwd, 3, 5) - f_ms
        if best is None or b_ms < best[0]:
            best = (b_ms, f_ms, name + (", K/V repeated" if rep else ""))
    if best is None:
        raise AssertionError(f"no SDPA backend takes {masks}")
    return best


def flash_bwd_kernels(torch, dev, gen, bw, bf16) -> tuple:
    """The flash backward kernel (and the lse forward) against their plain
    versions in bf16 at the training shape (B 4, S 4096, H 16, Kv 8, hd 128,
    causal: one InternLM2 layer's microbatch pair), the long shape (B 1, S
    8192) and RecurrentGemma-2B's train microbatch (B 1, S 4096, H 10, Kv 1,
    hd 256, causal with a 2048 window: the wide pair, its KV group's heads
    split over dK/dV blocks by ``bwd_head_splits``).  The backward element by
    element within |g - ref| <= 2^-7 |ref| + 2^-8 M (M: the same products
    over magnitudes, ``flash_attention_bwd_ref(..., magnitudes=True)``); two
    calls bit-equal; lse within LSE_ATOL.  The served route (``route_bwd``:
    ``"tc"``) must be checked; times per call and replayed from a CUDA
    graph, the FFMA variant's on the same inputs (its explicit route), the
    plain version's and the library's (``sdpa_backward_ms``); where the
    wide pair splits a KV group's heads, its graph time at other head
    splits too (the plan patched to each).  Bound: q, k,
    v, out, dout, lse read once, dq, dk, dv written once; 10 hd FLOPs per
    visible pair (the five products; the dQ kernel's recomputed S and dP are
    not counted).  The achieved rate is logged on 10 hd and on the 14 hd the
    kernels execute.  Returns the training shape's row and RecurrentGemma's.
    """
    from repro_torch.kernels.common import sm_count
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_lse_ref, visible_pairs)

    dt = torch.bfloat16
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev).to(dt)
    rows = {}
    for where, B, S, H, Kv, hd, window in (
            ("train", TRAIN_B, TRAIN_S, 16, 8, 128, 0),
            ("long", 1, TRAIN_LONG_S, 16, 8, 128, 0),
            ("recurrentgemma", HYBRID_TRAIN_B // HYBRID_TRAIN_MB,
             HYBRID_TRAIN_S, 10, 1, 256, 2048)):
        masks = dict(causal=True, window=window, chunk_attn=0)
        q, dout = randn(B, S, H, hd), randn(B, S, H, hd)
        k, v = randn(B, S, Kv, hd), randn(B, S, Kv, hd)
        out, lse = flash_kernel.launch(q, k, v, "tc", with_lse=True, **masks)
        _, ref_lse = flash_attention_lse_ref(q, k, v, **masks)
        torch.cuda.synchronize()
        lse_err = float((lse - ref_lse).abs().max())
        if not lse_err <= LSE_ATOL:
            raise AssertionError(f"flash lse/{where}: differs from the plain "
                                 f"version by {lse_err}")
        del ref_lse
        variant = flash_kernel.route_bwd(dt, hd)
        if variant != "tc":
            raise AssertionError(f"flash backward/{where}: routed to {variant}")
        splits = flash_kernel.bwd_head_splits(B, S, Kv, H, hd, sm_count(dev))
        bwd = lambda v_=variant: flash_kernel.launch_bwd(
            q, k, v, out, lse, dout, v_, **masks)
        got, again = bwd(), bwd()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"flash backward/{where}: two calls differ")
        del again
        ref = flash_attention_bwd_ref(q, k, v, out, lse, dout, **masks)
        mag = flash_attention_bwd_ref(q, k, v, out, lse, dout, **masks,
                                      magnitudes=True)
        err, ratio = 0.0, 0.0
        for name, g, r, m in zip(("dq", "dk", "dv"), got, ref, mag):
            diff = (g.float() - r.float()).abs()
            lim = 2.0 ** -7 * r.float().abs() + 2.0 ** -8 * m
            worst = float((diff / lim).max())
            if not worst <= 1.0:  # NaN fails too
                raise AssertionError(f"flash backward/{where} {name}: exceeds "
                                     f"its bf16 limit by {worst}x")
            err, ratio = max(err, float(diff.max())), max(ratio, worst)
        del got, ref, mag
        ms = time_ms(torch, bwd, 3, 3)
        dev_ms = graph_ms(torch, bwd, 3, 3)
        ffma_ms = time_ms(torch, lambda: bwd("ffma"), 3, 3)
        plain = time_ms(torch, lambda: flash_attention_bwd_ref(
            q, k, v, out, lse, dout, **masks), 2, 1)
        lib_ms, lib_fwd, backend = sdpa_backward_ms(torch, q, k, v, dout,
                                                    masks)
        splits_ms = {}
        if splits > 1:
            G = H // Kv
            for n in (d for d in range(1, G + 1) if G % d == 0):
                with patched(flash_kernel, "bwd_head_splits",
                             lambda *_, n=n: n):
                    splits_ms[n] = graph_ms(torch, bwd, 3, 3)
        pairs = visible_pairs(S, S, **masks)
        flops10, _ = cost = flash_kernel.cost_bwd(B, S, S, H, Kv, hd, 2,
                                                   **masks)
        b_ms, b_by = cost_bound(bw, bf16, cost)
        row = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                   bound_by=b_by, library_ms=lib_ms, graph_ms=dev_ms)
        log("kernels", kernel="flash_attention_bwd", shape=where, B=B, S=S,
            H=H, Kv=Kv, hd=hd, dtype="bf16", **masks, variant=variant,
            head_splits=splits, graph_ms_by_head_splits=splits_ms,
            ffma_ms=ffma_ms, visible_pairs=pairs,
            bf16_limit_ratio=ratio, lse_max_abs_err=lse_err,
            library_fwd_ms=lib_fwd, library_backend=backend,
            tflops_10hd=flops10 / dev_ms / 1e9,
            tflops_14hd=1.4 * flops10 / dev_ms / 1e9,
            bit_equal_repeat=True, **row)
        rows[where] = row
        del q, k, v, out, lse, dout
        torch.cuda.empty_cache()
    return rows["train"], rows["recurrentgemma"]


def train_phase(torch, dev, gen, bw, bf16, summary) -> tuple:
    """InternLM2-1.8B trained at full width in bf16 through
    ``launch.train.train`` (``build_train_step`` -> ``lm.train_loss``):
    B 4 x S 4096 in 2 microbatches, 4 AdamW steps on warmup_cosine(3e-4,
    2000, 100 000), seed 0.  The counters are set to 0 just before the run
    and read after each step: per optimizer step 24 layers x 2 microbatches
    x 2 (remat) lse-twin flash forwards and 24 x 2 backward launches, all on
    the tensor-core variants, and no other launch.  Every loss and grad norm
    finite.  The third step runs under the profiler (device kernels only;
    the backward's delta, dK/dV and dQ kernels summed apart).  Beside it:
    the backward kernel's rows (``flash_bwd_kernels``), the fp32 twin (2
    layers against the plain attention), and restart (``restart_check``, 2
    layers)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train

    summary["flash_attention_bwd"], summary["flash_attention_bwd_wide"] = \
        flash_bwd_kernels(torch, dev, gen, bw, bf16)
    cfg = get_config("internlm2-1.8b")
    L, n = cfg.num_layers, TWIN_TRAIN_LAYERS
    twin = fp32_twin(
        torch, dev, cfg.with_overrides(num_layers=n, dtype="float32"), 11,
        {"flash_attention.launches_lse": 2 * n,
         "flash_attention.launches_lse_ffma": 2 * n,
         "flash_attention.launches_bwd": n,
         "flash_attention.launches_bwd_ffma": n}, plain_attention)

    watch = StepWatch(torch, profiled=2)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    watch.start()
    t0 = time.perf_counter()
    train("internlm2-1.8b", reduced=False, steps=TRAIN_STEPS, batch=TRAIN_B,
          seq=TRAIN_S, microbatches=TRAIN_MB, log_every=TRAIN_STEPS,
          device="cuda", on_step=watch)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    lse, bwd = 2 * TRAIN_MB * L, TRAIN_MB * L
    want = want_counts({
        "flash_attention.launches_lse": lse,
        "flash_attention.launches_lse_tc": lse,
        "flash_attention.launches_bwd": bwd,
        "flash_attention.launches_bwd_tc": bwd})
    total = watch.check("train", want)
    prof = watch.profiled_fields(
        lambda key: next((k for k in BWD_KERNELS if k in key), None))
    steps = watch.step_fields(timed=(1, 3))
    torch.cuda.empty_cache()
    restart = restart_check(torch, "internlm2-1.8b", TWIN_TRAIN_LAYERS)

    tokens = TRAIN_B * TRAIN_S
    summary["train_model"] = dict(losses=steps["losses"],
                                  step_ms_by_step=steps["step_ms_by_step"])
    log("train_model", arch=cfg.name, dtype=cfg.dtype, layers=L,
        d_model=cfg.d_model, heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, vocab=cfg.vocab_size, params=cfg.param_count(),
        batch=TRAIN_B, seq=TRAIN_S, microbatches=TRAIN_MB, steps=TRAIN_STEPS,
        optimizer="adamw, warmup_cosine(3e-4, 2000, 100000)",
        run_s=run_s, **steps,
        roofline=roofline_fields(cfg, TRAIN_B, TRAIN_S, "train",
                                 steps["step_ms"]),
        tokens_per_s=tokens / (steps["step_ms"] / 1e3),
        peak_memory_gb=peak_gb,
        launches_per_step={k: v for k, v in want.items() if v},
        launches={k: v for k, v in total.items() if v}, **prof,
        fp32_twin=twin, restart=restart)
    return ({"flash_attention": total["flash_attention.launches_lse"],
             "flash_attention_bwd": total["flash_attention.launches_bwd"],
             DECODE_LSE: total["decode_attention.launches_lse"]},
            {"flash_attention": {
                "lse_tc": total["flash_attention.launches_lse_tc"],
                "lse_ffma": total["flash_attention.launches_lse_ffma"]},
             "flash_attention_bwd": {
                 "tc": total["flash_attention.launches_bwd_tc"],
                 "ffma": total["flash_attention.launches_bwd_ffma"]}})


TP_STEPS = 3  # the train_tp run: steps 0-1 timed against train_model
TP_LOSS_REL = 1e-5  # train_tp losses against train_model's (same weights)


@contextlib.contextmanager
def recorded_updates(keep: int):
    """``launch.train``'s optimizer keeps the gradients, and the params and
    state it returns, of its update at step ``keep`` (0-based) while the
    block runs (only that one: an earlier step's gradients kept through the
    next step would raise its peak memory)."""
    import repro_torch.launch.train as train_mod
    from repro_torch.optim.optimizers import Optimizer

    orig, seen = train_mod.default_optimizer, {}

    def recording(cfg):
        opt = orig(cfg)

        def update(grads, state, params, step):
            new = opt.update(grads, state, params, step)
            if step == keep:
                seen["grads"], (seen["params"], seen["state"]) = grads, new
            return new

        return Optimizer(opt.name, opt.init, update)

    with patched(train_mod, "default_optimizer", recording):
        yield seen


def compressed_psum_check(torch, grads) -> dict:
    """``compressed_psum`` over the world of one, leaf by leaf, on a train
    step's gradients (DTensors: their local shards) against the reference's
    result at n = 1, ``decompress_tree(compress_tree(g))`` in fp32: every
    leaf and its new error feedback bit-equal."""
    from repro_torch.optim.grad_compression import (compress_tree,
                                                    compressed_psum,
                                                    decompress_tree)
    from repro_torch.optim.optimizers import tree_leaves

    leaves = [g.to_local() for g in tree_leaves(grads)]
    ms, n, nbytes = 0.0, 0, 0
    for g in leaves:
        zero = torch.zeros(g.shape, dtype=torch.float32, device=g.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        red, err = compressed_psum(g, zero)
        torch.cuda.synchronize()
        ms += 1e3 * (time.perf_counter() - t0)
        comp, want_err = compress_tree(g, zero)
        want = decompress_tree(comp, g.float())
        if not (torch.equal(red, want) and torch.equal(err, want_err)):
            raise AssertionError(f"compressed_psum differs from "
                                 f"decompress(compress(g)) on a leaf of "
                                 f"{tuple(g.shape)}")
        n += g.numel()
        nbytes += comp["q"].numel() + 4 * comp["s"].numel()
        del red, err, comp, want_err, want, zero
    return dict(leaves=len(leaves), values=n, wire_bytes=nbytes,
                bit_equal=True, ms=ms)


def reshard_check(torch, mesh, arch: str, layers: int) -> dict:
    """``reshard_restore``: ``arch`` at full width cut to ``layers`` layers,
    2 steps of B 2 x S 1024 on ``mesh`` with a checkpoint at step 2 (every
    DTensor gathered whole by the save), restored onto the mesh's
    placements from ``meta`` stand-ins: every leaf bit-equal to the params
    and AdamW state the second update returned, and on the policy's
    placements.  The checkpoint directory under ``build/`` is removed."""
    import shutil

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.distributed.fault_tolerance import reshard_restore
    from repro_torch.launch.steps import params_sds
    from repro_torch.launch.train import train
    from repro_torch.optim import adamw, constant_schedule
    from repro_torch.optim.optimizers import tree_leaves

    ckpt_dir = ROOT / "build" / "chip_smoke_reshard"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    try:
        with cut_layers(layers), recorded_updates(keep=1) as seen:
            train(arch, reduced=False, steps=2, batch=2, seq=1024,
                  log_every=100, device="cuda", ckpt_dir=str(ckpt_dir),
                  ckpt_every=2, mesh=mesh)
        cfg = get_config(arch).with_overrides(num_layers=layers)
        p_like = params_sds(cfg)
        o_like = adamw(constant_schedule(0.0)).init(p_like)
        t0 = time.perf_counter()
        step, params, state, policy = reshard_restore(
            Checkpointer(ckpt_dir), (p_like, o_like), mesh, cfg, "adamw")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    got = tree_leaves(params) + tree_leaves(state)
    want = tree_leaves(seen["params"]) + tree_leaves(seen["state"])
    unequal = sum(not torch.equal(a.full_tensor(), b.full_tensor())
                  for a, b in zip(got, want))
    misplaced = sum(a.placements != b.placements for a, b in zip(got, want))
    if step != 2 or unequal or misplaced or len(got) != len(want):
        raise AssertionError(f"reshard_restore: step {step}, {unequal} "
                             f"leaves unequal, {misplaced} misplaced")
    del params, state, seen
    torch.cuda.empty_cache()
    return dict(layers=layers, batch=2, seq=1024, step=step,
                leaves=len(got), bit_equal=True, restore_s=restore_s)


def train_tp_phase(torch, dev, summary) -> tuple:
    """InternLM2-1.8B trained at full width through ``launch.train.train``
    on an explicit (1, 1) ``DeviceMesh`` over a one-rank ``nccl`` world:
    parameters and AdamW state are DTensors placed by ``ShardingPolicy``,
    the step runs under its activation policy, and each flash launch runs on
    the rank's shard (``distributed/api.py: local_attention``).  B 4 x S
    4096 in 2 microbatches, seed 0, the weights of ``train_model``: its
    first losses within TP_LOSS_REL (bit equality logged); per step 96
    lse-twin flash forwards and 48 backwards, all tensor-core, and no other
    launch; step ms beside ``train_model``'s (step 1 of both runs is
    timed), step 2 profiled (device busy against wall: DTensor's host
    dispatch), peak memory.  Then ``compressed_psum`` on the last step's
    gradients (``compressed_psum_check``) and ``reshard_restore`` of a
    2-layer step-2 checkpoint (``reshard_check``).  The process group is
    destroyed before the next phase."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_world, make_host_mesh
    from repro_torch.launch.train import train
    from repro_torch.optim.optimizers import tree_leaves

    cfg = get_config("internlm2-1.8b")
    base = summary["train_model"]
    init_world("cuda")
    backend = dist.get_backend()
    try:
        mesh = make_host_mesh(1, device="cuda")
        watch = StepWatch(torch, profiled=2)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        watch.start()
        t0 = time.perf_counter()
        with recorded_updates(keep=TP_STEPS - 1) as seen:
            train("internlm2-1.8b", reduced=False, steps=TP_STEPS,
                  batch=TRAIN_B, seq=TRAIN_S, microbatches=TRAIN_MB,
                  log_every=TP_STEPS, device="cuda", mesh=mesh,
                  on_step=watch)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        L = cfg.num_layers
        lse, bwd = 2 * TRAIN_MB * L, TRAIN_MB * L
        want = want_counts({
            "flash_attention.launches_lse": lse,
            "flash_attention.launches_lse_tc": lse,
            "flash_attention.launches_bwd": bwd,
            "flash_attention.launches_bwd_tc": bwd})
        total = watch.check("train_tp", want)
        prof = watch.profiled_fields(lambda key: None)
        steps = watch.step_fields(timed=(1,))
        losses, ref = steps["losses"], base["losses"][:TP_STEPS]
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
        if not max(rel) <= TP_LOSS_REL:
            raise AssertionError(f"train_tp losses {losses}, train_model's "
                                 f"{ref}")
        placed = {type(g).__name__ for g in tree_leaves(seen["grads"])}
        if placed != {"DTensor"}:
            raise AssertionError(f"train_tp gradients are {placed}")
        psum = compressed_psum_check(torch, seen["grads"])
        del seen
        torch.cuda.empty_cache()
        reshard = reshard_check(torch, mesh, "internlm2-1.8b",
                                TWIN_TRAIN_LAYERS)
    finally:
        dist.destroy_process_group()
    log("train_tp", arch=cfg.name, mesh={"shape": [1, 1],
                                          "axes": ["data", "model"]},
        backend=backend, batch=TRAIN_B, seq=TRAIN_S,
        microbatches=TRAIN_MB,
        steps=TP_STEPS, run_s=run_s, **steps,
        roofline=roofline_fields(cfg, TRAIN_B, TRAIN_S, "train",
                                 steps["step_ms"]),
        train_model_step_ms=base["step_ms_by_step"][1],
        step_ms_over_train_model=steps["step_ms"]
        / base["step_ms_by_step"][1],
        train_model_losses=ref, loss_rel=rel,
        losses_bit_equal=losses == ref, peak_memory_gb=peak_gb,
        launches_per_step={k: v for k, v in want.items() if v},
        launches={k: v for k, v in total.items() if v}, **prof,
        compressed_psum=psum, reshard_restore=reshard)
    return ({"flash_attention": total["flash_attention.launches_lse"],
             "flash_attention_bwd": total["flash_attention.launches_bwd"],
             DECODE_LSE: total["decode_attention.launches_lse"]},
            {"flash_attention": {
                "lse_tc": total["flash_attention.launches_lse_tc"],
                "lse_ffma": total["flash_attention.launches_lse_ffma"]},
             "flash_attention_bwd": {
                 "tc": total["flash_attention.launches_bwd_tc"],
                 "ffma": total["flash_attention.launches_bwd_ffma"]}})


def gmm_bwd_kernels(torch, dev, gen, bw, bf16) -> dict:
    """moe_gmm's backward (dx = dy . w^T, dw = x^T . dy) against its plain
    version in bf16: Scout's train shapes (E 16, C 320 rows per expert at a
    1 x 4096 microbatch and capacity factor 1.25; gate/up D 5120 -> F 8192
    and down F -> D), a decode-sized C = 8, and a ragged shape (C, D and F
    no multiples of 64).  bf16 element by element within 2^-7 |ref| + 1e-5
    M (M: the same products over magnitudes; both round an fp32 sum of the
    same exact products), the inputs widened to fp32 within F32_REL of each
    gradient's max, two calls bit-equal, and every shape on the tensor-core
    route (its counter must move through the autograd Function): the
    persistent ``moe_gmm_bwd_tc_kernel``, whose dx and dw tile counts and
    waves on the card's SMs are logged.  Times per call and from a CUDA
    graph, the FFMA variant's on the same inputs (its explicit route), the
    plain version's and, as library yardstick, two ``torch.bmm`` calls (dx
    and dw; each also timed alone).  Bound: x, w and dy read once, dx and
    dw written once; 4 C D F FLOPs an expert.  Returns the train gate/up
    row."""
    from repro_torch.kernels.common import sm_count
    from repro_torch.kernels.moe_gmm import kernel as gmm_kernel
    from repro_torch.kernels.moe_gmm.ops import moe_gmm
    from repro_torch.kernels.moe_gmm.ref import moe_gmm_bwd_ref

    D, Fd, dt = 5120, 8192, torch.bfloat16
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    rows = {}
    for shape, E, C, K, N in (("train gate/up", 16, 320, D, Fd),
                              ("train down", 16, 320, Fd, D),
                              ("decode gate/up", 16, 8, D, Fd),
                              ("ragged", 7, 77, 1000, 296)):
        where = f"moe_gmm backward/{shape}"
        x = randn(E, C, K).to(dt)
        w = randn(E, K, N).mul_(1.0 / math.sqrt(K)).to(dt)
        dy = randn(E, C, N).to(dt)
        variant = gmm_kernel.route_bwd(dt, K, N)
        if variant != "tc":
            raise AssertionError(f"{where}: routed to {variant}")
        xg, wg = (t.detach().requires_grad_(True) for t in (x, w))
        before = moe_gmm.launches_bwd_tc
        got = torch.autograd.grad(moe_gmm(xg, wg), (xg, wg), dy)
        if moe_gmm.launches_bwd_tc != before + 1:
            raise AssertionError(f"{where}: the tc count did not move")
        again = gmm_kernel.launch_bwd(x, w, dy, variant)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{where}: two calls differ")
        del again, xg, wg
        ref = moe_gmm_bwd_ref(x, w, dy)
        mag = moe_gmm_bwd_ref(x.abs().float(), w.abs().float(),
                              dy.abs().float())
        err, ratio = 0.0, 0.0
        for name, g, r, m in zip(("dx", "dw"), got, ref, mag):
            diff = (g.float() - r.float()).abs()
            worst = float((diff / (2.0 ** -7 * r.float().abs()
                                   + 1e-5 * m)).max())
            if not worst <= 1.0:  # NaN fails too
                raise AssertionError(f"{where} {name}: exceeds its bf16 limit "
                                     f"by {worst}x")
            err, ratio = max(err, float(diff.max())), max(ratio, worst)
        del got, ref, mag
        f32 = [t.float() for t in (x, w, dy)]
        rel32 = max(float((g - r).abs().max() / r.abs().max())
                    for g, r in zip(gmm_kernel.launch_bwd(*f32, "ffma"),
                                    moe_gmm_bwd_ref(*f32)))
        if not rel32 <= F32_REL:
            raise AssertionError(f"{where}: fp32 kernel differs from the "
                                 f"plain version by rel {rel32}")
        del f32
        bwd = lambda v_=variant: gmm_kernel.launch_bwd(x, w, dy, v_)
        loops = (3, 3) if C > 8 else ()  # a train call takes ms
        ms, dev_ms = time_ms(torch, bwd, *loops), graph_ms(torch, bwd, *loops)
        ffma_ms = time_ms(torch, lambda: bwd("ffma"), *loops)
        plain = time_ms(torch, lambda: moe_gmm_bwd_ref(x, w, dy), *loops)
        wt, xt = w.transpose(1, 2), x.transpose(1, 2)
        lib_ms = time_ms(torch, lambda: (torch.bmm(dy, wt),
                                         torch.bmm(xt, dy)), *loops)
        lib_dx_ms = time_ms(torch, lambda: torch.bmm(dy, wt), *loops)
        lib_dw_ms = time_ms(torch, lambda: torch.bmm(xt, dy), *loops)
        b_ms, b_by = cost_bound(bw, bf16, gmm_kernel.cost_bwd(E, C, K, N, 2))
        row = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                   bound_by=b_by, library_ms=lib_ms, graph_ms=dev_ms)
        tiles = gmm_kernel.bwd_tc_tiles(E, C, K, N)
        log("kernels", kernel="moe_gmm_bwd", shape=shape, E=E, C=C, D=K, F=N,
            dtype="bf16", variant=variant, tiles_dx_dw=tiles,
            waves_dx_dw=[t / sm_count(dev) for t in tiles],
            bf16_limit_ratio=ratio,
            fp32_rel_err=rel32, ffma_ms=ffma_ms, library_dx_ms=lib_dx_ms,
            library_dw_ms=lib_dw_ms,
            tflops=4 * E * C * K * N / dev_ms / 1e9, bit_equal_repeat=True,
            **row)
        rows[shape] = row
        del x, w, dy
        torch.cuda.empty_cache()
    return rows["train gate/up"]


def scan_bwd_kernels(torch, dev, gen, bw, fp32) -> dict:
    """rglru_scan's backward against its plain reverse loop at
    RecurrentGemma-2B's train microbatch (B 1, S 4096, R 2560; fp32 decays
    and inputs, as the model feeds them), the same in bf16, and a ragged
    shape, with a non-zero h0: da, dx and dh0 bit-equal to the plain
    version through the autograd Function (its counter must move, on the
    route ``kernel.scan_plan`` names, as the C launcher reports it), and
    two calls bit-equal; the plan is logged.  No PyTorch call computes
    it.  Bound: a, dh and h read
    once, da and dx written once (20 bytes an element in fp32), h0 read and
    dh0 written.  Returns the train row."""
    from repro_torch.kernels.common import KERNEL_DTYPES
    from repro_torch.kernels.rglru_scan import kernel as scan_kernel
    from repro_torch.kernels.rglru_scan.ops import rglru_scan_op
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_bwd_ref

    rows = {}
    f32, bf16 = torch.float32, torch.bfloat16
    for shape, B, S, R, dt in (("train", 1, 4096, 2560, f32),
                               ("train bf16", 1, 4096, 2560, bf16),
                               ("ragged", 3, 1001, 1000, f32)):
        where = f"rglru_scan backward/{shape}"
        a = torch.rand((B, S, R), generator=gen, device=dev).mul_(0.299).add_(
            0.7).to(dt)
        x = torch.randn((B, S, R), generator=gen, device=dev).to(dt)
        h0 = torch.randn((B, R), generator=gen, device=dev)
        dh = torch.randn((B, S, R), generator=gen, device=dev)
        leaves = [t.detach().requires_grad_(True) for t in (a, x, h0)]
        route = scan_route(B, S, R, dt, True)
        before = (rglru_scan_op.launches_bwd,
                  getattr(rglru_scan_op, f"launches_bwd_{route}"))
        h = rglru_scan_op(*leaves)
        got = torch.autograd.grad(h, leaves, dh)
        if (rglru_scan_op.launches_bwd,
                getattr(rglru_scan_op, f"launches_bwd_{route}")) != \
                (before[0] + 1, before[1] + 1):
            raise AssertionError(f"{where}: the count did not move on the "
                                 f"{route} route")
        h = h.detach()
        code = KERNEL_DTYPES[dt]
        bwd = lambda: scan_kernel.launch_bwd(a, h0, h, dh, code)
        again = bwd()
        ref = rglru_scan_bwd_ref(a, h0, h, dh)
        torch.cuda.synchronize()
        if not all(torch.equal(g, r) for g, r in zip(got, again)):
            raise AssertionError(f"{where}: two calls differ")
        err = max(float((g.float() - r.float()).abs().max())
                  for g, r in zip(got, ref))
        if not all(torch.equal(g, r) for g, r in zip(got, ref)):
            raise AssertionError(f"{where}: differs from the plain version "
                                 f"by {err}")
        del got, again, ref, leaves
        ms, dev_ms = time_ms(torch, bwd), graph_ms(torch, bwd)
        plain = time_ms(torch, lambda: rglru_scan_bwd_ref(a, h0, h, dh), 2, 1)
        plan = scan_fields(a, True)
        b_ms, b_by = cost_bound(bw, fp32, scan_kernel.cost_bwd(
            B, S, R, a.element_size()))
        row = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                   bound_by=b_by, library_ms=None, graph_ms=dev_ms)
        log("kernels", kernel="rglru_scan_bwd", shape=shape, B=B, S=S, R=R,
            dtype=str(dt).removeprefix("torch."), bit_equal_plain=True,
            bit_equal_repeat=True, **plan, **row)
        rows[shape] = row
        del a, x, h0, dh, h
        torch.cuda.empty_cache()
    return rows["train"]


def gmm_role(key: str):
    """A moe_gmm tensor-core kernel's part of a train step: the forward
    (``moe_gmm_tc_kernel``), or the backward's dx (the persistent kernel with
    A K-major, tnspA 0: dx^T = w . dy^T) or dw (tnspA 1)."""
    if "moe_gmm_tc_kernel<" in key:
        return "moe_gmm forward"
    m = re.search(r"moe_gmm_bwd_tc_kernel<(?:\d+,\s*){2}(\d),", key)
    return ("moe_gmm dw" if m.group(1) == "1" else "moe_gmm dx") if m else None


def train_moe_phase(torch, dev, gen, bw, bf16, summary) -> tuple:
    """Llama-4-Scout (16 experts top-1 + a shared expert, chunked attention
    8192) trained at its published widths cut to SCOUT_TRAIN_LAYERS of 48
    layers, bf16, seeded random weights, through
    ``launch.steps.build_train_step`` -> ``lm.train_loss`` with the uncut
    model's optimizer and accumulation depth (``default_optimizer`` and
    ``default_microbatches`` of the published config: Adafactor on its
    107.8 B parameters, 4 microbatches; ``launch.train.train`` would pick
    AdamW and 1 from the cut config).  B 4 x S 4096 (1 x 4096 a microbatch
    at capacity factor 1.25: C = 320 rows per expert), MOE_HYBRID_STEPS
    steps on the token pipeline's batches, the last one profiled.  The
    counters are set to 0 just before the run and read after each step: per
    step 3 L M x 2 (remat) moe_gmm forwards and 3 L M backward calls, L M x
    2 lse-twin flash forwards and L M flash backwards, all on the
    tensor-core variants, and no other launch.  Every loss and grad norm
    finite.  Before it: the backward kernel's rows (``gmm_bwd_kernels``),
    the fp32 twin (MOE_TWIN_LAYERS layer against the plain moe_gmm and
    attention), and two loss-and-grad passes over one microbatch, which
    must be bit-equal."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.steps import (build_train_step,
                                          default_microbatches,
                                          default_optimizer)
    from repro_torch.models.config import ShapeSpec

    summary["moe_gmm_bwd"] = gmm_bwd_kernels(torch, dev, gen, bw, bf16)
    published = get_config("llama4-scout-17b-a16e")
    n = MOE_TWIN_LAYERS
    twin = fp32_twin(
        torch, dev, published.with_overrides(num_layers=n, dtype="float32"),
        12, {"moe_gmm.launches": 3 * n * 2, "moe_gmm.launches_ffma": 3 * n * 2,
             "moe_gmm.launches_bwd": 3 * n,
             "moe_gmm.launches_bwd_ffma": 3 * n,
             "flash_attention.launches_lse": 2 * n,
             "flash_attention.launches_lse_ffma": 2 * n,
             "flash_attention.launches_bwd": n,
             "flash_attention.launches_bwd_ffma": n},
        lambda: together(plain_moe_gmm(), plain_attention()))

    cfg = published.with_overrides(num_layers=SCOUT_TRAIN_LAYERS)
    L = cfg.num_layers
    shape = ShapeSpec("custom", SCOUT_TRAIN_S, SCOUT_TRAIN_B, "train")
    M = default_microbatches(published, shape)
    opt = default_optimizer(published)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, _, init_s = init_model(torch, dev, cfg, 1, 1, seed=4)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=SCOUT_TRAIN_S,
                         global_batch=SCOUT_TRAIN_B)
    batches = [{k: torch.from_numpy(v).long().to(dev)
                for k, v in pipe.batch_at(i).items()}
               for i in range(MOE_HYBRID_STEPS)]
    pipe.close()

    # two loss-and-grad passes over the first microbatch: bit-equal
    mb = {k: v[:SCOUT_TRAIN_B // M] for k, v in batches[0].items()}
    first = loss_and_grads(torch, cfg, params, mb)
    second = loss_and_grads(torch, cfg, params, mb)
    differ = [i for i, (a, b) in enumerate(zip(first[1], second[1]))
              if not torch.equal(a, b)]
    if first[0] != second[0] or differ:
        raise AssertionError(f"train_moe: two loss-and-grad passes differ "
                             f"(losses {first[0]}, {second[0]}; grad leaves "
                             f"{differ})")
    del first, second
    torch.cuda.empty_cache()

    step_fn = build_train_step(cfg, optimizer=opt, microbatches=M)
    opt_state = opt.init(params)
    watch = StepWatch(torch, profiled=MOE_HYBRID_STEPS - 1)
    torch.cuda.synchronize()
    watch.start()
    t0 = time.perf_counter()
    for i, batch in enumerate(batches):
        ts = time.perf_counter()
        params, opt_state, _, metrics = step_fn(params, opt_state, i, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        watch(i, dict(metrics, step_s=time.perf_counter() - ts))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fwd, bwd = 3 * L * M * 2, 3 * L * M
    want = want_counts({
        "moe_gmm.launches": fwd, "moe_gmm.launches_tc": fwd,
        "moe_gmm.launches_bwd": bwd, "moe_gmm.launches_bwd_tc": bwd,
        "flash_attention.launches_lse": 2 * L * M,
        "flash_attention.launches_lse_tc": 2 * L * M,
        "flash_attention.launches_bwd": L * M,
        "flash_attention.launches_bwd_tc": L * M})
    total = watch.check("train_moe", want)
    prof = watch.profiled_fields(
        lambda key: gmm_role(key) or next(
            (k for k in BWD_KERNELS if k in key), None))
    steps = watch.step_fields(timed=(1,))
    del params, opt_state, batches
    torch.cuda.empty_cache()

    tokens = SCOUT_TRAIN_B * SCOUT_TRAIN_S
    log("train_moe", arch=cfg.name, dtype=cfg.dtype, layers=L,
        layers_published=published.num_layers, d_model=cfg.d_model,
        experts=cfg.num_experts, top_k=cfg.experts_per_token,
        moe_d_ff=cfg.moe_d_ff, capacity_factor=cfg.capacity_factor,
        params=cfg.param_count(), params_published=published.param_count(),
        batch=SCOUT_TRAIN_B, seq=SCOUT_TRAIN_S, microbatches=M,
        steps=MOE_HYBRID_STEPS, optimizer=(
            f"{opt.name} (the published config's), warmup_cosine(3e-4, 2000, "
            "100000)"), init_s=init_s, run_s=run_s, **steps,
        roofline=roofline_fields(cfg, SCOUT_TRAIN_B, SCOUT_TRAIN_S, "train",
                                 steps["step_ms"]),
        tokens_per_s=tokens / (steps["step_ms"] / 1e3),
        peak_memory_gb=peak_gb,
        launches_per_step={k: v for k, v in want.items() if v},
        launches={k: v for k, v in total.items() if v}, **prof,
        bit_equal_loss_and_grads=True, fp32_twin=twin)
    return ({"moe_gmm": total["moe_gmm.launches"],
             "moe_gmm_bwd": total["moe_gmm.launches_bwd"],
             "flash_attention": total["flash_attention.launches_lse"],
             "flash_attention_bwd": total["flash_attention.launches_bwd"],
             DECODE_LSE: total["decode_attention.launches_lse"]},
            {"moe_gmm": {"tc": total["moe_gmm.launches_tc"],
                         "ffma": total["moe_gmm.launches_ffma"]},
             "moe_gmm_bwd": {"tc": total["moe_gmm.launches_bwd_tc"],
                             "ffma": total["moe_gmm.launches_bwd_ffma"]},
             "flash_attention": {
                 "lse_tc": total["flash_attention.launches_lse_tc"],
                 "lse_ffma": total["flash_attention.launches_lse_ffma"]},
             "flash_attention_bwd": {
                 "tc": total["flash_attention.launches_bwd_tc"],
                 "ffma": total["flash_attention.launches_bwd_ffma"]}})


def train_hybrid_phase(torch, dev, gen, bw, fp32, summary) -> tuple:
    """RecurrentGemma-2B ((RG-LRU, RG-LRU, local attention) x 8 + 2 RG-LRU;
    MQA, hd 256, window 2048) trained uncut in bf16 through
    ``launch.train.train``: B 2 x S 4096 (past the window) in 2
    microbatches, MOE_HYBRID_STEPS AdamW steps, the last one profiled.  The
    counters are set to 0 just before the run and read after each step: per
    step (16 x 2 + 2) M rglru_scan forwards (the 2 trailing blocks sit
    outside the remat units) and 18 M backwards, 8 M x 2 lse-twin flash
    forwards and 8 M flash backwards, all on the tensor cores (the backward
    at hd 256 on the wide pair; none on FFMA), and no other launch.  Every
    loss and grad norm finite; the profiled step's flash backward time,
    split by kernel, and its share of the step.  Beside it: the scan
    backward kernel's rows (``scan_bwd_kernels``), the
    fp32 twin (HYBRID_TWIN_LAYERS layers against the plain scan and
    attention) and restart (``restart_check``, HYBRID_TWIN_LAYERS
    layers)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train

    summary["rglru_scan_bwd"] = scan_bwd_kernels(torch, dev, gen, bw, fp32)
    cfg = get_config("recurrentgemma-2b")
    twin_cfg = cfg.with_overrides(num_layers=HYBRID_TWIN_LAYERS,
                                  dtype="float32")
    r, a = (twin_cfg.layer_types.count(t) for t in ("rglru", "attn"))
    R = cfg.rnn_state_dim
    # the block feeds the scan fp32 decays and inputs (models/blocks.py)
    fwd, bwd = (scan_route(1, 1024, R, torch.float32, b) for b in (0, 1))
    twin = fp32_twin(
        torch, dev, twin_cfg, 13,
        {"rglru_scan_op.launches": 2 * r, f"rglru_scan_op.launches_{fwd}":
         2 * r, "rglru_scan_op.launches_bwd": r,
         f"rglru_scan_op.launches_bwd_{bwd}": r,
         "flash_attention.launches_lse": 2 * a,
         "flash_attention.launches_lse_ffma": 2 * a,
         "flash_attention.launches_bwd": a,
         "flash_attention.launches_bwd_ffma": a},
        lambda: together(plain_scan(), plain_attention()))

    n_rec, n_attn = (cfg.layer_types.count(t) for t in ("rglru", "attn"))
    # the 8 whole (rglru, rglru, attn) units run under remat (their forward
    # twice a microbatch); the 2 trailing rglru blocks outside them, once
    pat = cfg.block_pattern
    unit_rec = cfg.num_layers // len(pat) * pat.count("rglru")
    M = HYBRID_TRAIN_MB
    mb = HYBRID_TRAIN_B // M
    fwd, bwd = (scan_route(mb, HYBRID_TRAIN_S, R, torch.float32, b)
                for b in (0, 1))
    watch = StepWatch(torch, profiled=MOE_HYBRID_STEPS - 1)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    watch.start()
    t0 = time.perf_counter()
    train("recurrentgemma-2b", reduced=False, steps=MOE_HYBRID_STEPS,
          batch=HYBRID_TRAIN_B, seq=HYBRID_TRAIN_S, microbatches=M,
          log_every=MOE_HYBRID_STEPS, device="cuda", on_step=watch)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_fwd = (2 * unit_rec + n_rec - unit_rec) * M
    want = want_counts({
        "rglru_scan_op.launches": n_fwd,
        f"rglru_scan_op.launches_{fwd}": n_fwd,
        "rglru_scan_op.launches_bwd": n_rec * M,
        f"rglru_scan_op.launches_bwd_{bwd}": n_rec * M,
        "flash_attention.launches_lse": 2 * n_attn * M,
        "flash_attention.launches_lse_tc": 2 * n_attn * M,
        "flash_attention.launches_bwd": n_attn * M,
        "flash_attention.launches_bwd_tc": n_attn * M})
    total = watch.check("train_hybrid", want)
    prof = watch.profiled_fields(
        lambda key: next((k for k in BWD_WIDE_KERNELS + (
            "rglru_scan_bwd_kernel", "rglru_scan_kernel") if k in key), None))
    flash_bwd_ms = sum(prof["profiled_ms_calls"].get(k, [0.0])[0]
                       for k in BWD_WIDE_KERNELS)
    steps = watch.step_fields(timed=(1,))
    torch.cuda.empty_cache()
    restart = restart_check(torch, "recurrentgemma-2b", HYBRID_TWIN_LAYERS)

    tokens = HYBRID_TRAIN_B * HYBRID_TRAIN_S
    log("train_hybrid", arch=cfg.name, dtype=cfg.dtype, layers=cfg.num_layers,
        rglru_layers=n_rec, attention_layers=n_attn, d_model=cfg.d_model,
        head_dim=cfg.head_dim, window=cfg.window_size,
        rnn_state_dim=cfg.rnn_state_dim, params=cfg.param_count(),
        batch=HYBRID_TRAIN_B, seq=HYBRID_TRAIN_S, microbatches=M,
        steps=MOE_HYBRID_STEPS,
        optimizer="adamw, warmup_cosine(3e-4, 2000, 100000)",
        run_s=run_s, **steps, tokens_per_s=tokens / (steps["step_ms"] / 1e3),
        roofline=roofline_fields(cfg, HYBRID_TRAIN_B, HYBRID_TRAIN_S, "train",
                                 steps["step_ms"]),
        peak_memory_gb=peak_gb,
        launches_per_step={k: v for k, v in want.items() if v},
        launches={k: v for k, v in total.items() if v}, **prof,
        flash_backward_ms=flash_bwd_ms,
        flash_backward_share_of_busy=(
            flash_bwd_ms / prof["profiled_device_busy_ms"]
            if prof["profiled_device_busy_ms"] else None),
        flash_backward_share_of_step=(
            flash_bwd_ms / prof["profiled_step_ms"]),
        fp32_twin=twin, restart=restart)
    return ({"rglru_scan": total["rglru_scan_op.launches"],
             "rglru_scan_bwd": total["rglru_scan_op.launches_bwd"],
             "flash_attention": total["flash_attention.launches_lse"],
             "flash_attention_bwd_wide": total["flash_attention.launches_bwd"],
             DECODE_LSE: total["decode_attention.launches_lse"]},
            {"rglru_scan": {r: total[f"rglru_scan_op.launches_{r}"]
                            for r in SCAN_ROUTES},
             "rglru_scan_bwd": {r: total[f"rglru_scan_op.launches_bwd_{r}"]
                                for r in SCAN_ROUTES},
             "flash_attention": {
                "lse_tc": total["flash_attention.launches_lse_tc"],
                "lse_ffma": total["flash_attention.launches_lse_ffma"]},
             "flash_attention_bwd_wide": {
                 "tc": total["flash_attention.launches_bwd_tc"],
                 "ffma": total["flash_attention.launches_bwd_ffma"]}})


def decode_device_time(torch, decode_step, params, token, cache, first_len,
                       steps=5, extra=()):
    """Profile ``steps`` decode steps (writing cache slots from
    ``first_len - 1`` on again; a recurrent state steps on): (device busy
    ms per step, or None when the profiler records no device time; wall ms
    per step; the five kernels with the most device time, as [name, ms per
    step, calls per step]); busy time is the sum of the device kernels'
    times.  ``extra``: the step's arguments after
    ``cache_len`` (an encoder-decoder's encoder output)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cache_len = torch.tensor(first_len, dtype=torch.int32, device=token.device)
    decode_step(params, token, cache, cache_len, *extra)  # warm the profiler
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            decode_step(params, token, cache, cache_len, *extra)
            cache_len += 1
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    # device kernels only: the aten op that launched a kernel reports the
    # same time again as its own device time
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    events.sort(key=lambda e: -e.self_device_time_total)
    top = [[e.key[:100], e.self_device_time_total / 1e3 / steps,
            e.count / steps] for e in events[:5]]
    return (busy_us / 1e3 / steps if busy_us > 0 else None), wall_ms, top


def split_phase(torch) -> None:
    """The split draft's confidence readout through the decode_attention
    kernel against its numpy mirror."""
    from repro_torch.core.paths import MODEL_CATALOG
    from repro_torch.core.splitgen import DraftState
    from repro_torch.kernels.decode_attention.ops import decode_attention

    draft = DraftState(seed=0, qid=7, edge=MODEL_CATALOG["internlm2-1.8b"],
                       n_chunks=5)
    before = decode_attention.launches
    err = 0.0
    for t in range(5):
        draft.append(t)
        err = max(err, float(abs(draft.attend(use_kernel=True, device="cuda")
                                 - draft.attend()).max()))
    if not err <= 1e-6:
        raise AssertionError(f"split draft: kernel readout differs by {err}")
    log("split", steps=5, head_dim=draft.hd, max_abs_err=err,
        decode_attention_launches=decode_attention.launches - before)


# the dry run's cells on the single-pod mesh: decode on a cache sharded along
# its slots (InternLM2's 8 KV heads and RecurrentGemma-2B's one over 16
# model ranks) and a train step
DRYRUN_CELLS = (("internlm2-1.8b", "decode_32k"),
                ("recurrentgemma-2b", "decode_32k"),
                ("internlm2-1.8b", "train_4k"))
DRYRUN_TIMEOUT_S = 600


def dryrun_phase() -> None:
    """``python -m repro_torch.launch.dryrun --mesh single`` on each of
    ``DRYRUN_CELLS``, each in a process of its own (a fake world of 256
    ranks needs the default process group, which ``train_tp``'s ``nccl``
    world took in this one), all at once, on the host's CPU: every cell
    must report ``ok``; its ``trace_s``, rank-0 bytes, per-device FLOPs and
    bytes, the kernels' shape-route counts and the collectives by kind are
    logged.  These are host counts of a traced step, not card
    measurements."""
    import os
    import shutil

    out_dir = ROOT / "build" / "chip_smoke_dryrun"
    out_dir.mkdir(parents=True, exist_ok=True)
    env = {**os.environ, "PYTHONPATH": str(SRC), "CUDA_VISIBLE_DEVICES": ""}
    procs = []
    for arch, shape in DRYRUN_CELLS:
        report = out_dir / f"{arch}_{shape}.json"
        procs.append((arch, shape, report, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh",
             "single", "--arch", arch, "--shape", shape, "--report",
             str(report)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env, cwd=ROOT)))
    try:
        for arch, shape, report, proc in procs:
            out, _ = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
            if proc.returncode != 0:
                raise AssertionError(f"dryrun {arch} x {shape}: exit "
                                     f"{proc.returncode}: {out[-3000:]}")
            rec = json.loads(report.read_text())[0]
            if rec["status"] != "ok":
                raise AssertionError(f"dryrun {arch} x {shape}: {rec}")
            log("dryrun", arch=arch, shape=shape, mesh=rec["mesh"],
                step=rec["step"], trace_s=rec["trace_s"],
                memory=rec["memory"], cost=rec["cost"],
                kernels=rec["kernels"], collectives=rec["collectives"],
                counts="host counts of a fake 256-rank world")
    finally:
        for *_, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(out_dir, ignore_errors=True)


SHED_REASONS = {"quota", "queue_full", "deadline", "shutdown", "stale_loop"}
SLOWDOWN = 4.0  # edge tflops and bandwidth divisor of the drift scenario
ADAPT_SLO_S = 4.0  # cloud paths clear it; throttled edge stages blow it
SWAPS_UNDER_LOAD = 24


@contextlib.contextmanager
def counting(cls, name: str):
    """Count the calls of ``cls.name`` (all threads) while the block runs:
    the passes a selection engine makes, counted apart from the kernel
    wrapper's own launch counter."""
    import threading

    orig = getattr(cls, name)
    lock = threading.Lock()
    calls = [0]

    def wrapper(*args, **kwargs):
        with lock:
            calls[0] += 1
        return orig(*args, **kwargs)

    setattr(cls, name, wrapper)
    try:
        yield calls
    finally:
        setattr(cls, name, orig)


def zero_selection_counts() -> None:
    from repro_torch.kernels.dsqe_score.ops import dsqe_score
    from repro_torch.kernels.retrieval_topk.ops import retrieval_topk

    for op in (retrieval_topk, dsqe_score):
        op.launches = op.launches_tiled = op.launches_select = 0


def selection_counts() -> dict:
    from repro_torch.kernels.dsqe_score.ops import dsqe_score
    from repro_torch.kernels.retrieval_topk.ops import retrieval_topk

    return {op.__name__: {"launches": op.launches,
                          "tiled": op.launches_tiled,
                          "select": op.launches_select}
            for op in (retrieval_topk, dsqe_score)}


def check_kernel_passes(what: str, counts: dict, passes: int) -> None:
    """One tiled retrieval_topk launch per kernel-backed selection pass,
    no dsqe_score on the served path."""
    want = {"retrieval_topk": {"launches": passes, "tiled": passes,
                               "select": 0},
            "dsqe_score": {"launches": 0, "tiled": 0, "select": 0}}
    if passes < 1 or counts != want:
        raise AssertionError(f"{what}: selection launches {counts} over "
                             f"{passes} kernel-backed passes, want {want}")


def numpy_twin(sel):
    """The same selector on the numpy engine (the decision reference)."""
    from repro_torch.core.rps import RuntimePathSelector

    return RuntimePathSelector(sel.space, sel.dsqe, sel.cca, sel.table,
                               sel._train_embeddings, lam=sel.lam,
                               knn=sel.knn, use_kernel=False)


def mismatches(responses, decisions) -> int:
    if len(responses) != len(decisions):
        raise AssertionError(f"{len(responses)} responses for "
                             f"{len(decisions)} requests")
    return sum((r.path_key, r.meta["set_id"], r.meta["fallback"])
               != (d.path.key, d.set_id, d.used_fallback)
               for r, d in zip(responses, decisions))


def check_accounting(stats: dict, offered: int) -> dict:
    """The router's identities, per tenant and summed, and a typed reason
    for every shed request."""
    tenants = stats["tenants"]
    for name, t in tenants.items():
        if t["offered"] != t["admitted"] + t["shed"] or \
                t["admitted"] != t["served"] + t["failed"]:
            raise AssertionError(f"tenant {name}: accounting broken: {t}")
        if sum(t["shed_reasons"].values()) != t["shed"] or \
                not set(t["shed_reasons"]) <= SHED_REASONS:
            raise AssertionError(f"tenant {name}: untyped shed: {t}")
    total = {k: sum(t[k] for t in tenants.values())
             for k in ("offered", "admitted", "shed", "served", "failed")}
    if total["offered"] != offered:
        raise AssertionError(f"offered {total['offered']} of {offered}")
    return total


def tenants_phase(torch, single_server, single_test) -> int:
    """Multi-tenant serving through the router: four Zipf(1.1) tenants of
    the three SLO classes on two admission shards over a two-domain server
    (every bucket through the domain-sharded pass: no selection kernel),
    then a single-domain router over the served automotive selector (one
    tiled retrieval_topk per bucket).  Returns the kernel's launches."""
    import asyncio

    import numpy as np

    from repro_torch.core.rps import DomainShardedSelector, RuntimePathSelector
    from repro_torch.launch.serve import (build_multi_server,
                                          drive_router_async, zipf_shares)
    from repro_torch.runtime.router import TenantSpec
    from repro_torch.runtime.server import Request

    t_phase = time.perf_counter()
    domains = ["automotive", "smarthome"]
    server, tests = build_multi_server(domains, n_queries=120, budget=5.0,
                                       device="cuda", use_kernel=True)
    build_s = time.perf_counter() - t_phase
    classes = ("deadline", "standard", "batch", "standard")
    tenants = [TenantSpec(f"tenant{i:02d}", slo_class=c)
               for i, c in enumerate(classes)]
    shares = zipf_shares(len(tenants), 1.1)

    def requests(names):
        rng = np.random.default_rng(0)
        return [Request(prompt="", qid=int(q), domain=name,
                        tenant=tenants[int(rng.choice(len(tenants),
                                                      p=shares))].name)
                for name in names for q in tests[name]]

    def served_parity(srv, reqs, responses):
        """Per domain: served decisions against that domain's numpy twin
        on the SLOs the router stamped (the class defaults)."""
        out = {}
        for name in dict.fromkeys(r.domain for r in reqs):
            rows = [i for i, r in enumerate(reqs) if r.domain == name]
            dom, sel, _ = srv.domain_entry(name)
            want = numpy_twin(sel).select_batch(
                dom.query_embeddings[[reqs[i].qid for i in rows]],
                [reqs[i].slo for i in rows])
            bad = mismatches([responses[i] for i in rows], want)
            if bad:
                raise AssertionError(f"tenants/{name}: {bad} of {len(rows)} "
                                     "rows decide unlike the numpy engine")
            out[name] = 1.0 - bad / len(rows)
        return out

    def drive(srv, reqs):
        return asyncio.run(drive_router_async(
            srv, reqs, tenants, n_shards=2, max_batch=32,
            max_queue=max(256, len(reqs))))

    # the two-domain server: mixed buckets through the sharded pass
    reqs = requests(domains)
    zero_selection_counts()
    with counting(DomainShardedSelector, "select_batch") as sharded, \
            counting(RuntimePathSelector, "_score_batch_kernel") as fused:
        t0 = time.perf_counter()
        responses, shed, stats = drive(server, reqs)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
    counts = selection_counts()
    total = check_accounting(stats, len(reqs))
    if sharded[0] < 1 or fused[0] or \
            counts["retrieval_topk"]["launches"] or \
            counts["dsqe_score"]["launches"]:
        raise AssertionError(f"tenants: {sharded[0]} sharded and {fused[0]} "
                             f"kernel-backed passes launched {counts}; "
                             "sharded passes launch no selection kernel")
    if shed:  # decisions are matched to requests by order
        reasons = {n: t["shed_reasons"] for n, t in stats["tenants"].items()}
        raise AssertionError(f"tenants: {shed} requests shed ({reasons})")
    parity = served_parity(server, reqs, responses)
    server.fleet.close()

    # the single-domain router: one tiled retrieval_topk per bucket
    sreqs = [Request(prompt="", qid=int(q),
                     tenant=tenants[i % len(tenants)].name)
             for i, q in enumerate(single_test)]
    zero_selection_counts()
    with counting(RuntimePathSelector, "_score_batch_kernel") as fused:
        s_responses, s_shed, s_stats = drive(single_server, sreqs)
        torch.cuda.synchronize()
    s_counts = selection_counts()
    check_accounting(s_stats, len(sreqs))
    buckets = sum(s["batches"] for s in s_stats["shards"])
    if fused[0] != buckets:
        raise AssertionError(f"tenants/single: {fused[0]} passes for "
                             f"{buckets} buckets")
    check_kernel_passes("tenants/single", s_counts, fused[0])
    if s_shed:
        raise AssertionError(f"tenants/single: {s_shed} requests shed")
    s_parity = served_parity(single_server, sreqs, s_responses)
    log("tenants", domains=domains, tenants={
            t.name: {"class": t.slo_class, "share": float(s),
                     "shard": stats["tenants"].get(t.name, {}).get("shard"),
                     "offered": stats["tenants"].get(t.name, {}).get(
                         "offered", 0)}
            for t, s in zip(tenants, shares)},
        requests=len(reqs), totals=total, shed=shed,
        shards=stats["shards"], sharded_passes=sharded[0],
        selection_launches=counts, decision_parity=parity,
        single_domain={"requests": len(sreqs), "buckets": buckets,
                       "kernel_passes": fused[0],
                       "selection_launches": s_counts,
                       "decision_parity": s_parity[None]},
        build_multi_server_s=build_s, router_serve_s=serve_s,
        phase_s=time.perf_counter() - t_phase)
    return s_counts["retrieval_topk"]["tiled"]


def adaptation_phase(torch) -> int:
    """Drift and online adaptation on the card: serve a wave, throttle the
    edge device (tflops and bandwidth / SLOWDOWN), serve and pump until the
    plane swaps a re-explored table in; then the swapped selector against a
    numpy twin built on the new table, and 24 swaps under two reader
    threads.  Returns retrieval_topk's launches."""
    import asyncio
    import dataclasses
    import threading

    import numpy as np

    from repro_torch.core.emulator import EvalTable
    from repro_torch.core.rps import RuntimePathSelector
    from repro_torch.core.slo import SLO
    from repro_torch.launch.serve import build_server
    from repro_torch.runtime.server import Request

    t_phase = time.perf_counter()
    server, test = build_server("smarthome", n_queries=120, use_kernel=True,
                                device="cuda")
    build_s = time.perf_counter() - t_phase
    sel = server.rps
    plane = server.enable_adaptation(
        start=False, decay=0.15, drift_decay=0.1, viol_threshold=0.3,
        min_obs=6.0, trip_folds=2, cooldown_folds=3, max_sweep_queries=24,
        blend_prior=4.0)
    slo = SLO(max_latency_s=ADAPT_SLO_S)

    async def wave():
        orch = server.orchestrator(max_batch=32, max_wait_ms=2.0,
                                   max_queue=4096)
        await orch.start()
        tickets = [await orch.submit(Request(prompt="", qid=int(q), slo=slo))
                   for q in test]
        out = await asyncio.gather(*(t.wait() for t in tickets))
        await orch.stop()
        return out

    zero_selection_counts()
    batches0 = server.system_state()["dispatch_batches"]
    waves, fallbacks, swap = [], [], None
    with counting(RuntimePathSelector, "_score_batch_kernel") as fused:
        for i in range(12):
            if i == 1:  # the drift: the edge device throttles
                dev = server.executor.device
                server.executor.device = dataclasses.replace(
                    dev, tflops=dev.tflops / SLOWDOWN,
                    mem_gbps=dev.mem_gbps / SLOWDOWN)
            responses = asyncio.run(wave())
            torch.cuda.synchronize()
            pumped = plane.pump()
            waves.append(sum(r.slo_ok for r in responses) / len(responses))
            fallbacks.append(sum(r.meta["fallback"] for r in responses)
                             / len(responses))
            if pumped["swaps"]:
                swap = pumped["swaps"][0]
                break
        if swap is None:
            raise AssertionError(f"adaptation: no swap in {len(waves)} "
                                 f"waves (SLO rates {waves})")
        # the numpy twin of the new version: the same table, the same
        # online blend (no fold since the swap), the same v0 labels before
        twin = numpy_twin(sel)
        twin.swap_table(sel.table,
                        online=plane._online_for_domain(swap["domain"], sel))
        if sel.table_version != 1 or twin.table_version != 1:
            raise AssertionError(f"adaptation: version {sel.table_version}")
        set_ids = np.asarray(sel.cca.set_ids)
        rows = [i for i, s in enumerate(set_ids)
                if int(s) in swap["stale_sets"]][:swap["queries_swept"]]
        if not rows or not sel.table.evaluated[rows].all():
            raise AssertionError("adaptation: swept rows not evaluated")
        slos = [SLO(**a) for a in (
            {}, {"max_latency_s": 2.0, "max_cost_usd": 0.004},
            {"max_latency_s": ADAPT_SLO_S}, {"max_latency_s": 1e-6})]
        embs = server.domain.query_embeddings[test]
        mixed = [slos[i % 4] for i in range(len(test))]

        def key(d):
            return (d.path.key, d.set_id, d.used_fallback,
                    d.expected_latency_s, d.table_version)

        got = [key(d) for d in sel.select_batch(embs, mixed)]
        bad = sum(g != key(w) for g, w in
                  zip(got, twin.select_batch(embs, mixed)))
        post = asyncio.run(wave())
        torch.cuda.synchronize()
        bad_served = mismatches(post, twin.select_batch(embs, [slo] * len(test)))
        if bad or bad_served:
            raise AssertionError(f"adaptation: {bad} selected and "
                                 f"{bad_served} served rows after the swap "
                                 "decide unlike the numpy twin")
        served_passes = server.system_state()["dispatch_batches"] - batches0

        # swap under load: the kernel pass against 24 swaps
        embs8 = embs[:8]
        slos8 = [SLO(max_latency_s=1e9)] * 8
        sel.select_batch(embs8, slos8)
        traces0 = sel.kernel_trace_count
        base, v_base = sel.table, sel.table_version
        # per-path expected latency of each version: the serving version's
        # own (blended with the online statistics at its swap), then the
        # table's column means scaled by 1.03 per swap
        factor = {v_base + k: 1.0 + 0.03 * k
                  for k in range(1, SWAPS_UNDER_LOAD + 1)}
        with np.errstate(invalid="ignore"):
            base_lat = np.nanmean(base.latency, axis=0)
        path_lat = {v: base_lat * f for v, f in factor.items()}
        path_lat[v_base] = sel.path_latency
        stop, decisions, errors = threading.Event(), [], []

        def reader():
            try:
                while not stop.is_set():
                    decisions.extend(sel.select_batch(embs8, slos8))
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)

        readers = [threading.Thread(target=reader) for _ in range(2)]
        t0 = time.perf_counter()
        for t in readers:
            t.start()
        try:
            for k in range(1, SWAPS_UNDER_LOAD + 1):
                scaled = EvalTable(
                    query_ids=list(base.query_ids), paths=list(base.paths),
                    accuracy=base.accuracy,
                    latency=base.latency * factor[v_base + k],
                    cost=base.cost, evaluated=base.evaluated)
                if sel.swap_table(scaled) != v_base + k:
                    raise AssertionError("adaptation: swap version skipped")
        finally:
            stop.set()
            for t in readers:
                t.join(timeout=120)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        if errors or any(t.is_alive() for t in readers):
            raise AssertionError(f"adaptation: readers failed: {errors}")
        pkey = {p.key: j for j, p in enumerate(base.paths)}
        versions = sorted({d.table_version for d in decisions})
        if not set(versions) <= set(path_lat):
            raise AssertionError(f"adaptation: versions {versions}")
        torn = sum(bool(abs(d.expected_latency_s
                            - path_lat[d.table_version][pkey[d.path.key]])
                        >= 1e-9 * max(1.0, d.expected_latency_s))
                   for d in decisions)
        if torn or not decisions or \
                sel.kernel_trace_count != traces0:
            raise AssertionError(
                f"adaptation: {torn} of {len(decisions)} decisions off their "
                f"version, versions {versions}, buckets "
                f"{traces0} -> {sel.kernel_trace_count}")
    counts = selection_counts()
    check_kernel_passes("adaptation", counts, fused[0])
    a = plane.state()
    log("adaptation", domain="smarthome", slowdown=SLOWDOWN,
        slo_latency_s=ADAPT_SLO_S, wave_slo_rates=waves,
        wave_fallback_rates=fallbacks, swap=swap,
        table_version_after_swap=1, twin_parity=1.0 - bad / len(test),
        served_parity_after_swap=1.0 - bad_served / len(test),
        post_swap_slo_rate=sum(r.slo_ok for r in post) / len(post),
        post_swap_fallback_rate=sum(r.meta["fallback"] for r in post)
        / len(post),
        served_passes=served_passes, swaps_under_load=SWAPS_UNDER_LOAD,
        reader_decisions=len(decisions), versions_seen=len(versions),
        torn_decisions=torn, kernel_trace_count=sel.kernel_trace_count,
        swap_under_load_s=load_s, kernel_passes=fused[0],
        selection_launches=counts,
        monitors={k: v["domains"] for k, v in a["shards"].items()},
        build_server_s=build_s, phase_s=time.perf_counter() - t_phase)
    server.fleet.close()
    return counts["retrieval_topk"]["tiled"]


def placements_phase(torch) -> int:
    """The placement-extended path space served in one ``handle_batch``
    (``serve --placements --use-kernel --batch``) against its numpy twin.
    Returns retrieval_topk's launches."""
    from repro_torch.core.paths import (DEFAULT_PLACEMENT_CHAINS,
                                        DEFAULT_PLACEMENT_MODELS, PLACED_IMPL)
    from repro_torch.core.rps import RuntimePathSelector
    from repro_torch.core.slo import SLO
    from repro_torch.launch.serve import build_server
    from repro_torch.runtime.placement import get_plan
    from repro_torch.runtime.server import Request

    t_phase = time.perf_counter()
    server, test = build_server("automotive", n_queries=120, budget=5.0,
                                use_kernel=True, placements=True,
                                device="cuda")
    build_s = time.perf_counter() - t_phase
    sel = server.rps
    slos = [SLO(**a) for a in (
        {}, {"max_latency_s": 2.0, "max_cost_usd": 0.004},
        {"max_latency_s": 1e-6, "max_cost_usd": 0.0},
        {"max_latency_s": 4.0, "max_cost_usd": 0.008})]
    mixed = [slos[i % 4] for i in range(len(test))]
    reqs = [Request(prompt="", qid=int(q), slo=s) for q, s in zip(test, mixed)]
    zero_selection_counts()
    with counting(RuntimePathSelector, "_score_batch_kernel") as fused:
        t0 = time.perf_counter()
        responses = server.handle_batch(reqs)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
    counts = selection_counts()
    check_kernel_passes("placements", counts, fused[0])
    bad = mismatches(responses, numpy_twin(sel).select_batch(
        server.domain.query_embeddings[test], mixed))
    if bad:
        raise AssertionError(f"placements: {bad} rows decide unlike the "
                             "numpy engine")
    placed = [p for p in sel.table.paths if p.model.impl == PLACED_IMPL]
    log("placements", domain="automotive", P=len(sel.table.paths),
        placed_paths=len(placed),
        placed_served=sum(r.path_key in {p.key for p in placed}
                          for r in responses),
        plans=[get_plan(m, c).describe() for m in DEFAULT_PLACEMENT_MODELS
               for c in DEFAULT_PLACEMENT_CHAINS],
        requests=len(reqs), decision_parity=1.0 - bad / len(reqs),
        kernel_passes=fused[0], selection_launches=counts,
        handle_batch_s=serve_s, build_server_s=build_s,
        phase_s=time.perf_counter() - t_phase)
    server.fleet.close()
    return counts["retrieval_topk"]["tiled"]


RETRIEVAL_N, RETRIEVAL_D, RETRIEVAL_B = 1_500_007, 256, 64  # ragged last tile
RETRIEVAL_KS = (16, 100)  # the tiled route, then the select route
# planted tie groups (duplicates of one row, the query equal to it): sizes
# that straddle both k, so the lowest ids must win inside a tie
TIE_GROUPS = (120, 2, 16, 17, 50, 99, 100, 101, 3, 64, 65, 1)


def int_corpus(seed: int):
    """The exact corpus: integers in [-3, 3], so every fp32 dot product
    (|s| <= 256 * 9) is exact in any order.  Each tie group is one row
    copied to ids spread over the corpus (its last id the corpus' last row,
    in the ragged tile), and query i equals group i's row; the other
    queries are drawn like the rows.  Returns (emb, Q, groups)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n, d, B = RETRIEVAL_N, RETRIEVAL_D, RETRIEVAL_B
    emb = rng.integers(-3, 4, size=(n, d), dtype=np.int8).astype(np.float32)
    Q = rng.integers(-3, 4, size=(B, d), dtype=np.int8).astype(np.float32)
    ids = rng.choice(n - 1, size=sum(TIE_GROUPS), replace=False)
    groups, at = [], 0
    for i, g in enumerate(TIE_GROUPS):
        grp = np.sort(ids[at:at + g])
        at += g
        if i == 0:
            grp[-1] = n - 1  # a duplicate in the ragged last tile
        emb[grp] = emb[grp[0]]
        Q[i] = emb[grp[0]]
        groups.append(grp)
    return emb, Q, groups


def retrieval_phase(torch, dev, bw, fp32, seed: int) -> tuple[int, dict]:
    """Context retrieval at deployment size: ``VectorStore(emb,
    device="cuda").search_batch(Q, k, use_kernel=True)``, the call a
    pipeline makes, over 1 500 007 chunks x d 256 fp32 (1.54 GB on the
    card) for 64 queries, at k 16 (tiled route) and k 100 (select route).
    On the integer corpus ids and scores must equal the host
    ``search_batch(Q, k)`` exactly, and every planted tie group must give
    its lowest ids; on unit rows ids must be equal on every row whose
    host gap between the k-th and (k+1)-th score exceeds TIE (positions
    inside a host near-tie may swap), scores within ATOL.  The counters
    are set to 0 before each call: one launch on the route's counter; a
    second call at a k must reuse the resident corpus.  Returns the
    launches of the calls checked, in all and by route."""
    import numpy as np

    from repro_torch.core.retrieval import VectorStore
    from repro_torch.kernels.common import sm_count
    from repro_torch.kernels.retrieval_topk import kernel as topk_kernel
    from repro_torch.kernels.retrieval_topk.ops import retrieval_topk
    from repro_torch.kernels.retrieval_topk.ref import retrieval_topk_ref

    t_phase = time.perf_counter()
    n, d, B = RETRIEVAL_N, RETRIEVAL_D, RETRIEVAL_B
    total = {"launches": 0, "tiled": 0, "select": 0}

    def one_call(store, Q, k, where):
        zero_selection_counts()
        t0 = time.perf_counter()
        res = store.search_batch(Q, k, use_kernel=True)
        call_s = time.perf_counter() - t0
        variant = topk_kernel.route(k)
        got = selection_counts()["retrieval_topk"]
        want = {"launches": 1, "tiled": int(variant == "tiled"),
                "select": int(variant == "select")}
        if got != want:
            raise AssertionError(f"{where}: retrieval_topk launches {got}, "
                                 f"want {want}")
        for key in total:
            total[key] += got[key]
        return res, call_s

    def host(store, Q, k):
        t0 = time.perf_counter()
        res = store.search_batch(Q, k)
        return res, 1e3 * (time.perf_counter() - t0)

    def timing(store, Q, k) -> dict:
        """The entry point per call on the host clock (the query copy in,
        the lists out), the kernel on the resident corpus by CUDA events
        and from a graph, the plain version and the library call (calls of
        tens of ms take fewer loops)."""
        for _ in range(2):
            store.search_batch(Q, k, use_kernel=True)
        t0 = time.perf_counter()
        for _ in range(5):
            store.search_batch(Q, k, use_kernel=True)
        entry_ms = 1e3 * (time.perf_counter() - t0) / 5
        c = store._dev_emb
        q = torch.as_tensor(Q, device=dev)
        op = lambda: retrieval_topk(q, c, k=k)
        lib = lambda: torch.topk(q @ c.T, k, dim=1)
        b_ms, b_by = cost_bound(bw, fp32, topk_kernel.cost(B, n, d, k))
        variant = topk_kernel.route(k)
        loops = (TRIALS, LOOP) if variant == "tiled" else (3, 3)
        rows = B if variant == "tiled" else topk_kernel.select_chunk(B, n, k)
        grid = topk_kernel.grid(rows, n, sm_count(dev))._asdict()
        if variant == "select":  # the product runs B in chunks of rows
            grid["select_chunk"] = rows
        return dict(route=variant, grid=grid, search_batch_ms=entry_ms,
                    ms=time_ms(torch, op, *loops),
                    graph_ms=graph_ms(torch, op, loops[1], loops[0]),
                    plain_ms=time_ms(torch, lambda: retrieval_topk_ref(
                        q, c, k=k), 2, 3),
                    library_ms=time_ms(torch, lib),
                    library_graph_ms=graph_ms(torch, lib),
                    bound_ms=b_ms, bound_by=b_by)

    # -- the integer corpus: exact equality with the host path
    t0 = time.perf_counter()
    emb, Q, groups = int_corpus(seed)
    store = VectorStore(emb, device="cuda")
    make_s = time.perf_counter() - t0
    for k in RETRIEVAL_KS:
        where = f"retrieval/int k{k}"
        want, host_ms = host(store, Q, k)
        got, first_s = one_call(store, Q, k, where)
        bad = [i for i, (g, w) in enumerate(zip(got, want))
               if not (np.array_equal(g.ids, w.ids) and np.array_equal(
                   g.scores.view(np.uint32), w.scores.view(np.uint32)))]
        if bad:
            raise AssertionError(f"{where}: rows {bad[:8]} differ from the "
                                 "host search_batch")
        for i, grp in enumerate(groups):
            top = min(k, grp.size)
            if not np.array_equal(got[i].ids[:top], grp[:top]):
                raise AssertionError(f"{where}: tie group {i} (size "
                                     f"{grp.size}) did not give its lowest "
                                     f"ids: {got[i].ids[:top]}")
        dev_emb, ent = store._dev_emb, store._stage_cache[k]
        mem0 = torch.cuda.memory_allocated()
        again, _ = one_call(store, Q, k, where + " again")
        grew = torch.cuda.memory_allocated() - mem0
        if store._dev_emb is not dev_emb or store._stage_cache[k] is not ent \
                or ent[0].data_ptr() != dev_emb.data_ptr() \
                or grew >= dev_emb.nbytes:
            raise AssertionError(f"{where}: the second call copied the "
                                 f"corpus again (allocated +{grew} B)")
        if not all(np.array_equal(a.ids, g.ids) for a, g in zip(again, got)):
            raise AssertionError(f"{where}: a second call differs")
        # timed on the unit rows below: the same shapes and route
        log("retrieval", corpus="integers [-3, 3]", n=n, d=d, B=B, k=k,
            route=topk_kernel.route(k), exact=True, tie_groups=len(groups),
            host_ms=host_ms, first_call_s=first_s, corpus_build_s=make_s)
    del store, emb, dev_emb, ent
    torch.cuda.empty_cache()

    # -- unit rows: ids wherever the host's scores separate them
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    emb_t = unit(torch, gen, (n, d), dev)
    emb = emb_t.cpu().numpy()
    Q = unit(torch, gen, (B, d), dev).cpu().numpy()
    del emb_t
    store = VectorStore(emb, device="cuda")
    for k in RETRIEVAL_KS:
        where = f"retrieval/unit k{k}"
        want, host_ms = host(store, Q, k + 1)
        got, first_s = one_call(store, Q, k, where)
        hv = np.stack([w.scores for w in want])
        hi = np.stack([w.ids for w in want])[:, :k]
        gv = np.stack([g.scores for g in got])
        gi = np.stack([g.ids for g in got])
        err = float(np.abs(gv - hv[:, :k]).max())
        if err > ATOL:
            raise AssertionError(f"{where}: scores differ by {err}")
        gap = hv[:, k - 1] - hv[:, k] > TIE
        near = np.zeros_like(hi, dtype=bool)  # host neighbours within TIE
        close = np.abs(np.diff(hv[:, :k], axis=1)) <= TIE
        near[:, 1:] |= close
        near[:, :-1] |= close
        same_set = np.array([set(a) == set(b) for a, b in zip(gi, hi)])
        if not same_set[gap].all() or ((gi != hi) & ~near)[gap].any():
            raise AssertionError(f"{where}: ids differ on a row whose k-th "
                                 f"and (k+1)-th host scores part by > {TIE}")
        log("retrieval", corpus="unit rows", n=n, d=d, B=B, k=k,
            max_abs_err=err, rows_checked=int(gap.sum()),
            near_tie_swaps=int(((gi != hi) & gap[:, None]).sum()),
            host_ms=host_ms, first_call_s=first_s, **timing(store, Q, k))
    del store, emb
    torch.cuda.empty_cache()
    log("retrieval", launches=total, phase_s=time.perf_counter() - t_phase)
    return total["launches"], {"tiled": total["tiled"],
                               "select": total["select"]}


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the retrieval phase's corpora")
    seed = ap.parse_args(argv).seed

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "csrc" / "attention.cu").is_file():
        print(f"chip_smoke: {SRC / 'repro_torch'} is missing: run from a "
              "checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()

    from repro_torch.core.slo import SLO
    from repro_torch.kernels.build import kernel_library
    from repro_torch.kernels.common import sm_count
    from repro_torch.kernels.dsqe_score import kernel as dsqe_kernel
    from repro_torch.kernels.dsqe_score.ops import dsqe_score
    from repro_torch.kernels.retrieval_topk import kernel as topk_kernel
    from repro_torch.kernels.dsqe_score.ref import dsqe_score_ref
    from repro_torch.kernels.retrieval_topk.ops import retrieval_topk
    from repro_torch.kernels.retrieval_topk.ref import retrieval_topk_ref
    from repro_torch.launch.serve import build_server
    from repro_torch.runtime.server import Request

    # -- 1. device -------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    bw, fp32, bf16 = peaks(name)
    lib = kernel_library()
    log("device", nvidia_smi=smi, name=name, count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda,
        peaks_used={"hbm_bytes_per_s": bw, "fp32_flops_per_s": fp32,
                    "bf16_tensor_flops_per_s": bf16},
        kernel_build_s=round(lib.build_s, 3), ptxas=ptxas_report(lib.log),
        wgmma_serialized=wgmma_serialized(lib.log))
    spills = [e for e in ptxas_report(lib.log)
              if e["kernel"].startswith("rglru_scan") and e["spill_bytes"]]
    if spills:
        raise AssertionError(f"ptxas spills in rglru_scan.cu: {spills}")
    dev = torch.device("cuda")

    # the served selector: its tables are the main-path shapes
    t0 = time.perf_counter()
    server, test_idx = build_server("automotive", n_queries=120, budget=5.0,
                                    use_kernel=True, device="cuda")
    sel = server.rps
    build_s = time.perf_counter() - t0
    slo_args = [{}, {"max_latency_s": 2.0, "max_cost_usd": 0.004},
                {"max_latency_s": 1e-6, "max_cost_usd": 0.0},
                {"max_latency_s": 4.0, "max_cost_usd": 0.008}]
    slos = [SLO(**slo_args[i % 4]) for i in range(len(test_idx))]
    embs, _, max_lat, max_cost = sel._batch_inputs(
        server.domain.query_embeddings[test_idx], slos)
    embs32, slo32, _ = sel._pad_bucket(embs, max_lat, max_cost)
    state, _ = sel._ensure_kernel()
    _, corpus, tables, _ = state  # projection, retrieve, score, decode
    z = sel.dsqe.project(embs32)
    slo_t = torch.from_numpy(slo32).to(dev)
    served_args = (z, tables[0], corpus, *tables[1:], slo_t)
    knn = min(sel.knn, corpus.shape[0])

    # -- 2. kernels ------------------------------------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    deploy = deployment_tables(torch, gen, dev, 256, 256, 32, 16384, 210)
    wide_q = unit(torch, gen, (256, 512), dev)
    wide_c = unit(torch, gen, (65536, 512), dev)
    odd_q = unit(torch, gen, (256, 2049), dev)  # rows copied 4 bytes at a time
    odd_c = unit(torch, gen, (4096, 2049), dev)
    summary = {}

    def run_topk(shape_name, q, c, k, loops=()):
        """One retrieval shape: the served route (tiled for k <= 64, select
        above; its counter must move) against the plain version, its time
        per call and as device time from a CUDA graph, the warp-per-row
        variant on the same inputs where it takes them (its explicit route:
        k <= 64, d up to about 1600), the plain version and the library
        call."""
        B, d = q.shape
        n = c.shape[0]
        variant = topk_kernel.route(k)
        before = getattr(retrieval_topk, f"launches_{variant}")
        vals, ids = retrieval_topk(q, c, k=k)
        torch.cuda.synchronize()
        if getattr(retrieval_topk, f"launches_{variant}") != before + 1:
            raise AssertionError(f"topk/{shape_name}: did not take the "
                                 f"{variant} route")
        err, swaps = check_topk(torch, vals, ids, q, c, k, f"topk/{shape_name}")
        op = lambda: retrieval_topk(q, c, k=k)
        ms, dev_ms = time_ms(torch, op), graph_ms(torch, op)
        row_ms = None
        if k <= topk_kernel.TILED_MAX_K and d <= ROW_MAX_D:
            row_ms = time_ms(torch, lambda: topk_kernel.launch(q, c, k, "row"),
                             *loops)
        plain = time_ms(torch, lambda: retrieval_topk_ref(q, c, k=k))
        lib = lambda: torch.topk(q @ c.T, k, dim=1)
        lib_ms, lib_dev_ms = time_ms(torch, lib), graph_ms(torch, lib)
        b_ms, b_by = cost_bound(bw, fp32, topk_kernel.cost(B, n, d, k))
        g = topk_kernel.grid(B, n, sm_count(dev))
        log("kernels", kernel="retrieval_topk", shape=shape_name,
            B=B, n=n, d=d, k=k, variant=variant, grid=g._asdict(),
            max_abs_err=err, near_tie_swaps=swaps, ms=ms, graph_ms=dev_ms,
            row_ms=row_ms, plain_ms=plain, library_ms=lib_ms,
            library_graph_ms=lib_dev_ms, bound_ms=b_ms, bound_by=b_by)
        return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                    bound_by=b_by, library_ms=lib_ms)

    def run_dsqe(shape_name, args, k, loops=()):
        """One scoring shape: the route (tiled for knn <= 64, select above;
        its counter must move) against the plain version, its time per call
        and as device time from a CUDA graph, the first port's warp-per-row
        kernel on the same inputs where it takes them (its explicit route),
        and the plain version.  No single PyTorch call computes it."""
        q, protos, train, pathw, contains = args[:5]
        B, d = q.shape
        K, N, P = protos.shape[0], train.shape[0], pathw.shape[1]
        variant = topk_kernel.route(k)
        before = getattr(dsqe_score, f"launches_{variant}")
        scores, set_id = dsqe_score(*args, knn=k)
        torch.cuda.synchronize()
        if getattr(dsqe_score, f"launches_{variant}") != before + 1:
            raise AssertionError(f"dsqe/{shape_name}: did not take the "
                                 f"{variant} route")
        err, tie_rows = check_dsqe(torch, scores, set_id, args, k,
                                   f"dsqe/{shape_name}")
        op = lambda: dsqe_score(*args, knn=k)
        ms, dev_ms = time_ms(torch, op), graph_ms(torch, op)
        row_ms = None
        if k <= topk_kernel.TILED_MAX_K and d <= ROW_MAX_D:
            flat = (*args[:5], *(t.reshape(-1) for t in args[5:9]), args[9])
            row_ms = time_ms(torch, lambda: dsqe_kernel.launch(*flat, k, "row"),
                             *loops)
        plain = time_ms(torch, lambda: dsqe_score_ref(*args, knn=k))
        # bytes the function must move: q, protos, train, the path-weight
        # and containment rows this data selects, four (P,) tables, SLOs,
        # and the outputs
        _, nn_ids = retrieval_topk_ref(q, train, k=k)
        rows_used = int(torch.unique(nn_ids).numel())
        sets_used = int(torch.unique(set_id).numel())
        nbytes = 4 * (B * d + K * d + N * d + rows_used * P + sets_used * P
                      + 4 * P + 2 * B + B * P + B)
        ops = 2 * B * N * d + 2 * B * K * d + 2 * B * k * P
        b_ms, b_by = bound(bw, fp32, nbytes, ops)
        g = topk_kernel.grid(B, N, sm_count(dev))
        log("kernels", kernel="dsqe_score", shape=shape_name, B=B, d=d, K=K,
            N=N, P=P, knn=k, variant=variant, grid=g._asdict(),
            max_abs_err=err, knn_tie_rows=tie_rows, ms=ms, graph_ms=dev_ms,
            row_ms=row_ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by)
        return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                    bound_by=b_by, library_ms=None)

    summary["retrieval_topk"] = run_topk("served", z, corpus, knn)
    run_topk("deployment", deploy[0], deploy[2], 16, loops=(3, 5))
    run_topk("deployment k100", deploy[0], deploy[2], 100)
    run_topk("wide", wide_q, wide_c, 50, loops=(3, 5))
    run_topk("odd width", odd_q, odd_c, 16)
    # the same rows cut to d 2048: 16-byte copies, the same grid
    run_topk("even width", odd_q[:, :2048].contiguous(),
             odd_c[:, :2048].contiguous(), 16)
    summary["dsqe_score"] = run_dsqe("served", served_args, knn)
    run_dsqe("deployment", deploy, 16, loops=(3, 5))
    run_dsqe("deployment knn100", deploy, 100)
    del wide_q, wide_c, odd_q, odd_c, deploy
    summary.update(attention_kernels(torch, dev, gen, bw, bf16))
    summary["moe_gmm"] = gmm_kernels(torch, dev, gen, bw, bf16)
    summary["rglru_scan"] = scan_kernels(torch, dev, gen, bw, fp32)

    # -- 3. serve --------------------------------------------------------
    reqs = [Request(prompt="", qid=int(q), slo=s)
            for q, s in zip(test_idx, slos)]
    # the selector's first pass pays one-time costs (lazy CUDA module
    # loads of the torch ops); time it apart from the counted run
    select_ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        sel.select_batch(embs, slos)
        torch.cuda.synchronize()
        select_ms.append(1e3 * (time.perf_counter() - t0))
    batches0 = server.system_state()["dispatch_batches"]
    zero_selection_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    responses = server.handle_batch(reqs)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = {"retrieval_topk": retrieval_topk.launches,
                "dsqe_score": dsqe_score.launches}
    variants = {op.__name__: {"tiled": op.launches_tiled,
                              "select": op.launches_select}
                for op in (retrieval_topk, dsqe_score)}
    passes = server.system_state()["dispatch_batches"] - batches0
    if len(responses) != len(reqs):
        raise AssertionError(f"served {len(responses)} of {len(reqs)}")
    if passes < 1 or launches["retrieval_topk"] != passes:
        raise AssertionError(f"retrieval_topk launched "
                             f"{launches['retrieval_topk']} times over "
                             f"{passes} selection passes")
    if variants["retrieval_topk"] != {"tiled": passes, "select": 0}:
        raise AssertionError(f"retrieval_topk launched "
                             f"{variants['retrieval_topk']} by variant, want "
                             f"all {passes} on the tiled kernel")
    if variants["dsqe_score"] != {"tiled": 0, "select": 0} or \
            launches["dsqe_score"]:
        raise AssertionError(f"dsqe_score launched {variants['dsqe_score']} "
                             "by variant on the served path, want none: "
                             "select_batch runs retrieve + score as stages")

    mismatched = mismatches(responses, numpy_twin(sel).select_batch(embs, slos))
    if mismatched:
        raise AssertionError(f"{mismatched} rows decide unlike the numpy "
                             "engine")

    # the fused-kernel scoring of the same batch on the selector's state;
    # this launch is a check, not part of the served path
    f_scores, f_set, _, _ = sel._score_batch_kernel(embs, max_lat, max_cost,
                                                    sel._ver)
    check_launches = dsqe_score.launches
    k_scores, k_set = dsqe_score(*served_args, knn=knn)
    check_launches = dsqe_score.launches - check_launches
    torch.cuda.synchronize()
    if check_launches != 1:
        raise AssertionError(f"the dsqe_score check launched {check_launches} "
                             "times, want 1")
    B = len(test_idx)
    f_scores_t = torch.from_numpy(f_scores).to(dev)
    if not torch.equal(k_set[:B].long().cpu(), torch.from_numpy(f_set)):
        raise AssertionError("dsqe_score set ids differ from the fused pass")
    f_mask = f_scores_t < -5e29
    if not torch.equal(k_scores[:B] < -5e29, f_mask):
        raise AssertionError("dsqe_score masks differ from the fused pass")
    repro_err = float((k_scores[:B] - f_scores_t)[~f_mask].abs().max()) \
        if (~f_mask).any() else 0.0
    if repro_err > ATOL:
        raise AssertionError(f"dsqe_score differs from the fused pass by "
                             f"{repro_err}")

    n = len(responses)
    log("serve", domain="automotive", served=n, requests=len(reqs),
        selection_passes=passes,
        retrieval_topk_launches=launches["retrieval_topk"],
        retrieval_topk_launches_by_variant=variants["retrieval_topk"],
        selection_grid=topk_kernel.grid(z.shape[0], corpus.shape[0],
                                        sm_count(dev))._asdict(),
        dsqe_score_launches=launches["dsqe_score"],
        dsqe_score_check_launches=check_launches,
        decision_parity=1.0 - mismatched / n,
        fallback_rows=sum(r.meta["fallback"] for r in responses),
        dsqe_score_vs_fused_max_abs_err=repro_err,
        accuracy=sum(r.accuracy for r in responses) / n,
        mean_ttft_s=sum(r.latency_s for r in responses) / n,
        cost_per_1k_usd=1000 * sum(r.cost_usd for r in responses) / n,
        selection_ms_per_query=1e3 * sum(r.selection_overhead_s
                                         for r in responses) / n,
        first_select_batch_ms=select_ms[0], second_select_batch_ms=select_ms[1],
        handle_batch_s=serve_s, build_server_s=build_s,
        fused_traces=server.system_state()["fused_traces"],
        total_s=time.perf_counter() - t_start)

    # -- 4-6. the serving runtime: tenants (the served selector behind a
    # single-domain router too), adaptation, placements; every one of their
    # kernel-backed selection passes launches one tiled retrieval_topk
    runtime_launches = tenants_phase(torch, server, test_idx)
    server.fleet.close()
    runtime_launches += adaptation_phase(torch)
    runtime_launches += placements_phase(torch)
    launches["retrieval_topk"] += runtime_launches
    variants["retrieval_topk"]["tiled"] += runtime_launches

    # -- 7. retrieval: the store's device path at deployment size --------
    n_calls, by_route = retrieval_phase(torch, dev, bw, fp32, seed)
    launches["retrieval_topk"] += n_calls
    for route, count in by_route.items():
        variants["retrieval_topk"][route] += count

    # -- 8-17. the served models, then training: a kernel on several paths
    # reports the sum of its launches over their runs, in all and by variant
    # (flash_attention's training forwards as "lse_tc" / "lse_ffma"); the
    # largest model last, once every earlier phase's tensors are freed
    train = lambda torch, dev: train_phase(torch, dev, gen, bw, bf16, summary)
    train_tp = lambda torch, dev: train_tp_phase(torch, dev, summary)
    train_moe = lambda torch, dev: train_moe_phase(torch, dev, gen, bw, bf16,
                                                   summary)
    train_hybrid = lambda torch, dev: train_hybrid_phase(torch, dev, gen, bw,
                                                         fp32, summary)
    for phase in (model_phase, moe_phase, hybrid_phase, xlstm_phase,
                  encdec_phase, train, train_tp, train_moe, train_hybrid,
                  vlm_phase):
        counts, by_variant = phase(torch, dev)
        for op, n in counts.items():
            launches[op] = launches.get(op, 0) + n
        for op, by in by_variant.items():
            acc = variants.setdefault(op, dict.fromkeys(by, 0))
            for v, n in by.items():
                acc[v] = acc.get(v, 0) + n

    if launches[DECODE_LSE]:
        raise AssertionError(f"decode's lse twin launched "
                             f"{launches[DECODE_LSE]} times on the main path")

    # -- 18. split -------------------------------------------------------
    split_phase(torch)

    # -- 19. dryrun ------------------------------------------------------
    dryrun_phase()
    log("done", total_s=time.perf_counter() - t_start)

    csrc = "src/repro_torch/csrc/"
    kernels = [
        {"name": "retrieval_topk", "route": "cuda",
         "source": csrc + "retrieval_topk.cu",
         "replaces": "src/repro/kernels/retrieval_topk/kernel.py:87"},
        {"name": "dsqe_score", "route": "cuda",
         "source": csrc + "dsqe_score.cu",
         "replaces": "src/repro/kernels/dsqe_score/kernel.py:112"},
        {"name": "flash_attention", "route": "cuda",
         "source": csrc + "flash_attention_tc.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:91"},
        {"name": "decode_attention", "route": "cuda",
         "source": csrc + "decode_attention_tc.cu",
         "replaces": "src/repro/kernels/decode_attention/kernel.py:77"},
        # #3's lse twin on a slice of a cache sharded along its slots (a
        # rank of tp > 1 serving, api.local_decode): its main-path count is
        # read on every served and trained run and is 0 (no one-card path
        # launches it); the kernels phase holds it against its plain twin
        # and the merge against the whole cache
        {"name": "decode_attention_lse", "route": "cuda",
         "source": csrc + "decode_attention_tc.cu",
         "replaces": "src/repro/kernels/decode_attention/kernel.py:77",
         "kernels": ["decode_attention_tc_kernel<kTwin>",
                     "decode_tc_combine_kernel<kTwin>"]},
        {"name": "moe_gmm", "route": "cuda", "source": csrc + "moe_gmm.cu",
         "replaces": "src/repro/kernels/moe_gmm/kernel.py:39"},
        {"name": "rglru_scan", "route": "cuda",
         "source": csrc + "rglru_scan.cu",
         "replaces": "src/repro/kernels/rglru_scan/kernel.py:41"},
        # the backward of the flash forward (#4): the JAX package's custom
        # VJP backward, XLA (no pallas_call) beside the Pallas forward
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": csrc + "flash_attention_bwd.cu",
         "replaces": "src/repro/models/layers.py:189",
         "kernels": list(BWD_KERNELS)},
        # the same backward above hd 128 (RecurrentGemma-2B's hd 256)
        {"name": "flash_attention_bwd_wide", "route": "cuda",
         "source": csrc + "flash_attention_bwd.cu",
         "replaces": "src/repro/models/layers.py:189",
         "kernels": list(BWD_WIDE_KERNELS)},
        # the backwards of #5 and #6: XLA's autodiff of the MoE einsums and
        # of the associative scan in the reference (no pallas_call)
        {"name": "moe_gmm_bwd", "route": "cuda",
         "source": csrc + "moe_gmm.cu",
         "replaces": "src/repro/models/blocks.py:331",
         "kernels": ["moe_gmm_bwd_tc_kernel (dx^T = w . dy^T)",
                     "moe_gmm_bwd_tc_kernel (dw = x^T . dy)"]},
        {"name": "rglru_scan_bwd", "route": "cuda",
         "source": csrc + "rglru_scan.cu",
         "replaces": "src/repro/models/blocks.py:431",
         "kernels": ["rglru_scan_bwd_kernel"]},
    ]
    for entry in kernels:
        op = entry["name"]
        entry.update(launches=launches[op], variants=variants.get(op),
                     **summary[op])
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
