#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

Builds the selection kernels from ``src/repro_torch/csrc``, serves a domain
end to end through ``repro_torch.launch.serve.build_server`` with
``use_kernel=True``, and holds every kernel against its plain torch version
on the card.  Phases, one JSON line each:

1. ``device``: the card (``nvidia-smi`` name and power limit) and the kernel
   build time with ptxas' register / shared-memory report.
2. ``kernels``: each kernel against its plain version at the served
   selector's own shapes and at seeded deployment-scale shapes, with its
   time per call (CUDA events around back-to-back calls, so at small shapes
   the wrapper's host overhead is part of it), the plain version's time, the least time the
   card could take (``bound_ms``) and, for retrieval_topk,
   ``torch.topk(q @ c.T, k)`` as a library yardstick the port never calls.
3. ``serve``: ``handle_batch`` over the held-out queries under mixed SLOs,
   with the launch counters set to 0 just before (after two timed warm-up
   ``select_batch`` calls on the same batch) and read just after.  Every
   request must be answered, retrieval_topk must have launched once per
   selection pass, and every row must decide as the same selector's numpy
   engine does.  ``select_batch`` runs retrieve + score as two stages, so
   dsqe_score launches no time on the served path; after the counters are
   read it is run once on the selector's stage state and must reproduce
   the fused pass's scores and set ids (``dsqe_score_check_launches``).

Then the card's ``nvidia-smi`` line, one ``{"kernels": [...]}`` line, and
last ``{"ok": true, "device": {...}}``.  Any failed check raises, and the
script exits non-zero without the result lines.  It needs a CUDA device and
the rest of the repository beside it.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Data-sheet peaks: HBM bytes/s and fp32 CUDA-core FLOP/s (no tensor cores:
# the kernels run plain fp32 FFMA), keyed by the exact name the card reports.
PEAKS = {"NVIDIA H100 80GB HBM3": (3.35e12, 66.9e12)}  # H100 SXM5
TIE = 1e-5  # values this close may order either way under fp32 rounding
ATOL = 1e-5  # unit-vector similarities and vote sums of <= k such terms
TRIALS, LOOP = 5, 20


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def peaks(name: str) -> tuple[float, float]:
    if name not in PEAKS:
        raise RuntimeError(f"no data-sheet peaks for {name!r}")
    return PEAKS[name]


def time_ms(torch, fn) -> float:
    """Per-call time: CUDA events around LOOP back-to-back calls, divided
    by LOOP; the median of TRIALS such loops, after warmup."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TRIALS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(LOOP):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / LOOP)
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


def bound(bw, flops_rate, nbytes, flops):
    t_bytes, t_ops = nbytes / bw, flops / flops_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "csrc" / "selection.cu").is_file():
        print(f"chip_smoke: {SRC / 'repro_torch'} is missing: run from a "
              "checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()

    from repro_torch.core.rps import RuntimePathSelector
    from repro_torch.core.slo import SLO
    from repro_torch.kernels.build import selection_library
    from repro_torch.kernels.dsqe_score.ops import dsqe_score
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
    bw, fp32 = peaks(name)
    lib = selection_library()
    ptxas = [ln.strip() for ln in lib.log.splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    log("device", nvidia_smi=smi, name=name, count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda,
        peaks_used={"hbm_bytes_per_s": bw, "fp32_flops_per_s": fp32},
        kernel_build_s=round(lib.build_s, 3), ptxas=ptxas)
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
    summary = {}

    def run_topk(shape_name, q, c, k):
        B, d = q.shape
        n = c.shape[0]
        vals, ids = retrieval_topk(q, c, k=k)
        torch.cuda.synchronize()
        err, swaps = check_topk(torch, vals, ids, q, c, k, f"topk/{shape_name}")
        ms = time_ms(torch, lambda: retrieval_topk(q, c, k=k))
        plain = time_ms(torch, lambda: retrieval_topk_ref(q, c, k=k))
        lib_ms = time_ms(torch, lambda: torch.topk(q @ c.T, k, dim=1))
        b_ms, b_by = bound(bw, fp32, 4 * (B * d + n * d) + 8 * B * k,
                           2 * B * n * d)
        log("kernels", kernel="retrieval_topk", shape=shape_name,
            B=B, n=n, d=d, k=k, max_abs_err=err, near_tie_swaps=swaps,
            ms=ms, plain_ms=plain, library_ms=lib_ms, bound_ms=b_ms,
            bound_by=b_by)
        return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                    bound_by=b_by, library_ms=lib_ms)

    def run_dsqe(shape_name, args, k):
        q, protos, train, pathw, contains = args[:5]
        B, d = q.shape
        K, N, P = protos.shape[0], train.shape[0], pathw.shape[1]
        scores, set_id = dsqe_score(*args, knn=k)
        torch.cuda.synchronize()
        err, tie_rows = check_dsqe(torch, scores, set_id, args, k,
                                   f"dsqe/{shape_name}")
        ms = time_ms(torch, lambda: dsqe_score(*args, knn=k))
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
        log("kernels", kernel="dsqe_score", shape=shape_name, B=B, d=d, K=K,
            N=N, P=P, knn=k, max_abs_err=err, knn_tie_rows=tie_rows, ms=ms,
            plain_ms=plain, bound_ms=b_ms, bound_by=b_by)
        return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                    bound_by=b_by, library_ms=None)

    summary["retrieval_topk"] = run_topk("served", z, corpus, knn)
    run_topk("deployment", deploy[0], deploy[2], 16)
    run_topk("wide", wide_q, wide_c, 50)
    summary["dsqe_score"] = run_dsqe("served", served_args, knn)
    run_dsqe("deployment", deploy, 16)
    del wide_q, wide_c, deploy

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
    retrieval_topk.launches = 0
    dsqe_score.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    responses = server.handle_batch(reqs)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = {"retrieval_topk": retrieval_topk.launches,
                "dsqe_score": dsqe_score.launches}
    passes = server.system_state()["dispatch_batches"] - batches0
    if len(responses) != len(reqs):
        raise AssertionError(f"served {len(responses)} of {len(reqs)}")
    if passes < 1 or launches["retrieval_topk"] != passes:
        raise AssertionError(f"retrieval_topk launched "
                             f"{launches['retrieval_topk']} times over "
                             f"{passes} selection passes")

    twin = RuntimePathSelector(sel.space, sel.dsqe, sel.cca, sel.table,
                               sel._train_embeddings, lam=sel.lam,
                               knn=sel.knn, use_kernel=False)
    want = twin.select_batch(embs, slos)
    got = [(r.path_key, r.meta["set_id"], r.meta["fallback"])
           for r in responses]
    mismatched = sum(g != (d.path.key, d.set_id, d.used_fallback)
                     for g, d in zip(got, want))
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

    server.fleet.close()

    source = "src/repro_torch/csrc/selection.cu"
    kernels = [
        {"name": "retrieval_topk", "route": "cuda", "source": source,
         "replaces": "src/repro/kernels/retrieval_topk/kernel.py:87",
         "launches": launches["retrieval_topk"], **summary["retrieval_topk"]},
        {"name": "dsqe_score", "route": "cuda", "source": source,
         "replaces": "src/repro/kernels/dsqe_score/kernel.py:112",
         "launches": launches["dsqe_score"], **summary["dsqe_score"]},
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
