#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100 for the
sm_90a kernels).

    python3 chip_smoke.py [--ticks N] [--profile-ticks N] [--out results.json]

Phases (any failure exits non-zero):

1. build the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a) and
   print the card's name and power limit;
2. hold each kernel against its plain PyTorch version on the card at the
   Grab4 shapes of the main path (integer weights: exact; lognormal
   weights: stated rtol) and on one workset bucket shape, and time both;
   every kernel, plain version and library call of phases 2, 6 and 9 gets
   a device time (``device_time_ms``: the device kernels of one call from
   ``torch.profiler``, median over back-to-back calls) and a call time
   (``cuda_time_ms``: events around one call);
3. the port's ``SpadeService`` on ``cuda`` against the same on ``cpu``
   (DG, small stream): reports and final states bit-identical;
4. the main path at full width: the Grab4 stream (6,023,000 vertices,
   ~25.0M base edges), DW, 4096-edge ticks, eps 0.1, max_rounds 20,
   window 64, through the fused engine and the workset engine, with the
   kernels' launch counters set to 0 just before and read just after;
5. a ``torch.profiler`` trace of a few steady-state fused Grab4 ticks:
   device time by kernel and the device's idle share;
6. the flash-attention kernel (K3) against its plain versions on the card
   at qwen3-14b's attention shapes (Hq 40, Hkv 8, D 128, bf16, batch 2):
   S 8192 causal, S 4000 (ragged) and a 1024 window at S 4096, elementwise
   and normwise per 64-row band, with controls the check must reject;
   times of K3, of the blocked plain version and of torch's SDPA;
7. the LM serving path on ``cuda`` (bf16, K3) against the same weights on
   ``cpu`` (float32, plain attention): a 2-layer qwen3-shaped model
   (d_model 1280, 10 heads over 2 kv heads, d_head 128), 6 prompts,
   prefill and 4 decode steps, and a wrongly windowed control;
8. the LM main path at full width: qwen3-14b (40 layers, d_model 5120,
   random weights from a seeded generator), 2 prompts x 8,192 tokens,
   prefill, 32 greedy decode steps, with K3's launch counter set to 0 just
   before and read just after (40 per prefill); then ``torch.profiler``
   traces of one more prefill and of four more decode steps;
9. the destination-row SpMM kernel (K4) against its plain versions on
   the card: gcn-cora's matrices on the Cora-sized graph (both directions,
   16 and 7 columns), on the Reddit-sized sampled block (``minibatch_lg``)
   and on ogbn-products (``ogb_products``, 61.9M edges), 16 columns, and
   tests/test_kernels.py's sweep; integer-valued inputs bit for bit
   against ``spmm_rows_ref`` and ``spmm_ref`` and (Cora and the sweep,
   through ``rows_from_tiles``) against ``block_spmm_ref`` on the same
   edges' dense tiles; normal ones within 1e-4 of ``spmm_ref``, repeats
   bit for bit; device and call times of K4, of ``spmm_rows_ref`` and of
   ``torch.sparse.mm``, and K4's bytes bound and gather floor;
10. the four GNN kinds at full width on the Cora-sized graph (gcn-cora,
    gat-cora, meshgraphnet, dimenet), cuda against cpu on the same weights
    in float32;
11. the GNN main path at full width: gcn-cora's forward on ogbn-products,
    the Cora-sized graph and the ``minibatch_lg`` block, through
    ``graph_batch``, ``gcn_rows`` and ``gnn_forward``, with K4's launch
    counter set to 0 just before the first forward and read just after (4
    per forward); the logits against the same forward with every
    aggregation computed by ``spmm_ref`` (both directions, both layer
    widths); rows-build seconds, the median of 10 forwards, nodes/s, peak
    memory and a ``torch.profiler`` trace.

The last two lines of standard output are the card's name and power limit
as ``nvidia-smi`` gives them, then ``{"ok": true, "device": {...}}``; the
line before them is the per-kernel JSON record.  Imports nothing of JAX
and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published HBM3 rate
GRAB_V = 6_023_168  # Grab4 vertex capacity (6,023,001 rounded up to 512)
GRAB_E = 27_500_032  # spade-grab edge capacity (27,500,000 rounded up to 512)
RTOL = 1e-4  # float sums over millions of lognormal terms in another order
WINDOW = 64
BATCH = 4096
DEVICE = "cuda"  # the phases below run here; main() refuses to run without it
BF16_FLOPS_PER_S = 989e12  # H100 SXM published dense bf16 tensor-core rate
ATTN_TOL = 2e-2  # K3 vs its float32 plain versions: bf16 P and output rounding
# ... and normwise, ||got - want|| / ||want|| over each band of ATTN_BAND
# query rows (a K3 consumer warpgroup's rows), all batches, heads and
# columns: at S 8192 a late row's output is ~0.02, so the elementwise check
# above cannot see a relative fault there; the bands hold the late rows on
# their own.  Set
# between K3's reading and the controls' (P rounded to fp8, l 5 % off on
# the late rows), which phase 6 reads in every run and must reject.
ATTN_NORM_TOL = 1e-2
ATTN_BAND = 64
# cuda bf16 logits vs cpu float32, relative to the row's largest |logit|: a
# bf16 run of the 2-layer phase-7 model deviates from its float32 run by
# 1.0-1.8 % of that scale (measured with both on a CPU, four seeds)
LM_TOL = 3e-2
# greedy tokens must be equal on at least this many rows of phase 7 whose
# top-2 margin the bf16 error cannot close (about a third of the rows of a
# random 2-layer model are near-ties, so phase 7 runs 6 prompts x 5 steps)
LM_MIN_DECIDED = 10
# the LM main path (phase 8): qwen3-14b at full width; traffic cut from
# prefill_32k (32 x 32,768) to 2 x 8,192 prompt tokens, then 32 decode steps
LM_ARCH, LM_BATCH, LM_PROMPT, LM_DECODE_STEPS = "qwen3-14b", 2, 8192, 32
LM_SEED = 0  # weights, prompts and attention inputs of phases 6-8
# K3 at qwen3-14b's attention shapes (batch, Hq, Hkv, D) and (S, window)
# cases: causal at the main path's length (timed), ragged, windowed
ATTN_SHAPE = (2, 40, 8, 128)
ATTN_CASES = ((8192, None), (4000, None), (4096, 1024))
# the GNN path (phases 9-11): gcn-cora's forward, whose aggregations run
# through K4 at its layer widths (16 and 7 columns)
GNN_SEED = 0  # graphs, weights and kernel inputs of phases 9-11
GNN_ARCH, GCN_WIDTHS = "gcn-cora", (16, 7)
GNN_ARCHS = ("gcn-cora", "gat-cora", "meshgraphnet", "dimenet")
GNN_FORWARDS = 10  # timed forwards per shape
# the graphs of gcn-cora's path: Cora-sized, Reddit's sampled block, and
# ogbn-products whole (2,449,408 nodes, 61,859,328 edges, 100 features)
GCN_SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products")
FP32_FLOPS_PER_S = 67e12  # H100 SXM published FP32 rate outside the tensor cores
K4_TOL = 1e-4  # K4 vs the COO oracle: tests/test_kernels.py's atol = rtol
# tests/test_kernels.py's block_spmm sweep (n_dst, n_src, n_edges, F, seed)
K4_SWEEP = ((256, 256, 1000, 64, 0), (300, 200, 700, 16, 1), (128, 512, 2000, 128, 2),
            (512, 512, 100, 200, 3))
# cuda vs cpu logits of phase 10, and K4's forward vs spmm_ref's in phase
# 11, in float32 (matmul precision "highest", no TF32), relative to each
# row's largest |logit|
GNN_TOL = 1e-4


# a torch.profiler trace of a short window of small kernels can come back
# without device events (seen once on the H100, phase 11 at full_graph_sm):
# it is taken again, up to this many times in all, before a phase fails
PROFILE_ATTEMPTS = 3


def log(*args) -> None:
    print(*args, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def sync() -> None:
    import torch

    if DEVICE == "cuda":
        torch.cuda.synchronize()


def cuda_time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Call time: the median CUDA-event time of one call of ``fn`` in ms,
    events on either side of the call and a synchronize after each.  For
    a kernel of a few microseconds this is the wrapper's host work and the
    launch latency, not the kernel."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def device_time_ms(fn, calls: int = 50) -> float:
    """Device time: ``torch.profiler`` over ``calls`` back-to-back calls of
    ``fn`` (after one untraced call), the device kernels (and copies) that
    each call launches summed; the median over the calls in ms, or the mean
    when the calls do not all launch the same number of kernels."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    for attempt in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            sync()
        evs = sorted((e for e in prof.events() if str(e.device_type).endswith("CUDA")),
                     key=lambda e: e.time_range.start)
        us = [e.time_range.elapsed_us() for e in evs]
        if sum(us) > 0:
            break
        log(f"device_time_ms: trace {attempt + 1} recorded no device time")
    check(sum(us) > 0, "device_time_ms: no device time recorded")
    per, rest = divmod(len(us), calls)
    if rest:
        return sum(us) / calls / 1e3
    return statistics.median(sum(us[i * per:(i + 1) * per]) for i in range(calls)) / 1e3


def timed(fn, calls: int = 50, reps: int = 20) -> tuple[float, float]:
    """(device ms, call ms) of one call of ``fn``."""
    return device_time_ms(fn, calls), cuda_time_ms(fn, reps=reps)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def compare(name, got, want, exact: bool, rtol: float = 0.0) -> float:
    """Exact (bitwise) equality, or ``|got - want| <= rtol * max(1, |want|)``
    for float tensors; returns the max abs error."""
    import torch

    for i, (g, w) in enumerate(zip(got, want)):
        g = g.reshape(-1)
        w = w.reshape(-1)
        if g.dtype != w.dtype or g.shape != w.shape:
            fail(f"{name}[{i}]: {g.dtype}{tuple(g.shape)} vs {w.dtype}{tuple(w.shape)}")
        if exact or not g.is_floating_point():
            check(torch.equal(g, w), f"{name}[{i}]: not bit-identical")
        else:
            err = (g.double() - w.double()).abs()
            lim = rtol * torch.clamp(w.double().abs(), min=1.0)
            check(bool((err <= lim).all()), f"{name}[{i}]: max abs err "
                  f"{float(err.max())} beyond rtol {rtol}")
    return max((max_abs(g.reshape(-1), w.reshape(-1)) for g, w in zip(got, want)
                if g.is_floating_point()), default=0.0)


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version at the main path's shapes
# ---------------------------------------------------------------------------


def k1_inputs(V: int, integer: bool, seed: int):
    import torch

    rng = np.random.default_rng(seed)
    if integer:  # every partial sum stays below 2^24: exact in any order
        w = rng.integers(0, 8, V).astype(np.float32)
        a = rng.integers(0, 3, V).astype(np.float32)
        dw = rng.integers(0, 4, V).astype(np.float32)
        thresh = 4.0
    else:
        w = rng.lognormal(2.0, 1.0, V).astype(np.float32)
        a = rng.lognormal(0.0, 1.0, V).astype(np.float32)
        dw = rng.lognormal(0.0, 1.0, V).astype(np.float32)
        thresh = float(np.median(w))
    active = rng.random(V) < 0.7
    level = rng.integers(-1, 20, V).astype(np.int32)
    cu = lambda x: torch.from_numpy(x).to(DEVICE)
    return (cu(w), cu(a), cu(active), cu(level), cu(dw),
            torch.tensor(thresh, dtype=torch.float32, device=DEVICE),
            torch.tensor(7, dtype=torch.int32, device=DEVICE))


def k2_inputs(src, dst, V: int, E: int, integer: bool, seed: int, pad: str):
    """Edge slots [0, m) from ``src/dst``, the rest pad slots of kind ``pad``
    ("full": src = dst = V-1, c = 0, dead; "workset": endpoint 0, c = 0,
    dead)."""
    import torch

    rng = np.random.default_rng(seed)
    m = src.shape[0]
    pad_id = V - 1 if pad == "full" else 0
    s = np.full(E, pad_id, np.int32)
    d = np.full(E, pad_id, np.int32)
    s[:m], d[:m] = src, dst
    c = np.zeros(E, np.float32)
    if integer:  # total dropped mass stays below 2^24: exact in any order
        c[:m] = rng.integers(1, 3, m)
    else:
        c[:m] = rng.lognormal(2.0, 1.0, m)
    alive = np.zeros(E, bool)
    alive[:m] = rng.random(m) < 0.95
    peel = rng.random(V) < 0.10
    cu = lambda x: torch.from_numpy(x).to(DEVICE)
    return cu(s), cu(d), cu(c), cu(alive), cu(peel)


def k1_bound_ms(V: int, n_peeled: int, n_blocks: int) -> float:
    # reads w, dw, level (4 B), active (1 B), a only where peeled (4 B);
    # writes w', level' (4 B), active', peeled (1 B), partials (12 B/block)
    nbytes = V * (4 + 4 + 4 + 1) + 4 * n_peeled + V * (4 + 4 + 1 + 1) + 12 * n_blocks
    return 1e3 * nbytes / HBM_BYTES_PER_S


def k2_bound_ms(E: int, V: int, n_alive: int, n_hit: int, n_blocks: int) -> float:
    # reads alive (1 B/slot), src+dst of live slots (8 B), c of live slots
    # with a peeled end (4 B), peel once (1 B/vertex); writes alive'
    # (1 B/slot), dw once (4 B/vertex), drop partials (4 B/block)
    nbytes = E + 8 * n_alive + 4 * n_hit + V + E + 4 * V + 4 * n_blocks
    return 1e3 * nbytes / HBM_BYTES_PER_S


def phase_kernels(grab) -> dict:
    import torch

    from repro_torch.kernels.frontier_spmv import frontier_spmv, frontier_spmv_ref
    from repro_torch.kernels.peel_round import peel_round, peel_round_ref
    from repro_torch.kernels._launch import n_blocks

    rec = {"peel_round": {"max_abs_err": 0.0}, "frontier_spmv": {"max_abs_err": 0.0}}
    # K1 at V = 6,023,168 and at a workset vertex bucket
    for V, tag in ((GRAB_V, "grab4"), (65_536, "bucket")):
        for integer in (True, False):
            args = k1_inputs(V, integer, seed=1 if integer else 2)
            got = peel_round(*args)
            want = peel_round_ref(*args)
            sync()
            err = compare(f"peel_round[{tag},{'int' if integer else 'lognormal'}]",
                          got, want, exact=integer, rtol=RTOL)
            rec["peel_round"]["max_abs_err"] = max(rec["peel_round"]["max_abs_err"], err)
            log(f"K1 peel_round V={V} {'int' if integer else 'lognormal'}: "
                f"{'bit-identical' if integer else f'max_abs_err={err!r} (rtol {RTOL})'}; "
                f"peeled={int(want[3].sum())}")
        if tag == "grab4":
            ms, call = timed(lambda: peel_round(*args))
            plain, plain_call = timed(lambda: peel_round_ref(*args))
            bound = k1_bound_ms(V, int(want[3].sum()), n_blocks(V, 132 * 8))
            rec["peel_round"].update(ms=ms, plain_ms=plain, bound_ms=bound, call_ms=call,
                                     plain_call_ms=plain_call)
            log(f"K1 peel_round V={V}: kernel {ms!r} ms device ({call!r} ms call), plain "
                f"{plain!r} ms device ({plain_call!r} ms call), bound {bound!r} ms (bytes)")
    # K2 at E = 27,500,032 over the Grab4 base graph, and at a workset bucket
    rng = np.random.default_rng(3)
    small_src = rng.integers(0, 65_536, 240_000).astype(np.int32)
    small_dst = rng.integers(0, 65_536, 240_000).astype(np.int32)
    cases = ((grab["src"], grab["dst"], GRAB_V, GRAB_E, "full", "grab4"),
             (small_src, small_dst, 65_536, 262_144, "workset", "bucket"))
    for src, dst, V, E, pad, tag in cases:
        for integer in (True, False):
            args = k2_inputs(src, dst, V, E, integer, seed=4 if integer else 5, pad=pad)
            got = frontier_spmv(*args)
            want = frontier_spmv_ref(*args)
            sync()
            err = compare(f"frontier_spmv[{tag},{'int' if integer else 'lognormal'}]",
                          got, want, exact=integer, rtol=RTOL)
            rec["frontier_spmv"]["max_abs_err"] = max(rec["frontier_spmv"]["max_abs_err"], err)
            log(f"K2 frontier_spmv E={E} V={V} pad={pad} "
                f"{'int' if integer else 'lognormal'}: "
                f"{'bit-identical' if integer else f'max_abs_err={err!r} (rtol {RTOL})'}; "
                f"drop_mass={float(want[1])!r}")
        if tag == "grab4":
            s, d, c, alive, peel = args
            hit = alive & (peel[s] | peel[d])
            ms, call = timed(lambda: frontier_spmv(*args))
            plain, plain_call = timed(lambda: frontier_spmv_ref(*args), calls=10, reps=10)
            bound = k2_bound_ms(E, V, int(alive.sum()), int(hit.sum()),
                                n_blocks(E, 132 * 16))
            rec["frontier_spmv"].update(ms=ms, plain_ms=plain, bound_ms=bound, call_ms=call,
                                        plain_call_ms=plain_call)
            log(f"K2 frontier_spmv E={E}: kernel {ms!r} ms device ({call!r} ms call), plain "
                f"{plain!r} ms device ({plain_call!r} ms call), bound {bound!r} ms (bytes)")
    return rec


# ---------------------------------------------------------------------------
# phase 3: the service on cuda against the service on cpu
# ---------------------------------------------------------------------------


def phase_parity() -> None:
    import dataclasses

    from repro_torch.convert import state_to_numpy
    from repro_torch.graphstore.generators import make_transaction_stream
    from repro_torch.serve import SpadeService

    stream = make_transaction_stream(n=3000, m=15000, seed=9)
    timing = {"mean_tick_seconds", "mean_us_per_edge", "tick_seconds"}
    for kw in ({}, {"window_ticks": 8, "workset": True}):
        reps, states = [], []
        for device in (DEVICE, "cpu"):
            svc = SpadeService("DG", batch_edges=512, device=device, **kw)
            reps.append(svc.run(stream))
            states.append(state_to_numpy(svc.final_state))
        for f in dataclasses.fields(reps[0]):
            if f.name not in timing:
                check(getattr(reps[0], f.name) == getattr(reps[1], f.name),
                      f"service parity {kw}: report.{f.name} "
                      f"{getattr(reps[0], f.name)!r} vs {getattr(reps[1], f.name)!r}")
        for k, v in states[0].items():
            check(np.array_equal(np.asarray(v), np.asarray(states[1][k])),
                  f"service parity {kw}: state.{k} differs")
        log(f"service parity cuda==cpu {kw or 'fused'}: bit-identical state, "
            f"final_g={reps[0].final_g!r} recall={reps[0].fraud_recall!r} "
            f"ticks={reps[0].n_ticks}")


# ---------------------------------------------------------------------------
# phase 4: the main path at Grab4 width
# ---------------------------------------------------------------------------


def phase_grab(stream, n_ticks: int) -> dict:
    import torch

    from repro_torch.core import peel as peel_mod
    from repro_torch.core.semantics import resolve
    from repro_torch.graphstore.generators import TxStream
    from repro_torch.graphstore.structs import device_graph_from_coo
    from repro_torch.kernels.frontier_spmv import ops as k2_ops
    from repro_torch.kernels.peel_round import ops as k1_ops
    from repro_torch.serve import SpadeService

    n_inc = min(n_ticks * BATCH, stream.inc_src.shape[0])
    n_ticks = -(-n_inc // BATCH)
    cut = TxStream(
        n_vertices=stream.n_vertices, base_src=stream.base_src,
        base_dst=stream.base_dst, base_amt=stream.base_amt,
        inc_src=stream.inc_src[:n_inc], inc_dst=stream.inc_dst[:n_inc],
        inc_amt=stream.inc_amt[:n_inc], inc_time=stream.inc_time[:n_inc],
        fraud_label=stream.fraud_label[:n_inc], fraud_block=stream.fraud_block,
    )
    m_base = stream.base_src.shape[0]
    n = stream.n_vertices
    log(f"grab4: n={n} m_base={m_base} increments={stream.inc_src.shape[0]} "
        f"(this run: {n_ticks} ticks of {BATCH}, window {WINDOW})")

    # the start-up bulk peel alone, on the graph the service builds
    sem = resolve("DW")
    base_w, in_deg = sem.seed_base(stream.base_src, stream.base_dst,
                                   stream.base_amt, n)
    e_cap = m_base + (WINDOW + 1) * BATCH
    g = device_graph_from_coo(n, stream.base_src, stream.base_dst, base_w,
                              n_capacity=-(-n // 512) * 512,
                              e_capacity=-(-e_cap // 512) * 512, device=DEVICE)
    sync()
    t0 = time.perf_counter()
    res = peel_mod.bulk_peel(g, eps=0.1)
    sync()
    startup_s = time.perf_counter() - t0
    startup_rounds = int(res.n_rounds)
    log(f"grab4 start-up bulk_peel: V={g.n_capacity} E={g.e_capacity} "
        f"rounds={startup_rounds} seconds={startup_s!r} "
        f"best_g={float(res.best_g)!r}")
    del g, res

    out = {"startup_rounds": startup_rounds, "startup_seconds": startup_s,
           "configs": {}}
    launches = {"peel_round": 0, "frontier_spmv": 0}
    for name, kw in (("fused", {}), ("workset", {"workset": True})):
        k1_ops.launches = 0
        k2_ops.launches = 0
        reads0 = peel_mod.HOST_READS[0]
        svc = SpadeService("DW", batch_edges=BATCH, eps=0.1, max_rounds=20,
                           window_ticks=WINDOW, device=DEVICE, **kw)
        t0 = time.perf_counter()
        rep = svc.run(cut)
        sync()
        wall = time.perf_counter() - t0
        l1, l2 = k1_ops.launches, k2_ops.launches
        launches["peel_round"] += l1
        launches["frontier_spmv"] += l2
        ts = sorted(rep.tick_seconds)
        ring = [min(BATCH, n_inc - i * BATCH) for i in range(n_ticks)]
        live_expect = m_base + sum(ring[-WINDOW:])
        check(l1 > 0 and l2 > 0, f"grab4 {name}: a kernel never launched")
        check(math.isfinite(rep.final_g), f"grab4 {name}: best_g not finite")
        check(rep.live_edges == live_expect,
              f"grab4 {name}: live_edges {rep.live_edges} != {live_expect}")
        check(rep.n_ticks == n_ticks, f"grab4 {name}: {rep.n_ticks} ticks")
        q = lambda p: ts[min(len(ts) - 1, int(p * len(ts)))]
        row = {
            "ticks": rep.n_ticks, "tick_median_s": statistics.median(ts),
            "tick_p90_s": q(0.90), "tick_p99_s": q(0.99), "tick_max_s": ts[-1],
            "wall_s": wall, "final_g": rep.final_g, "live_edges": rep.live_edges,
            "n_expired_edges": rep.n_expired_edges,
            "workset_ticks": rep.n_workset_ticks,
            "fallback_ticks": rep.n_fallback_ticks,
            "predicted_ticks": rep.n_predicted_ticks,
            "miss_ticks": rep.n_bucket_miss_ticks,
            "max_suffix_edges": rep.max_suffix_edges,
            "launches_peel_round": l1, "launches_frontier_spmv": l2,
            "host_reads": peel_mod.HOST_READS[0] - reads0,
        }
        out["configs"][name] = row
        log(f"grab4 {name}: " + " ".join(f"{k}={v!r}" for k, v in row.items()))
    g_fused = out["configs"]["fused"]["final_g"]
    g_ws = out["configs"]["workset"]["final_g"]
    check(abs(g_fused - g_ws) <= 1e-5 * abs(g_fused),
          f"grab4: fused best_g {g_fused!r} vs workset {g_ws!r} beyond rtol 1e-5")
    out["launches"] = launches
    return out


def trace(name: str, reps: int, fn, shares: dict[str, str]) -> dict:
    """``torch.profiler`` over ``reps`` calls of ``fn``: wall and device-busy
    ms per call, the device's idle share over the traced window, each
    ``shares`` kernel's share of device time (by a substring of its name)
    and the top kernels by device time per call."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    for attempt in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            sync()
            wall_us = 1e6 * (time.perf_counter() - t0)
        kernels = {}
        for e in prof.key_averages():
            if str(getattr(e, "device_type", "")).endswith("CUDA"):
                us = getattr(e, "self_device_time_total", 0) or 0
                if us > 0:
                    kernels[e.key] = (us, e.count)
        busy = sum(us for us, _ in kernels.values())
        if busy > 0:
            break
        log(f"{name} profile: trace {attempt + 1} recorded no device time")
    check(busy > 0, f"{name} profile: no device time recorded")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    out = {"calls": reps, "wall_ms": wall_us / 1e3 / reps,
           "device_busy_ms": busy / 1e3 / reps, "idle_share": 1.0 - busy / wall_us,
           "shares": {k: sum(us for key, (us, _) in kernels.items() if tag in key) / busy
                      for k, tag in shares.items()},
           "top": [(k[:90], us / 1e3 / reps, cnt / reps) for k, (us, cnt) in top[:15]]}
    log(f"{name} profiled ({reps}x): wall {out['wall_ms']!r} ms, device busy "
        f"{out['device_busy_ms']!r} ms, idle share {out['idle_share']!r}; shares of "
        f"device time {out['shares']!r}")
    for k, ms, cnt in out["top"]:
        log(f"  {ms:.4f} ms  {cnt:.1f}x  {k}")
    return out


# ---------------------------------------------------------------------------
# phase 5: where a fused Grab4 tick spends its device time
# ---------------------------------------------------------------------------


def phase_profile(stream, n_ticks: int) -> dict:
    """Trace ``n_ticks`` steady-state fused slide ticks at Grab4 width
    (window of 4 ticks, the same per-tick work as the service's window of
    64) with ``torch.profiler``; report device time by kernel and the
    device's idle share over the traced window."""
    import torch

    from repro_torch.core import incremental as inc
    from repro_torch.core.semantics import resolve
    from repro_torch.graphstore.structs import device_graph_from_coo

    sem = resolve("DW")
    n = stream.n_vertices
    m_base = stream.base_src.shape[0]
    window = 4
    base_w, in_deg = sem.seed_base(stream.base_src, stream.base_dst,
                                   stream.base_amt, n)
    e_cap = m_base + (window + 1) * BATCH
    g = device_graph_from_coo(n, stream.base_src, stream.base_dst, base_w,
                              n_capacity=-(-n // 512) * 512,
                              e_capacity=-(-e_cap // 512) * 512, device=DEVICE)
    state = inc.init_state(g, eps=0.1)
    deg = torch.zeros(g.n_capacity, dtype=torch.int32, device=DEVICE)
    deg[:n] = torch.from_numpy(in_deg.astype(np.int32)).to(DEVICE)
    slots = torch.arange(g.e_capacity, dtype=torch.int32, device=DEVICE)
    drop = (slots >= m_base) & (slots < m_base + BATCH)
    valid = torch.ones(BATCH, dtype=torch.bool, device=DEVICE)

    def tick(t, state, deg):
        sl = slice(t * BATCH, (t + 1) * BATCH)
        bs = torch.from_numpy(stream.inc_src[sl].astype(np.int32)).to(DEVICE)
        bd = torch.from_numpy(stream.inc_dst[sl].astype(np.int32)).to(DEVICE)
        amt = torch.from_numpy(stream.inc_amt[sl].astype(np.float32)).to(DEVICE)
        w, deg = sem.batch_weights(deg, bs, bd, amt, valid)
        return (bs, bd, w), deg

    for t in range(window + 1):  # fill the window, then one untraced slide
        batch, deg = tick(t, state, deg)
        if t < window:
            state = inc.insert_and_maintain(state, *batch, valid, eps=0.1,
                                            max_rounds=20)
        else:
            state = inc.slide_and_maintain(state, drop, *batch, valid, eps=0.1,
                                           max_rounds=20)
    batches = []
    for t in range(window + 1, window + 1 + n_ticks):
        batch, deg = tick(t, state, deg)
        batches.append(batch)
    ticks = iter(batches)

    def one_tick():
        nonlocal state
        state = inc.slide_and_maintain(state, drop, *next(ticks), valid, eps=0.1,
                                       max_rounds=20)

    return trace("grab4 fused slide tick", n_ticks, one_tick,
                 {"peel_round": "peel_round_kernel",
                  "frontier_spmv": "frontier_spmv_kernel"})


# ---------------------------------------------------------------------------
# phase 6: K3 against its plain versions at qwen3-14b's attention shapes
# ---------------------------------------------------------------------------


def attn_pairs(S: int, window: int | None) -> int:
    """Unmasked (q, k) pairs of a causal (windowed) S x S attention."""
    if window is None:
        return S * (S + 1) // 2
    return sum(min(i + 1, window) for i in range(S))


def k3_bound_ms(B, Hq, Hkv, S, D, window) -> float:
    flops = 4 * B * Hq * D * attn_pairs(S, window)
    nbytes = 2 * (2 * B * Hq * S * D + 2 * B * Hkv * S * D)  # q, o, k, v in bf16
    return 1e3 * max(flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S)


def band_rel_err(got, want) -> float:
    """Largest ||got - want||_F / ||want||_F over the bands of ATTN_BAND
    query rows of [B, H, S, D] outputs."""
    import torch.nn.functional as F

    S = got.shape[2]
    pad = -S % ATTN_BAND
    sq = lambda t: F.pad(t.float().square().sum(dim=(0, 1, 3)), (0, pad))
    err2 = sq(got.float() - want.float()).view(-1, ATTN_BAND).sum(1)
    want2 = sq(want).view(-1, ATTN_BAND).sum(1)
    return float((err2 / want2).sqrt().max())


def attn_errs(got, want) -> tuple[float, bool, float]:
    """(max abs error, whether |got - want| <= ATTN_TOL * (1 + |want|)
    holds elementwise, band relative error)."""
    err = (got.float() - want.float()).abs()
    ok = bool((err <= ATTN_TOL * (1 + want.float().abs())).all())
    return float(err.max()), ok, band_rel_err(got, want)


def attn_check(name, got, want) -> tuple[float, float]:
    """The elementwise check, and a band relative error of at most
    ATTN_NORM_TOL; (max abs error, band error)."""
    worst, ok, rel = attn_errs(got, want)
    check(ok, f"{name}: max abs err {worst!r} beyond atol = rtol = {ATTN_TOL}")
    check(rel <= ATTN_NORM_TOL,
          f"{name}: band relative err {rel!r} beyond {ATTN_NORM_TOL}")
    return worst, rel


def attention_p_rounded(q, k, v, p_dtype):
    """Dense causal attention of q [B, G, S, D] over one kv head k/v
    [B, 1, S, D] in float32, with the unnormalised P = exp(s - m) rounded
    to ``p_dtype`` before P V and l summed in float32: what K3 does with
    bf16, and a control with a coarser type."""
    import torch

    S, D = q.shape[2], q.shape[3]
    s = torch.einsum("bgqd,bkd->bgqk", q.float(), k[:, 0].float()) / D ** 0.5
    s.masked_fill_(torch.ones(S, S, dtype=torch.bool, device=q.device).triu_(1), -1e30)
    p = s.sub_(s.amax(-1, keepdim=True)).exp_()
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bgqk,bkd->bgqd", p.to(p_dtype).float(), v[:, 0].float()) / l
    return o.to(q.dtype)


def attn_controls(q, k, v, got, G: int) -> dict:
    """Band relative errors against the dense ``attention_ref``, kv head by
    kv head, of K3 (``got``), of the plain version with P rounded to bf16
    (K3's rounding) and to fp8 (a kernel that loses precision), and of the
    exact output with l 5 % too large on the second half of the rows (a
    kernel whose running sum goes wrong after many kv tiles).  The check
    must pass the first two and reject the last two; the elementwise check
    alone passes all but the fp8 control, and that only through early rows."""
    import torch

    from repro_torch.kernels.flash_attention import attention_ref

    S, Hkv = q.shape[2], k.shape[1]
    names = ("K3", "P bf16", "P fp8", "l +5% late")
    elem_ok = {n: True for n in names}
    rel = {n: 0.0 for n in names}
    for j in range(Hkv):
        qj, kj, vj = q[:, j * G:(j + 1) * G], k[:, j:j + 1], v[:, j:j + 1]
        want = attention_ref(qj, kj, vj, causal=True)
        late = want.clone()
        late[:, :, S // 2:] = (late[:, :, S // 2:].float() / 1.05).to(late.dtype)
        cands = {"K3": got[:, j * G:(j + 1) * G],
                 "P bf16": attention_p_rounded(qj, kj, vj, torch.bfloat16),
                 "P fp8": attention_p_rounded(qj, kj, vj, torch.float8_e4m3fn),
                 "l +5% late": late}
        for n, c in cands.items():
            _, ok, r = attn_errs(c, want)
            elem_ok[n] &= ok
            rel[n] = max(rel[n], r)
        del want, late, cands
    for n in names:
        log(f"  control {n}: band relative err {rel[n]!r}, elementwise check "
            f"{'passes' if elem_ok[n] else 'fails'}")
    check(rel["K3"] <= ATTN_NORM_TOL and rel["P bf16"] <= ATTN_NORM_TOL,
          f"attention controls: K3 or bf16 P beyond {ATTN_NORM_TOL}: {rel!r}")
    check(rel["P fp8"] > ATTN_NORM_TOL and rel["l +5% late"] > ATTN_NORM_TOL,
          f"attention controls: a planted fault within {ATTN_NORM_TOL}: {rel!r}")
    return {"band_rel_err": rel, "elementwise_passes": elem_ok}


def phase_attention(seed: int) -> tuple[dict, dict]:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (attention_ref, flash_attention,
                                                     flash_attention_ref)

    B, Hq, Hkv, D = ATTN_SHAPE
    G = Hq // Hkv
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    rec = {"max_abs_err": 0.0}
    norm = {"band_rel_err": {}}
    for S, window in ATTN_CASES:
        # the model layout: q [B, S, Hq, D], k/v [B, S, Hkv, D], read as views
        q, k, v = (torch.randn((B, S, h, D), generator=gen, device=DEVICE,
                               dtype=torch.float32).to(torch.bfloat16).permute(0, 2, 1, 3)
                   for h in (Hq, Hkv, Hkv))
        got = flash_attention(q, k, v, causal=True, window=window)
        sync()
        tag = f"K3 S={S} window={window}"
        err, rel = attn_check(f"{tag} vs flash_attention_ref", got,
                              flash_attention_ref(q, k, v, causal=True, window=window))
        # the dense oracle one kv head (G q heads) at a time, to bound memory
        for j in range(Hkv):
            e, r = attn_check(
                f"{tag} vs attention_ref (kv head {j})", got[:, j * G:(j + 1) * G],
                attention_ref(q[:, j * G:(j + 1) * G], k[:, j:j + 1], v[:, j:j + 1],
                              causal=True, window=window))
            err, rel = max(err, e), max(rel, r)
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        norm["band_rel_err"][tag] = rel
        log(f"{tag}: max_abs_err={err!r}, band relative err {rel!r} vs "
            f"flash_attention_ref and attention_ref (atol = rtol = {ATTN_TOL}; "
            f"{ATTN_NORM_TOL} per {ATTN_BAND}-row band)")
        if (S, window) == ATTN_CASES[0]:
            norm["controls"] = attn_controls(q, k, v, got, G)
            ms, call = timed(lambda: flash_attention(q, k, v), reps=10)
            plain = device_time_ms(lambda: flash_attention_ref(q, k, v), calls=3)
            plain_call = cuda_time_ms(lambda: flash_attention_ref(q, k, v), reps=3, warmup=1)
            lib, lib_call = timed(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), reps=10)
            bound = k3_bound_ms(B, Hq, Hkv, S, D, window)
            tflops = 4 * B * Hq * D * attn_pairs(S, window) / ms / 1e9
            rec.update(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, call_ms=call,
                       plain_call_ms=plain_call, library_call_ms=lib_call)
            norm.update(tflops=tflops, k3_over_sdpa=ms / lib)
            log(f"{tag}: kernel {ms!r} ms device ({call!r} ms call; {tflops!r} TFLOP/s, "
                f"{ms / lib!r}x sdpa, {bound / ms!r} of the bound), plain {plain!r} ms "
                f"device ({plain_call!r} ms call), sdpa {lib!r} ms device ({lib_call!r} ms "
                f"call), bound {bound!r} ms (operations)")
        del q, k, v, got
    torch.cuda.empty_cache()
    return rec, norm


# ---------------------------------------------------------------------------
# phase 7: the LM serving path on cuda against the same weights on cpu
# ---------------------------------------------------------------------------


def greedy_check(name, got, want) -> tuple[int, int]:
    """Logits [B, V]: ``|got - want| <= LM_TOL * max|want row|``, and the
    greedy tokens equal on every row whose top-2 margin in ``want`` exceeds
    twice the row's largest error (no closer row can change its argmax;
    closer rows are near-ties and are counted, not failed).
    Returns (rows decided, rows tied)."""
    import torch

    got = got.float().cpu()
    want = want.float().cpu()
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite logits")
    scale = want.abs().amax(dim=-1, keepdim=True)
    err = (got - want).abs()
    check(bool((err <= LM_TOL * scale).all()),
          f"{name}: max abs err {float(err.max())!r} beyond {LM_TOL} of the row scale "
          f"{scale.squeeze(-1).tolist()!r}")
    top2 = want.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * err.amax(dim=-1)
    same = got.argmax(-1) == want.argmax(-1)
    check(bool(same[decided].all()), f"{name}: greedy tokens differ on a decided row")
    return int(decided.sum()), int((~decided).sum())


def phase_lm_parity(seed: int) -> dict:
    import torch

    from repro_torch.configs.base import LMConfig
    from repro_torch.kernels.flash_attention import ops as k3_ops
    from repro_torch.models import TransformerLM, decode_step, prefill

    cfg = LMConfig(name="qwen3-narrow", n_layers=2, d_model=1280, n_heads=10,
                   n_kv_heads=2, d_head=128, d_ff=3456, vocab=4096, qk_norm=True)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    gpu = TransformerLM(cfg, device=DEVICE, generator=gen)
    cpu = TransformerLM(dataclasses.replace(cfg, dtype="float32"), device="cpu", init=False)
    cpu.load_state_dict({k: v.float().cpu() for k, v in gpu.state_dict().items()})
    B, S, n_dec = 6, 333, 4
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)))
    n0 = k3_ops.launches
    lg, cache_g = prefill(gpu, tokens)
    check(k3_ops.launches == n0 + cfg.n_layers, "lm parity: K3 not launched per layer")
    lc, cache_c = prefill(cpu, tokens)
    decided, tied = greedy_check("lm parity prefill", lg, lc)
    worst = float((lg.float().cpu() - lc).abs().max())
    # control: the same weights through K3 with a window that hides the
    # first 16 keys from the last query, a mask fault LM_TOL must reject
    bad = TransformerLM(dataclasses.replace(cfg, sliding_window=S - 16), device=DEVICE,
                        init=False)
    bad.load_state_dict(gpu.state_dict())
    lb, _ = prefill(bad, tokens)
    ctrl = float(((lb.float().cpu() - lc).abs().amax(-1) / lc.abs().amax(-1)).max())
    sound = float(((lg.float().cpu() - lc).abs().amax(-1) / lc.abs().amax(-1)).max())
    log(f"lm parity prefill: largest error / row scale {sound!r}; control with a "
        f"window of {S - 16}: {ctrl!r} (tolerance {LM_TOL})")
    check(ctrl > LM_TOL, f"lm parity: the windowed control ({ctrl!r}) within {LM_TOL}")
    del bad, lb
    for step in range(n_dec):
        # both sides take the cuda run's greedy token, so their contexts match
        tok = lg.argmax(-1).cpu()
        pos = torch.full((B,), S + step, dtype=torch.int64)
        lg, cache_g = decode_step(gpu, cache_g, tok, pos)
        lc, cache_c = decode_step(cpu, cache_c, tok, pos)
        d, t = greedy_check(f"lm parity decode {step}", lg, lc)
        decided, tied = decided + d, tied + t
        worst = max(worst, float((lg.float().cpu() - lc).abs().max()))
    check(decided >= LM_MIN_DECIDED,
          f"lm parity: greedy tokens checked on {decided} rows, fewer than {LM_MIN_DECIDED}")
    kerr = float((cache_g.k.float().cpu() - cache_c.k).abs().max())
    log(f"lm parity cuda(bf16, K3) vs cpu(f32): max logit err {worst!r} (tolerance "
        f"{LM_TOL} of each row's largest logit), cache k max err {kerr!r}; greedy "
        f"tokens equal on all {decided} decided rows; {tied} near-tie rows")
    return {"max_logit_err": worst, "prefill_err_over_scale": sound,
            "control_err_over_scale": ctrl, "decided_rows": decided, "tied_rows": tied}


# ---------------------------------------------------------------------------
# phase 8: the LM main path at full width (qwen3-14b, 2 x 8,192 tokens)
# ---------------------------------------------------------------------------


def phase_lm_full(seed: int) -> dict:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as k3_ops
    from repro_torch.models import TransformerLM, decode_step, prefill

    cfg = get_config(LM_ARCH)
    batch, prompt, n_dec = LM_BATCH, LM_PROMPT, LM_DECODE_STEPS
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = TransformerLM(cfg, device=DEVICE,
                          generator=torch.Generator(device=DEVICE).manual_seed(seed))
    sync()
    init_s = time.perf_counter() - t0
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_params} params ({n_bytes / 1e9!r} GB), random init {init_s!r} s")
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (batch, prompt))).to(DEVICE)

    k3_ops.launches = 0
    sync()
    t0 = time.perf_counter()
    logits, cache = prefill(model, tokens)
    sync()
    prefill_s = time.perf_counter() - t0
    check(bool(torch.isfinite(logits).all()), f"{cfg.name} prefill: non-finite logits")
    steps, out_tokens = [], []
    tok = logits.argmax(-1)
    for i in range(n_dec):
        out_tokens.append(tok)
        t0 = time.perf_counter()
        logits, cache = decode_step(model, cache, tok, torch.full(
            (batch,), prompt + i, dtype=torch.int64, device=DEVICE))
        sync()
        steps.append(time.perf_counter() - t0)
        check(bool(torch.isfinite(logits).all()),
              f"{cfg.name} decode step {i}: non-finite logits")
        tok = logits.argmax(-1)
    launches = k3_ops.launches
    check(launches == cfg.n_layers,
          f"{cfg.name}: K3 launched {launches} times, expected {cfg.n_layers} per prefill")
    peak = torch.cuda.max_memory_allocated()
    # the first prefill pays first-call costs (library heuristics, the
    # allocator's growth); time a second one as the warm figure
    t0 = time.perf_counter()
    prefill(model, tokens)
    sync()
    warm_s = time.perf_counter() - t0
    ts = sorted(steps)
    p90 = ts[min(len(ts) - 1, int(0.9 * len(ts)))]
    out = {"prefill_s": prefill_s, "prompt_tokens_per_s": batch * prompt / prefill_s,
           "prefill_warm_s": warm_s, "prompt_tokens_per_s_warm": batch * prompt / warm_s,
           "decode_ms_median": 1e3 * statistics.median(ts), "decode_ms_p90": 1e3 * p90,
           "decode_tokens_per_s": batch / statistics.median(ts),
           "max_memory_allocated_gb": peak / 1e9, "k3_launches": launches,
           "init_s": init_s, "cache_gb": 2 * cache.k.numel() * 2 / 1e9,
           "tokens": torch.stack(out_tokens, 1)[:, :8].tolist()}
    log(f"{cfg.name} main path: " + " ".join(f"{k}={v!r}" for k, v in out.items()))

    # the plain decode attention of one layer over this run's cache, alone
    from repro_torch.models.attention import decode_attention

    G = cfg.n_heads // cfg.n_kv_heads
    q1 = torch.randn((batch, cfg.n_kv_heads, G, cfg.d_head), device=DEVICE,
                     dtype=torch.bfloat16)
    pos1 = torch.full((batch,), prompt + n_dec - 1, dtype=torch.int64, device=DEVICE)
    da_ms = cuda_time_ms(lambda: decode_attention(q1, cache.k[0], cache.v[0], pos1,
                                                  rolling=True))
    da_bound = 1e3 * 2 * cache.k[0].numel() * 2 / HBM_BYTES_PER_S  # k + v read once
    out.update(decode_attention_ms=da_ms, decode_attention_bound_ms=da_bound)
    log(f"{cfg.name} decode_attention (plain, one layer, W={cache.k.shape[2]}): "
        f"{da_ms!r} ms, bound {da_bound!r} ms (bytes); x{cfg.n_layers} layers per step")

    # where a prefill and a decode step spend their device time
    pos = prompt + n_dec
    k3 = {"flash_attention": "flash_fwd_kernel"}
    out["profile_prefill"] = trace(f"{cfg.name} prefill", 1,
                                   lambda: prefill(model, tokens), k3)
    out["profile_decode"] = trace(f"{cfg.name} decode step", 4, lambda: decode_step(
        model, cache, tok, torch.full((batch,), pos, dtype=torch.int64, device=DEVICE)), k3)
    del model, cache, logits
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 9: K4 against its plain versions on the GNN path's matrices
# ---------------------------------------------------------------------------


def k4_bound(nnz: int, F: int, n_src: int, n_out: int) -> tuple[float, str, float]:
    """(least ms, what bounds it, gather floor ms) of K4 over ``nnz``
    entries at width F.  The bound reads each input once (col and val, 8 B
    an entry; row_ptr, 8 B a row; the ``n_src`` rows of x) and writes the
    ``n_out`` output rows once, against 2 * nnz * F FP32 operations; the
    gather floor adds one x row read from memory per entry, what this
    design moves when x does not stay in the 50 MB L2."""
    nbytes = 8 * nnz + 8 * (n_out + 1) + 4 * F * (n_src + n_out)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * nnz * F / FP32_FLOPS_PER_S
    floor = (nbytes + 4 * F * nnz) / HBM_BYTES_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", 1e3 * floor


def k4_case(tag: str, src, dst, val, n_dst: int, n_src: int, F: int, gen,
            timed_run: bool = False, tiles: bool = True) -> dict:
    """K4 on the edges ``src -> dst``: integer-valued weights and x bit for
    bit against ``spmm_rows_ref`` and ``spmm_ref`` and, with ``tiles``,
    K4 over ``rows_from_tiles`` of the same edges' tiles against
    ``block_spmm_ref``; ``val`` (or normal values) with normal x within
    K4_TOL of ``spmm_ref`` and ``spmm_rows_ref``, twice with the same bits;
    with ``timed_run``, device and call times of K4, ``spmm_rows_ref`` and
    ``torch.sparse.mm``, and K4's bound."""
    import torch

    from repro_torch.kernels.gather_segsum import (block_spmm_ref, build_rows, build_tiles,
                                                   gather_segsum, rows_from_tiles, spmm_ref,
                                                   spmm_rows_ref)

    m = src.shape[0]
    ival = torch.randint(-3, 4, (m,), generator=gen, device=DEVICE).float()
    ix = torch.randint(-4, 5, (n_src, F), generator=gen, device=DEVICE).float()
    rows = build_rows(src, dst, ival, n_dst, n_src)
    got = gather_segsum(rows, ix, n_dst)
    sync()
    check(torch.equal(got, spmm_rows_ref(rows, ix)),
          f"K4 {tag} int: not bit-identical to spmm_rows_ref")
    check(torch.equal(got, spmm_ref(src, dst, ival, ix, n_dst)),
          f"K4 {tag} int: not bit-identical to spmm_ref")
    if tiles:
        bt = build_tiles(src, dst, ival, n_dst, n_src)
        tiled = gather_segsum(rows_from_tiles(bt), ix, n_dst)
        plain = block_spmm_ref(bt.tiles, bt.tile_src, bt.tile_dst, bt.first_visit, ix,
                               bt.n_out_blocks)[:n_dst]
        sync()
        check(torch.equal(tiled, plain),
              f"K4 {tag} int: rows of the tiles not bit-identical to block_spmm_ref")
        del bt, tiled, plain
    del rows, got, ix
    if val is None:
        val = torch.randn(m, generator=gen, device=DEVICE)
    x = torch.randn((n_src, F), generator=gen, device=DEVICE)
    rows = build_rows(src, dst, val, n_dst, n_src)
    got = gather_segsum(rows, x, n_dst)
    again = gather_segsum(rows, x, n_dst)
    sync()
    check(torch.equal(got, again), f"K4 {tag}: two runs differ")
    err = compare(f"K4 {tag} vs spmm_ref", [got], [spmm_ref(src, dst, val, x, n_dst)],
                  exact=False, rtol=K4_TOL)
    err = max(err, compare(f"K4 {tag} vs spmm_rows_ref", [got], [spmm_rows_ref(rows, x)],
                           exact=False, rtol=K4_TOL))
    row = {"nnz": m, "F": F, "n_out": n_dst, "n_src": n_src, "max_abs_err": err}
    log(f"K4 {tag} nnz={m} F={F}: int bit-identical to spmm_rows_ref, spmm_ref"
        f"{' and block_spmm_ref (rows of the tiles)' if tiles else ''}; normal "
        f"max_abs_err={err!r} vs spmm_ref and spmm_rows_ref (atol = rtol = {K4_TOL}); "
        f"repeat bit-identical")
    if timed_run:
        with warnings.catch_warnings():  # torch calls its CSR support beta
            warnings.simplefilter("ignore", UserWarning)
            csr = torch.sparse_coo_tensor(
                torch.stack([dst.long(), src.long()]), val, (n_dst, n_src),
                check_invariants=True).coalesce().to_sparse_csr()
        lib_err = max_abs(torch.sparse.mm(csr, x), got)
        ms, call = timed(lambda: gather_segsum(rows, x, n_dst))
        plain, plain_call = timed(lambda: spmm_rows_ref(rows, x), calls=20, reps=10)
        lib, lib_call = timed(lambda: torch.sparse.mm(csr, x))
        bound, by, floor = k4_bound(m, F, n_src, n_dst)
        row.update(ms=ms, call_ms=call, plain_ms=plain, plain_call_ms=plain_call,
                   library_ms=lib, library_call_ms=lib_call, bound_ms=bound, bound_by=by,
                   gather_floor_ms=floor, library_max_abs_err=lib_err)
        log(f"K4 {tag}: kernel {ms!r} ms device ({call!r} ms call), plain {plain!r} ms "
            f"device ({plain_call!r} ms call), torch.sparse.mm {lib!r} ms device "
            f"({lib_call!r} ms call; max abs diff {lib_err!r}), bound {bound!r} ms ({by}), "
            f"gather floor {floor!r} ms; kernel / library (device) {ms / lib!r}")
        del csr
    del rows
    torch.cuda.empty_cache()
    return row


def gcn_graph(shape: str, seed: int, kept: dict):
    """(graph_batch of gcn-cora at ``shape`` on the card, seconds to draw
    it).  The ``ogb_products`` graph (7-8 s to draw) is drawn once and kept
    in ``kept`` until phase 11 takes it out."""
    from repro_torch.configs import GNN_SHAPES, get_config
    from repro_torch.launch.cells import graph_batch

    if shape in kept:
        return kept[shape]
    t0 = time.perf_counter()
    g = graph_batch(get_config(GNN_ARCH), GNN_SHAPES[shape], seed, device=DEVICE)
    sync()
    out = (g, time.perf_counter() - t0)
    if shape == "ogb_products":
        kept[shape] = out
    return out


def phase_k4(seed: int, kept: dict) -> tuple[dict, dict]:
    import torch

    from repro_torch.models.gnn import gcn_edge_weights

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in float32
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    cases = {}
    # the path's matrices: gcn-cora's two directions at both layer widths on
    # the Cora-sized graph; the forward direction at F 16 on the two large
    # graphs, where dense tiles are not built
    for shape in GCN_SHAPES:
        g, _ = gcn_graph(shape, seed, kept)
        ew, _ = gcn_edge_weights(g)
        N = g.node_feat.shape[0]
        src, dst = g.edge_src, g.edge_dst
        del g
        small = shape == "full_graph_sm"
        dirs = (("fwd", src, dst), ("bwd", dst, src)) if small else (("fwd", src, dst),)
        for name, s, d in dirs:
            for F in GCN_WIDTHS if small else GCN_WIDTHS[:1]:
                cases[f"{shape} {name} F={F}"] = k4_case(
                    f"{shape} {name} F={F}", s, d, ew, N, N, F, gen,
                    timed_run=name == "fwd", tiles=small)
        del src, dst, ew
    # tests/test_kernels.py's sweep: ragged n_src, F past 32
    for i, (n_dst, n_src, m, F, s) in enumerate(K4_SWEEP):
        rng = np.random.default_rng(s)
        src = torch.from_numpy(rng.integers(0, n_src, m).astype(np.int32)).to(DEVICE)
        dst = torch.from_numpy(rng.integers(0, n_dst, m).astype(np.int32)).to(DEVICE)
        cases[f"sweep{i}"] = k4_case(f"sweep{i} n_dst={n_dst} n_src={n_src}", src, dst,
                                     None, n_dst, n_src, F, gen)
    head = cases[f"minibatch_lg fwd F={GCN_WIDTHS[0]}"]
    rec = {"max_abs_err": max(c["max_abs_err"] for c in cases.values()),
           **{k: head[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                                   "call_ms", "plain_call_ms", "library_call_ms")}}
    return rec, cases


# ---------------------------------------------------------------------------
# phase 10: the four GNN kinds on cuda against the same weights on cpu
# ---------------------------------------------------------------------------


def gnn_models(cfg, d_feat: int, d_edge: int, seed: int):
    """(cpu, cuda) copies of one GNN whose weights come from a seeded
    generator."""
    import torch

    from repro_torch.models.gnn import GNN

    cpu = GNN(cfg, d_feat, d_edge, device="cpu",
              generator=torch.Generator().manual_seed(seed))
    gpu = GNN(cfg, d_feat, d_edge, device=DEVICE, init=False)
    gpu.load_state_dict(cpu.state_dict())
    return cpu, gpu


def row_rel_err(got, want) -> float:
    """Largest |got - want| over its row's largest |want|."""
    got, want = got.float().cpu(), want.float().cpu()
    scale = want.abs().amax(-1, keepdim=True).clamp(min=1e-6)
    return float(((got - want).abs() / scale).max())


def phase_gnn_parity(seed: int) -> tuple[dict, object]:
    import torch

    from repro_torch.configs import GNN_SHAPES, get_config
    from repro_torch.kernels.gather_segsum import ops as k4_ops
    from repro_torch.launch.cells import graph_batch
    from repro_torch.models.gnn import GraphBatch, gcn_rows

    spec = GNN_SHAPES["full_graph_sm"]
    out, gcn_logits = {}, None
    for arch in GNN_ARCHS:
        cfg = get_config(arch)
        g_cpu = graph_batch(cfg, spec, seed, device="cpu")
        g = GraphBatch(*(t.to(DEVICE) for t in g_cpu))
        cpu, gpu = gnn_models(cfg, g.node_feat.shape[1], g.edge_feat.shape[1] or 4, seed)
        rows = gcn_rows(g) if cfg.kind == "gcn" else None
        n0 = k4_ops.launches
        got = gpu(g, rows)
        sync()
        launches = k4_ops.launches - n0
        t0 = time.perf_counter()
        want = cpu(g_cpu)
        cpu_s = time.perf_counter() - t0
        check(bool(torch.isfinite(got).all()), f"{arch}: non-finite logits on cuda")
        check(launches == (4 if cfg.kind == "gcn" else 0),
              f"{arch}: K4 launched {launches} times in one forward")
        rel = row_rel_err(got, want)
        check(rel <= GNN_TOL, f"{arch} cuda vs cpu: {rel!r} of the row scale, beyond {GNN_TOL}")
        out[arch] = {"nodes": g.node_feat.shape[0], "edges": g.edge_src.shape[0],
                     "triplets": int(g.tri_mask.sum()), "err_over_row_scale": rel,
                     "max_abs_err": max_abs(got.cpu(), want), "cpu_forward_s": cpu_s,
                     "k4_launches": launches}
        log(f"{arch} full width on full_graph_sm, cuda vs cpu: largest error / row scale "
            f"{rel!r} (tolerance {GNN_TOL}); " + " ".join(
                f"{k}={v!r}" for k, v in out[arch].items() if k != "err_over_row_scale"))
        if cfg.kind == "gcn":
            gcn_logits = want
        del g, g_cpu, cpu, gpu, rows, got, want
    torch.cuda.empty_cache()
    return out, gcn_logits


# ---------------------------------------------------------------------------
# phase 11: the GCN path at full width
# ---------------------------------------------------------------------------


def gcn_plain(model, g):
    """``model``'s GCN forward on ``g`` with both aggregations of each layer
    computed by ``spmm_ref`` on the COO edges, so without K4 or rows."""
    import torch.nn.functional as F

    from repro_torch.kernels.gather_segsum import spmm_ref
    from repro_torch.models.gnn import gcn_edge_weights

    p = model.params()
    N = g.node_feat.shape[0]
    ew, inv_sqrt = gcn_edge_weights(g)
    x = g.node_feat
    for i, (w, b) in enumerate(zip(p["w"], p["b"])):
        h = x @ w + b
        agg = spmm_ref(g.edge_src, g.edge_dst, ew, h, N)
        agg = agg + spmm_ref(g.edge_dst, g.edge_src, ew, h, N)
        x = agg + h * (inv_sqrt * inv_sqrt)[:, None]
        if i < len(p["w"]) - 1:
            x = F.relu(x)
    return x


def phase_gcn(seed: int, cpu_logits, kept: dict) -> dict:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.gather_segsum import ops as k4_ops
    from repro_torch.models.gnn import gcn_rows

    cfg = get_config(GNN_ARCH)
    out = {"launches": 0}
    # ogb_products first, so that its graph, kept from phase 9, is gone
    # before the other shapes' peak memory is read
    for shape in ("ogb_products",) + GCN_SHAPES[:-1]:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        g, gen_s = gcn_graph(shape, seed, kept)
        kept.pop(shape, None)
        N, E, F = g.node_feat.shape[0], g.edge_src.shape[0], g.node_feat.shape[1]
        _, model = gnn_models(cfg, F, 4, seed)
        sync()
        t0 = time.perf_counter()
        rows = gcn_rows(g)
        sync()
        build_s = time.perf_counter() - t0
        nnz = sum(r.col.shape[0] for r in (rows.fwd, rows.bwd))
        rows_bytes = sum(t.numel() * t.element_size() for r in (rows.fwd, rows.bwd)
                         for t in (r.row_ptr, r.col, r.val))
        k4_ops.launches = 0
        logits = model(g, rows)
        sync()
        launches = k4_ops.launches
        check(launches == 2 * cfg.n_layers,
              f"gcn {shape}: K4 launched {launches} times, expected {2 * cfg.n_layers}")
        out["launches"] += launches
        check(bool(torch.isfinite(logits).all()), f"gcn {shape}: non-finite logits")
        check(tuple(logits.shape) == (N, cfg.n_classes), f"gcn {shape}: logits {logits.shape}")
        times = []
        for _ in range(GNN_FORWARDS):
            t0 = time.perf_counter()
            model(g, rows)
            sync()
            times.append(time.perf_counter() - t0)
        check(k4_ops.launches == launches * (GNN_FORWARDS + 1), f"gcn {shape}: K4 launches")
        peak = torch.cuda.max_memory_allocated()
        # all four launches (both directions, both widths) against the plain
        # aggregations on the same graph and weights
        plain_rel = row_rel_err(logits, gcn_plain(model, g))
        check(plain_rel <= GNN_TOL, f"gcn {shape}: {plain_rel!r} of the row scale from the "
              f"forward through spmm_ref, beyond {GNN_TOL}")
        med = statistics.median(times)
        row = {"nodes": N, "edges": E, "d_feat": F, "nnz_both_directions": nnz,
               "rows_gb": rows_bytes / 1e9, "graph_s": gen_s, "rows_build_s": build_s,
               "forward_median_s": med, "forward_min_s": min(times), "nodes_per_s": N / med,
               "max_memory_allocated_gb": peak / 1e9, "k4_launches": launches,
               "err_over_row_scale_vs_spmm_ref": plain_rel}
        if cpu_logits is not None and shape == "full_graph_sm":
            row["err_over_row_scale_vs_cpu"] = rel = row_rel_err(logits, cpu_logits)
            check(rel <= GNN_TOL, f"gcn {shape}: {rel!r} of the row scale from the cpu run")
        log(f"gcn-cora {shape} main path: " + " ".join(f"{k}={v!r}" for k, v in row.items()))
        row["profile"] = trace(f"gcn-cora {shape} forward", 3, lambda: model(g, rows),
                               {"gather_segsum": "gather_segsum_kernel"})
        out[shape] = row
        del g, model, rows, logits
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=128,
                    help="Grab4 ticks per engine (>= 32; the first ticks of "
                         "the stream)")
    ap.add_argument("--out", default=None, help="write all results as JSON")
    ap.add_argument("--profile-ticks", type=int, default=8,
                    help="fused Grab4 ticks traced with torch.profiler in "
                         "phase 5 (0 skips it)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs one CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    smi = nvidia_smi()
    log(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # phase 1: build every kernel (one nvcc per source, in parallel)
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"phase 1: built {sorted(libs)} in {time.perf_counter() - t0!r} s")
    for stem, text in sorted(_build.BUILD_LOG.items()):
        for line in text.splitlines():
            if ("registers" in line or "spill" in line or "error" in line
                    or (stem == "flash_attention" and "entry function" in line)):
                log(f"  nvcc[{stem}]: {line.strip()}")
    from repro_torch.kernels.flash_attention import ops as k3_ops

    log("  K3 dynamic shared memory per CTA: " + ", ".join(
        f"D {d}: {k3_ops.smem_bytes(d)} bytes" for d in k3_ops.HEAD_DIMS))

    from repro_torch.graphstore.generators import make_transaction_stream

    t0 = time.perf_counter()
    stream = make_transaction_stream(n=6_023_000, m=27_800_000, seed=0)
    log(f"grab4 stream generated in {time.perf_counter() - t0!r} s")

    rec = phase_kernels({"src": stream.base_src.astype(np.int32),
                         "dst": stream.base_dst.astype(np.int32)})
    log("phase 2: kernels agree with their plain versions")
    phase_parity()
    log("phase 3: service parity cuda==cpu")
    grab = phase_grab(stream, max(args.ticks, 32))
    log("phase 4: grab4 main path ran through both kernels")
    if args.profile_ticks:
        grab["profile"] = phase_profile(stream, args.profile_ticks)
        log("phase 5: profile")

    del stream
    t_lm = time.perf_counter()
    attn, attn_norm = phase_attention(LM_SEED)
    log("phase 6: K3 agrees with its plain versions")
    lm_parity = phase_lm_parity(LM_SEED)
    log("phase 7: LM cuda==cpu within tolerance")
    lm = phase_lm_full(LM_SEED)
    log(f"phase 8: qwen3-14b main path ran through K3; phases 6-8 took "
        f"{time.perf_counter() - t_lm!r} s")

    t_gnn = time.perf_counter()
    kept = {}  # the ogb_products graph, from phase 9 to phase 11
    k4, k4_cases = phase_k4(GNN_SEED, kept)
    log("phase 9: K4 agrees with its plain versions")
    gnn_parity, gcn_cpu_logits = phase_gnn_parity(GNN_SEED)
    log("phase 10: GNN forward cuda==cpu within tolerance")
    gcn = phase_gcn(GNN_SEED, gcn_cpu_logits, kept)
    log(f"phase 11: gcn-cora main path ran through K4; phases 9-11 took "
        f"{time.perf_counter() - t_gnn!r} s")

    for mod in ("jax", "repro"):
        check(mod not in sys.modules, f"{mod} was imported")

    kernels = [
        {"name": "peel_round", "route": "cuda",
         "source": "src/repro_torch/csrc/peel_round.cu",
         "replaces": "src/repro/kernels/peel_round/kernel.py:76",
         "launches": grab["launches"]["peel_round"], "bound_by": "bytes",
         "library_ms": None, **rec["peel_round"]},
        {"name": "frontier_spmv", "route": "cuda",
         "source": "src/repro_torch/csrc/frontier_spmv.cu",
         "replaces": "src/repro/core/peel.py:201",
         "launches": grab["launches"]["frontier_spmv"], "bound_by": "bytes",
         "library_ms": None, **rec["frontier_spmv"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:116",
         "launches": lm["k3_launches"], "bound_by": "operations", **attn},
        {"name": "gather_segsum", "route": "cuda",
         "source": "src/repro_torch/csrc/gather_segsum.cu",
         "replaces": "src/repro/kernels/gather_segsum/kernel.py:72",
         "launches": gcn["launches"], **k4},
    ]
    log(f"kernels: peel_round, frontier_spmv, flash_attention, gather_segsum launches "
        f"{grab['launches']['peel_round']}, {grab['launches']['frontier_spmv']}, "
        f"{lm['k3_launches']}, {gcn['launches']}")
    log(f"total seconds {time.perf_counter() - t_start!r}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": smi, "kernels": kernels, "grab4": grab, "attention": attn_norm,
             "lm_parity": lm_parity,
             "qwen3_14b": lm, "gather_segsum": k4_cases, "gnn_parity": gnn_parity,
             "gcn_cora": gcn}, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
