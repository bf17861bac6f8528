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
3. the port's ``SpadeService`` on ``cuda`` against the same on ``cpu``
   (DG, small stream): reports and final states bit-identical;
4. the main path at full width: the Grab4 stream (6,023,000 vertices,
   ~25.0M base edges), DW, 4096-edge ticks, eps 0.1, max_rounds 20,
   window 64, through the fused engine and the workset engine, with the
   kernels' launch counters set to 0 just before and read just after;
5. a ``torch.profiler`` trace of a few steady-state fused Grab4 ticks:
   device time by kernel and the device's idle share.

The last two lines of standard output are the card's name and power limit
as ``nvidia-smi`` gives them, then ``{"ok": true, "device": {...}}``; the
line before them is the per-kernel JSON record.  Imports nothing of JAX
and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
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
    """Median CUDA-event time of one call of ``fn`` in milliseconds."""
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
            ms = cuda_time_ms(lambda: peel_round(*args))
            plain = cuda_time_ms(lambda: peel_round_ref(*args))
            bound = k1_bound_ms(V, int(want[3].sum()), n_blocks(V, 132 * 8))
            rec["peel_round"].update(ms=ms, plain_ms=plain, bound_ms=bound)
            log(f"K1 peel_round V={V}: kernel {ms!r} ms, plain {plain!r} ms, "
                f"bound {bound!r} ms (bytes)")
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
            ms = cuda_time_ms(lambda: frontier_spmv(*args))
            plain = cuda_time_ms(lambda: frontier_spmv_ref(*args))
            bound = k2_bound_ms(E, V, int(alive.sum()), int(hit.sum()),
                                n_blocks(E, 132 * 16))
            rec["frontier_spmv"].update(ms=ms, plain_ms=plain, bound_ms=bound)
            log(f"K2 frontier_spmv E={E}: kernel {ms!r} ms, plain {plain!r} ms, "
                f"bound {bound!r} ms (bytes)")
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


# ---------------------------------------------------------------------------
# phase 5: where a fused Grab4 tick spends its device time
# ---------------------------------------------------------------------------


def phase_profile(stream, n_ticks: int) -> dict:
    """Trace ``n_ticks`` steady-state fused slide ticks at Grab4 width
    (window of 4 ticks, the same per-tick work as the service's window of
    64) with ``torch.profiler``; report device time by kernel and the
    device's idle share over the traced window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

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
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches:
            state = inc.slide_and_maintain(state, drop, *batch, valid, eps=0.1,
                                           max_rounds=20)
        sync()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = {}
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", 0) or 0
            if us > 0:
                kernels[e.key] = (us, e.count)
    busy = sum(us for us, _ in kernels.values())
    check(busy > 0, "profile: no device time recorded")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    share = lambda tag: sum(us for k, (us, _) in kernels.items() if tag in k) / busy
    out = {"ticks": n_ticks, "wall_ms_per_tick": wall_us / 1e3 / n_ticks,
           "device_busy_ms_per_tick": busy / 1e3 / n_ticks,
           "idle_share": 1.0 - busy / wall_us,
           "peel_round_share": share("peel_round_kernel"),
           "frontier_spmv_share": share("frontier_spmv_kernel"),
           "top": [(k[:90], us / 1e3 / n_ticks, cnt / n_ticks)
                   for k, (us, cnt) in top[:15]]}
    log(f"profile {n_ticks} fused slide ticks: wall {out['wall_ms_per_tick']!r} "
        f"ms/tick, device busy {out['device_busy_ms_per_tick']!r} ms/tick, "
        f"idle share {out['idle_share']!r}; K1 share {out['peel_round_share']!r}, "
        f"K2 share {out['frontier_spmv_share']!r} of device time")
    for k, ms, cnt in out["top"]:
        log(f"  {ms:.4f} ms/tick  {cnt:.1f}x/tick  {k}")
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
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  nvcc[{stem}]: {line.strip()}")

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
    ]
    log(f"kernels: peel_round, frontier_spmv launches "
        f"{grab['launches']['peel_round']}, {grab['launches']['frontier_spmv']}")
    log(f"total seconds {time.perf_counter() - t_start!r}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": smi, "kernels": kernels, "grab4": grab}, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
