#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100 for the
sm_90a kernels).

    python3 chip_smoke.py [--ticks N] [--profile-ticks N] [--out results.json]

Phases (any failure exits non-zero):

1. build the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a; the
   seconds of each source's build) and print the card's name and power
   limit;
2. hold each kernel against its plain PyTorch version on the card at the
   Grab4 shapes of the main path (integer weights: exact; lognormal
   weights: stated rtol) and on one workset bucket shape, and time both;
   every kernel, plain version and library call of phases 2, 5, 6 and 9
   gets a device time (``device_time_ms``: the device kernels of one call
   from ``torch.profiler``, median over back-to-back calls) and a call
   time (``cuda_time_ms``: events around one call).  K1 reads and clears
   its float64 dw and K2's round updates its liveness and dw in place, so
   each timed call starts from the same inputs (restored by copies left
   out of both times); K2 also alone on a dead round;
3. the port's ``SpadeService`` on ``cuda`` against the same on ``cpu``
   (small stream): DG reports and final states bit-identical; DW and FD,
   fused and windowed workset, cuda against cpu and against a second cuda
   run (counts equal, ``final_g`` rtol 1e-5, ``benign_fraction`` rtol
   1e-3; the two cuda runs' final ``w0`` and ``benign_fraction`` bit for
   bit);
4. the main path at full width: the Grab4 stream (6,023,000 vertices,
   ~25.0M base edges), DW, the spade-grab config's tick size, eps and
   max_rounds (4096-edge ticks, 0.1, 20; its capacities, rounded up to 512,
   must hold the stream's vertices and the base graph plus the window),
   window 64, through the fused engine and the workset engine, with the
   kernels' launch counters set to 0 just before and read just after
   (``suffix_init`` twice per tick, the warm peel's prologue and the
   ``w0`` bookkeeping, and twice at start-up, the peel and the state's
   ``w0``);
5. one steady-state fused Grab4 tick with K2's two entries recorded: each
   of its 20 rounds' live, peeled and hit counts, K2 against its plain
   version, its device time and in-place bound; ``suffix_init`` at the
   tick's own inputs against its plain version (integer weights bit for
   bit, three runs the same bits) with device times and bound; the tick's
   K1 and K2 launches timed in turns against float32-atomic variants built
   from the same sources (what the float64 accumulator costs); the tick's
   w0 bookkeeping (one ``suffix_init``, float64 sums rounded once) against
   four float32 scatters, in turns; then a ``torch.profiler`` trace of a few more ticks: device time and
   launches by kernel and the device's idle share;
6. the flash-attention kernel (K3) against its plain versions on the card
   at qwen3-14b's attention shapes (Hq 40, Hkv 8, D 128, bf16, batch 2):
   S 8192 causal, S 4000 (ragged) and a 1024 window at S 4096, elementwise
   and normwise per 64-row band, with controls the check must reject;
   times of K3, of the blocked plain version and of torch's SDPA; and K3's
   SIMT body (what the tensor-core body does not take) at the dense LMs'
   smoke-config shapes (float32, D 16), at qwen3-14b's heads in float32
   (timed, with the plain version and SDPA) and in float16 at D 80 (timed
   beside SDPA in float16, logged);
7. the LM serving path on ``cuda`` (bf16, K3) against the same weights on
   ``cpu`` (float32, plain attention): a 2-layer qwen3-shaped model
   (d_model 1280, 10 heads over 2 kv heads, d_head 128), 6 prompts,
   prefill and 4 decode steps, and a wrongly windowed control; then the
   five LMs' smoke configs (float32, d_head 16; the three dense ones and
   the MoE ``mixtral-8x7b``, with its rolling cache, and ``olmoe-1b-7b``)
   on cuda against cpu: prefill, 3 decode steps, ``forward`` and
   ``lm_loss``, the MoE routing recorded on both devices and held to rule
   1 (:func:`routing_check`: the same experts but on near-ties, which are
   counted and leave their sequence out of the output checks), K3's
   counters set to 0 just before and read just after (one SIMT launch a
   layer per prefill, forward and ``lm_loss``);
8. the LM main path at full width: qwen3-14b (40 layers, d_model 5120,
   random weights from a seeded generator), 2 prompts x 8,192 tokens,
   prefill, 32 greedy decode steps, with K3's launch counter set to 0 just
   before and read just after (40 per prefill, none on the SIMT body);
   then ``torch.profiler``
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
    memory and a ``torch.profiler`` trace;
12. the host plane against the device plane on the card, tick by tick
    (:func:`cross_plane_ticks`): 12a, 16 insert-only ticks of 512 edges
    (FD: 32) on ``make_transaction_stream(n=16_000, m=100_000)``, the
    port's host ``Spade`` through ``InsertBatchEdges`` against
    ``init_state`` + ``insert_and_maintain`` on cuda, for DG and a user
    semantics with a vertex prior (integer amounts: batch weights, live
    edge multiset and ``w0`` bit for bit after every tick) and for DW and
    FD (the rtol of CROSS_RTOL_*); ``best_g`` at most its community's
    density after every tick; a final ``full_refresh`` at least
    ``g_host / (2(1+eps))``; 12b, a window of 2 ticks on a 3,000-vertex
    stream, ``slide_and_maintain`` against ``Spade.DeleteEdge``; 12c,
    ``exact_peel`` on cuda against ``static_peel`` at 3,000 vertices
    (order equal, ``delta`` bit for bit, tied weights included).  The
    kernels' launches in phase 12 are logged apart from the main path's;
13. the edge-sharded engine (``repro_torch.dist``, ``SpadeService(mesh=
    DeviceMesh)``) held against the single-device engine: 13a, world 1 on
    ``nccl`` in this process at Grab4 width (DW, the first 32 ticks, window
    64, fused and predictive workset): the final states bit for bit, the
    same K1/K2/``suffix_init`` launches, one all_reduce a round; then
    fused slide ticks (window 4) timed, traced, and with each all_reduce
    timed; 13b, two spawned ``gloo`` ranks on the one card, Grab4 (the
    stream handed over in a file under ``build/``), 8 ticks, window 4, DG
    bit for bit (the ranks' edge blocks joined included) and DW within
    SHARD_RTOL, bytes exchanged per slide, the all_reduce ms per round,
    and K2's launches in every rank on the vector path (no scalar head
    slot, no unaligned launch, as counted at launch; a control on offset
    views must fail that check); 13c, four ``gloo`` ranks on cuda against
    the same four on cpu on phase 12a's stream, the same K2 check.  Phase 2 also
    holds ``suffix_init``'s float64 mode (what the sharded prologue
    all-reduces) against its plain version.  The kernels' launches in phase
    13 are logged apart from the main path's;
14. the MoE LMs at full width: 14a, K3 at their attention shapes (bf16, D
    128, B 2, S 8192; olmoe-1b-7b's 16 q over 16 kv heads causal, mixtral-
    8x7b's 32 over 8 with its 4096 window) against its plain versions as in
    phase 6, timed beside SDPA; 14b, one layer's ``moe_ffn`` at each
    config's width on 512 tokens, cuda bf16 against cpu float32 on the same
    weights (routing under rule 1, drops counted on both, outputs normwise,
    two cuda runs the same bits); 14c, olmoe-1b-7b at full depth and 14d,
    mixtral-8x7b at 24 of its 32 layers (one card's memory), random weights
    from a seeded generator, phase 8's traffic (2 x 8,192-token prefill,
    K3's counters set to 0 just before and read just after: a tensor-core
    launch a layer, none SIMT; 32 decode steps, mixtral's wrapping its
    rolling 4096-slot cache; ``forward`` and ``lm_loss`` over the prompts),
    the cache's slots held against layer 0's keys recomputed, drops per
    prefill, and ``torch.profiler`` traces of a prefill and four decode
    steps;
15. training (``repro_torch.train``, ``repro_torch.ft``), run right after
    phase 11 so that 15b takes its ogbn-products graph and rows: 15a, three
    train steps on cuda and on cpu from the same weights, held to the CPU
    tests' tolerances: the smoke LMs of qwen3-14b (2 microbatches) and
    olmoe-1b-7b (int8 error-feedback compression, routing under rule 1),
    K3's SIMT body two launches a layer a microbatch (forward and remat
    recomputation), and the four GNN kinds (GCN's K4 8 launches a step);
    15b, gcn-cora trained three steps on ogbn-products (8 K4 launches a
    step, seconds, a trace), and K4's backward against autograd of
    ``spmm_rows_ref`` at ``minibatch_lg``; 15c, K3's Function at the train
    shape (B 1, S 4,096, bf16) against autograd of ``attention_ref``, then
    qwen3-14b at its published widths cut to TRAIN_LM_LAYERS layers, three
    steps on a 4,096-token sequence (K3 launches counted, every leaf
    changed by step 1, ``lr`` against ``cosine_lr``; step seconds,
    tokens/s, share of 989 TFLOP/s, peak memory), a trace of a fourth step
    (K3, the float32 products of the attention backward, the bf16 products
    and the rest by kernel name; the attention backward's ranges), and the
    step's gradient and AdamW update timed apart; 15d, a
    ``CheckpointManager`` round trip on the card (4 steps straight against
    2, save, restore, 2; bit for bit);
16. the rest of ``repro``: 16a, two-tower-retrieval's full config (embed
    256, towers 1024-512-256, 8 user and 4 item fields of 16 lookups,
    61.44 GB of float32 tables from a seeded generator) serving
    ``score_pairs`` at serve_p99 (512 rows) and serve_bulk (262,144 rows,
    serve_p99's among them) and ``retrieval_scores`` over retrieval_cand's
    1,000,448 candidates (top 100): 256 rows of each held to a float64
    recomputation on the card, serve_bulk's repeated rows to serve_p99's,
    the top 100 to the float64 scores, two runs the same bits; ms a call,
    rows/s, peak memory, a trace of a serve_bulk call; the smoke config
    cuda against cpu; 16b, the full widths trained three steps at batch
    16,384 and a TT_TRAIN_VOCAB_DIV-th of each vocabulary (step seconds,
    rows/s, peak memory, every leaf changed by step 1), and the smoke
    config three steps cuda against cpu; 16c, every smoke cell of
    ``all_cells()`` moved to cuda against the same on cpu (MoE routing
    under rule 1; K3's and K4's launches counted), and the two Spade cells
    at the spade-grab capacities, K1, K2 and ``suffix_init`` counted, each
    step twice the same bits; 16d, ``repro_torch.launch.train``'s ``main``
    on cuda, 4 steps straight against 2, a resume and 2, bit for bit.
    Phases 2-14 and 16 run with grad mode off (serving) but where they
    train; phase 15 turns it on.

The last two lines of standard output are the card's name and power limit
as ``nvidia-smi`` gives them, then ``{"ok": true, "device": {...}}``; the
line before them is the per-kernel JSON record.  Imports nothing of JAX
and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path
from types import SimpleNamespace

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published HBM3 rate
# Grab4's sizes, from the spade-grab config (load_grab_config, called by
# main): the vertex and edge capacities rounded up to 512 as the services
# round them (6,023,168 and 27,500,032), the tick size, eps and max_rounds
GRAB_V = GRAB_E = BATCH = EPS = MAX_ROUNDS = None
RTOL = 1e-4  # float sums over millions of lognormal terms in another order
# the service reports that must be equal under float weights (DW, FD):
# tests/test_torch_service.py's DW_EQUAL
DW_EQUAL = ("fraud_recall", "n_ticks", "live_edges", "n_expired_edges",
            "n_workset_ticks", "n_fallback_ticks", "n_predicted_ticks",
            "n_bucket_miss_ticks")
WINDOW = 64
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
# K3's SIMT body (what the tensor-core body does not take), causal:
# (dtype, batch, Hq, Hkv, S, D, window) at the dense LMs' smoke-config
# shapes (float32, d_head 16: the shapes of its path, phase 7), at
# qwen3-14b's heads in float32 (timed) and in float16 at an odd head dim;
# against the float32 plain versions: f32 FFMA vs f32 einsums (1e-4), and
# float16's output rounding (1e-2)
SIMT_CASES = (("float32", 2, 4, 2, 24, 16, None), ("float32", 1, 40, 8, 2048, 128, None),
              ("float16", 1, 8, 2, 1000, 80, 256))
SIMT_TOL = {"float32": 1e-4, "float16": 1e-2}
# the LMs whose smoke configs phase 7 runs on cuda through K3's SIMT body
# against the same weights on cpu
LM_SMOKE_ARCHS = ("qwen3-14b", "internlm2-20b", "deepseek-coder-33b", "mixtral-8x7b",
                  "olmoe-1b-7b")
# phase 7's losses (float32 on both devices) and phase 14b's aux loss
LOSS_RTOL = 1e-4
# MoE routing, rule 1: a token whose top-(K+1) router logits on the cpu hold
# two closer than this may pick another expert on the card (the float32
# router products of the same inputs differ there by float32 rounding);
# such near-ties are counted and logged, and a token routed differently is
# left out of the output checks
ROUTE_MARGIN = 1e-4
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
PROFILE_ATTEMPTS = 5


def log(*args) -> None:
    print(*args, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def sm_clocks() -> str:
    """The card's SM clock, its largest, power draw and temperature, as
    ``nvidia-smi`` reads them now."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60, check=True)
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


def device_time_ms(fn, calls: int = 50, restore=None) -> float:
    """Device time: ``torch.profiler`` over ``calls`` back-to-back calls of
    ``fn`` (after one untraced call), the device kernels (and copies) that
    each call launches summed; the median over the calls in ms, or the mean
    when the calls do not all launch the same number of kernels.
    ``restore``, when given, runs before every call and its copies are left
    out.  A trace that records no device time is taken again, after a
    pause, over twice the calls; after PROFILE_ATTEMPTS such traces the
    run fails: no other clock stands in for the device's."""
    from torch.profiler import ProfilerActivity, profile

    def one():
        if restore is not None:
            restore()
        fn()

    one()
    sync()
    n = calls
    for attempt in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                one()
            sync()
        evs = sorted((e for e in prof.events() if str(e.device_type).endswith("CUDA")
                      and not (restore is not None and "Memcpy" in e.name)),
                     key=lambda e: e.time_range.start)
        us = [e.time_range.elapsed_us() for e in evs]
        if sum(us) > 0:
            break
        log(f"device_time_ms: trace {attempt + 1} ({n} calls) recorded no device time")
        time.sleep(0.2)
        n *= 2
    check(sum(us) > 0, "device_time_ms: no device time recorded")
    per, rest = divmod(len(us), n)
    if rest:
        return sum(us) / n / 1e3
    return statistics.median(sum(us[i * per:(i + 1) * per]) for i in range(n)) / 1e3


def timed(fn, calls: int = 50, reps: int = 20) -> tuple[float, float]:
    """(device ms, call ms) of one call of ``fn``."""
    return device_time_ms(fn, calls), cuda_time_ms(fn, reps=reps)


def in_place_timed(fn, restores, calls: int = 50, reps: int = 20,
                   call_time: bool = True) -> tuple[float, float | None]:
    """(device ms, call ms) of ``fn``, which updates tensors in place, each
    call on the same input: every ``(tensor, source)`` of ``restores`` is
    restored (a device-to-device copy) before every call, and the copies
    are left out of both times."""
    import torch

    def restore():
        for t, t0 in restores:
            t.copy_(t0)

    dev = device_time_ms(fn, calls, restore=restore)
    if not call_time:
        return dev, None
    times = []
    for i in range(reps + 3):
        restore()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        if i >= 3:
            times.append(t0.elapsed_time(t1))
    return dev, statistics.median(times)


def load_grab_config() -> None:
    """Set Grab4's sizes (GRAB_V, GRAB_E, BATCH, EPS, MAX_ROUNDS) from the
    spade-grab config."""
    global GRAB_V, GRAB_E, BATCH, EPS, MAX_ROUNDS
    from repro_torch.configs import get_config

    cfg = get_config("spade-grab")
    GRAB_V = -(-cfg.n_capacity // 512) * 512
    GRAB_E = -(-cfg.e_capacity // 512) * 512
    BATCH, EPS, MAX_ROUNDS = cfg.batch_edges, cfg.eps, cfg.max_rounds


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
    # dw in K2's float64 accumulator
    return (cu(w), cu(a), cu(active), cu(level), cu(dw).double(),
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


def k1_bound_ms(V: int, n_peeled: int, n_dw: int, n_blocks: int) -> float:
    # reads w, level (4 B), the float64 dw (8 B), active (1 B), a only where
    # peeled (4 B); writes w', level' (4 B), active', peeled (1 B), a zero
    # where dw was not 0 (8 B), partials (12 B/block)
    nbytes = (V * (4 + 4 + 8 + 1) + 4 * n_peeled + V * (4 + 4 + 1 + 1) + 8 * n_dw
              + 12 * n_blocks)
    return 1e3 * nbytes / HBM_BYTES_PER_S


def k2_bound_ms(E: int, V: int, n_alive: int, n_hit: int, n_blocks: int) -> float:
    # the out-of-place contract (a fresh alive' a round): reads alive (1
    # B/slot), src+dst of live slots (8 B), c of live slots with a peeled
    # end (4 B), peel once (1 B/vertex); writes alive' (1 B/slot), dw once
    # (4 B/vertex), drop partials (4 B/block)
    nbytes = E + 8 * n_alive + 4 * n_hit + V + E + 4 * V + 4 * n_blocks
    return 1e3 * nbytes / HBM_BYTES_PER_S


def k2_in_place_bound_ms(E: int, n: dict) -> float:
    # the in-place round on this input (``n`` from k2_round): reads alive (1
    # B/slot), src+dst of live slots (8 B), c of hit slots (4 B); writes the
    # hit slots' alive bytes (1 B); reads the peel byte of each distinct end
    # of a live slot once, and adds into the float64 dw of each distinct
    # vertex that takes a contribution (8 B written once); nothing of peel
    # or dw when nothing is live
    nbytes = E + 8 * n["n_alive"] + 5 * n["n_hit"] + n["n_ends"] + 8 * n["n_targets"]
    return 1e3 * nbytes / HBM_BYTES_PER_S


def suffix_init_bound_ms(E: int, V: int) -> float:
    # reads src, dst, c (4 B/slot) and edge_mask (1 B), writes both (1 B);
    # reads live (1 B/vertex) and a (4 B), writes w0 (4 B)
    return 1e3 * (14 * E + 9 * V) / HBM_BYTES_PER_S


def k2_round(args) -> dict:
    """The counts of a K2 input: live slots, peeled vertices, hit slots
    (live, a peeled end), distinct ends of live slots and distinct vertices
    that take a dw contribution."""
    import torch

    s, d, _, alive, peel = args
    ps, pd = alive & peel[s], alive & peel[d]
    ends = torch.zeros_like(peel)
    ends[s[alive]] = True
    ends[d[alive]] = True
    targets = torch.zeros_like(peel)
    targets[d[ps & ~pd]] = True
    targets[s[pd & ~ps]] = True
    return {"n_alive": int(alive.sum()), "n_peeled": int(peel.sum()),
            "n_hit": int((ps | pd).sum()), "n_ends": int(ends.sum()),
            "n_targets": int(targets.sum())}


def k2_acc(peel):
    """A zeroed float64 accumulator for K2's dw, as a peel keeps one."""
    import torch

    return torch.zeros(peel.shape[0], dtype=torch.float64, device=peel.device)


def k2_check(name: str, args, rtol: float, exact: bool) -> float:
    """K2 against its plain version on its own copies of ``alive`` and
    accumulators: dw, drop mass and the updated liveness; returns the max
    abs error."""
    from repro_torch.kernels.frontier_spmv import frontier_spmv, frontier_spmv_ref

    s, d, c, alive, peel = args
    mine, plain = alive.clone(), alive.clone()
    got = frontier_spmv(s, d, c, mine, peel, k2_acc(peel))
    want = frontier_spmv_ref(s, d, c, plain, peel, k2_acc(peel))
    sync()
    return compare(name, (*got, mine), (*want, plain), exact=exact, rtol=rtol)


def phase_kernels(grab) -> dict:
    from repro_torch.kernels.peel_round import peel_round, peel_round_ref
    from repro_torch.kernels._launch import n_blocks

    rec = {"peel_round": {"max_abs_err": 0.0}, "frontier_spmv": {"max_abs_err": 0.0}}
    # K1 at V = 6,023,168 and at a workset vertex bucket, on the float64 dw
    # that K2 hands the round; both versions leave their copy of it zeroed
    for V, tag in ((GRAB_V, "grab4"), (65_536, "bucket")):
        for integer in (True, False):
            args = k1_inputs(V, integer, seed=1 if integer else 2)
            dw0 = args[4]
            mine, plain = dw0.clone(), dw0.clone()
            got = peel_round(*args[:4], mine, *args[5:])
            want = peel_round_ref(*args[:4], plain, *args[5:])
            sync()
            name = f"peel_round[{tag},{'int' if integer else 'lognormal'}]"
            err = compare(name, got, want, exact=integer, rtol=RTOL)
            check(not bool(mine.any()) and not bool(plain.any()), f"{name}: dw not cleared")
            rec["peel_round"]["max_abs_err"] = max(rec["peel_round"]["max_abs_err"], err)
            log(f"K1 peel_round V={V} {'int' if integer else 'lognormal'}: "
                f"{'bit-identical' if integer else f'max_abs_err={err!r} (rtol {RTOL})'}, "
                f"dw left zeroed; peeled={int(want[3].sum())}")
        if tag == "grab4":
            # each call on the same dw, restored by a copy left out of the time
            dw = dw0.clone()
            restores = [(dw, dw0)]
            ms, call = in_place_timed(lambda: peel_round(*args[:4], dw, *args[5:]), restores)
            plain, plain_call = in_place_timed(
                lambda: peel_round_ref(*args[:4], dw, *args[5:]), restores)
            bound = k1_bound_ms(V, int(want[3].sum()), int(dw0.count_nonzero()),
                                n_blocks(V, 132 * 8))
            rec["peel_round"].update(ms=ms, plain_ms=plain, bound_ms=bound, call_ms=call,
                                     plain_call_ms=plain_call)
            log(f"K1 peel_round V={V}: kernel {ms!r} ms device ({call!r} ms call), plain "
                f"{plain!r} ms device ({plain_call!r} ms call), bound {bound!r} ms (bytes; "
                f"{bound / ms!r} of it)")
    # K2 at E = 27,500,032 over the Grab4 base graph, and at a workset bucket
    rng = np.random.default_rng(3)
    small_src = rng.integers(0, 65_536, 240_000).astype(np.int32)
    small_dst = rng.integers(0, 65_536, 240_000).astype(np.int32)
    cases = ((grab["src"], grab["dst"], GRAB_V, GRAB_E, "full", "grab4"),
             (small_src, small_dst, 65_536, 262_144, "workset", "bucket"))
    for src, dst, V, E, pad, tag in cases:
        for integer in (True, False):
            args = k2_inputs(src, dst, V, E, integer, seed=4 if integer else 5, pad=pad)
            name = f"frontier_spmv[{tag},{'int' if integer else 'lognormal'}]"
            err = k2_check(name, args, RTOL, exact=integer)
            rec["frontier_spmv"]["max_abs_err"] = max(rec["frontier_spmv"]["max_abs_err"], err)
            log(f"K2 frontier_spmv E={E} V={V} pad={pad} "
                f"{'int' if integer else 'lognormal'}: dw, drop mass and alive "
                f"{'bit-identical' if integer else f'max_abs_err={err!r} (rtol {RTOL})'}")
        if tag == "grab4":
            rec["frontier_spmv"].update(k2_timings(args, E, V))
            rec["suffix_init_f64"] = suffix_init_f64_check(grab, V, E)
    return rec


def suffix_init_f64_inputs(src, dst, V: int, E: int, integer: bool, seed: int):
    """``suffix_init``'s inputs over phase 2's K2 slots: its liveness as the
    edge mask, 90 % of the vertices live, ``a`` integer or lognormal."""
    import torch

    s, d, c, emask, _ = k2_inputs(src, dst, V, E, integer, seed, pad="full")
    rng = np.random.default_rng(seed + 100)
    live = rng.random(V) < 0.9
    a = (rng.integers(0, 3, V) if integer else rng.lognormal(0.0, 1.0, V)).astype(np.float32)
    return s, d, c, emask, torch.from_numpy(live).to(DEVICE), torch.from_numpy(a).to(DEVICE)


def suffix_init_f64_bound_ms(E: int, V: int) -> float:
    # as suffix_init_bound_ms, but the float64 accumulators written (8 B a
    # vertex) in place of w0 (4 B)
    return 1e3 * (14 * E + 13 * V) / HBM_BYTES_PER_S


def suffix_init_f64_check(grab, V: int, E: int) -> dict:
    """``suffix_init``'s float64 mode (what the edge-sharded peel all-reduces)
    at Grab4 shapes against its plain version: the accumulators, the vertex
    sum and ``both``, bit for bit on integer weights and within RTOL on
    lognormal ones; and ``w0``/``f0`` formed from them as the sharded
    prologue forms them equal to the kernel's own ``w0``/``f0`` bit for bit
    (what makes a world of one repeat the single-device engine).  Device
    and call times of the mode, of the plain version and, in turns, of the
    usual mode."""
    import torch

    from repro_torch.kernels.frontier_spmv import suffix_init, suffix_init_ref

    acc = lambda: torch.empty(V + 1, dtype=torch.float64, device=DEVICE)
    out = {"max_abs_err": 0.0}
    for integer in (True, False):
        args = suffix_init_f64_inputs(grab["src"], grab["dst"], V, E, integer,
                                      seed=6 if integer else 7)
        name = f"suffix_init[f64,{'int' if integer else 'lognormal'}]"
        got = suffix_init(*args, acc=acc())
        want = suffix_init_ref(*args, acc=acc())
        sync()
        err = compare(name, got, want, exact=integer, rtol=RTOL)
        out["max_abs_err"] = max(out["max_abs_err"], err)
        live, a = args[4], args[5]
        w0, f0, both = suffix_init(*args)
        mine = torch.where(live, (a.double() + got[0][:V]).float(), 0.0)
        f_mine = (got[1].double() + got[0][V]).float()
        sync()
        check(torch.equal(mine, w0) and torch.equal(f_mine, f0) and torch.equal(both, got[2]),
              f"{name}: w0/f0 formed from the float64 mode differ from the kernel's")
        log(f"suffix_init float64 mode E={E} V={V} {'int' if integer else 'lognormal'}: "
            f"accumulators, vertex sum and both "
            f"{'bit-identical' if integer else f'max_abs_err={err!r} (rtol {RTOL})'} to the "
            f"plain version; w0 and f0 formed from them equal the kernel's bit for bit")
    buf = acc()
    ms, call = timed(lambda: suffix_init(*args, acc=buf))
    plain = device_time_ms(lambda: suffix_init_ref(*args, acc=buf), calls=10)
    turns = [device_time_ms(fn) for fn in (lambda: suffix_init(*args), lambda: suffix_init(*args, acc=buf),
                                           lambda: suffix_init(*args, acc=buf), lambda: suffix_init(*args))]
    bound = suffix_init_f64_bound_ms(E, V)
    out.update(ms=ms, call_ms=call, plain_ms=plain, bound_ms=bound, turns_usual_f64_ms=turns)
    log(f"suffix_init float64 mode E={E} V={V}: {ms!r} ms device ({call!r} ms call), plain "
        f"{plain!r} ms, bound {bound!r} ms (bytes; {bound / ms!r} of it); in turns usual / "
        f"float64 / float64 / usual {turns!r} ms")
    return out


def k2_timings(args, E: int, V: int) -> dict:
    """K2 on phase 2's round-1-like Grab4 input (lognormal weights): device
    and call times of the kernel and its plain version, each call on the
    same liveness and accumulator; its bounds; and K2 on a dead round (no
    live slot)."""
    import torch

    from repro_torch.kernels.frontier_spmv import frontier_spmv, frontier_spmv_ref
    from repro_torch.kernels._launch import n_blocks

    s, d, c, alive0, peel = args
    alive = alive0.clone()
    n = k2_round(args)
    runs = []
    for _ in range(3):
        alive.copy_(alive0)
        runs.append(frontier_spmv(s, d, c, alive, peel, k2_acc(peel)))
    sync()
    check(all(torch.equal(r[0], runs[0][0]) and torch.equal(r[1], runs[0][1]) for r in runs),
          "K2: three runs on the same input gave different dw or drop mass bits")
    log("K2 lognormal Grab4 input: three runs give the same dw and drop mass bits")
    # as a peel's round runs it: into the peel's accumulator, which holds
    # zeros (restored by a copy, like the liveness)
    acc0 = k2_acc(peel)
    acc = acc0.clone()
    restores = [(alive, alive0), (acc, acc0)]
    ms, call = in_place_timed(lambda: frontier_spmv(s, d, c, alive, peel, acc), restores)
    plain, plain_call = in_place_timed(lambda: frontier_spmv_ref(s, d, c, alive, peel, acc),
                                       restores, calls=10, reps=10)
    bound = k2_in_place_bound_ms(E, n)
    old_bound = k2_bound_ms(E, V, n["n_alive"], n["n_hit"], n_blocks(E, 132 * 16))
    log(f"K2 frontier_spmv E={E}: " + " ".join(f"{k}={v}" for k, v in n.items())
        + f"; kernel {ms!r} ms device ({call!r} ms call), plain {plain!r} ms device "
        f"({plain_call!r} ms call), in-place bound {bound!r} ms (bytes; {bound / ms!r} of "
        f"it), out-of-place bound k2_bound_ms {old_bound!r} ms")
    # a dead round, into a peel's accumulator: nothing live, so nothing
    # changes and nothing needs restoring
    dead = torch.zeros_like(alive0)
    dead_ms = device_time_ms(lambda: frontier_spmv(s, d, c, dead, peel, acc0))
    dead_bound = k2_in_place_bound_ms(E, k2_round((s, d, c, dead, peel)))
    log(f"K2 dead round E={E}: {dead_ms!r} ms device, bound {dead_bound!r} ms (bytes)")
    return {"ms": ms, "plain_ms": plain, "bound_ms": bound, "call_ms": call,
            "plain_call_ms": plain_call, "k2_bound_ms": old_bound, **n,
            "dead_round_ms": dead_ms, "dead_round_bound_ms": dead_bound}


# ---------------------------------------------------------------------------
# phase 3: the service on cuda against the service on cpu
# ---------------------------------------------------------------------------


def phase_parity() -> None:
    import dataclasses

    import torch

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
    # float weights: DW amounts and FD's 1/log degrees.  K2, the prologue
    # and the tick's w0 bookkeeping sum in float64 and round once, the cpu's
    # scatters in float32 in their own order, so the reports are held as
    # tests/test_torch_service.py holds the port against the reference: the
    # counts equal, final_g to rtol 1e-5, benign_fraction to rtol 1e-3; and
    # two cuda runs against each other, w0 and benign_fraction bit for bit
    for sem in ("DW", "FD"):
        for kw in ({}, {"window_ticks": 2, "workset": True}):
            runs, w0 = {}, {}
            for device, i in ((DEVICE, 0), (DEVICE, 1), ("cpu", 0)):
                svc = SpadeService(sem, batch_edges=512, device=device, **kw)
                runs[f"{device}{i}"] = svc.run(stream)
                w0[f"{device}{i}"] = svc.final_state.w0.cpu()
            # the w0 bookkeeping sums in float64 and rounds once: two cuda
            # runs end with the same bits, hence the same benign fraction
            check(torch.equal(w0[f"{DEVICE}0"], w0[f"{DEVICE}1"]),
                  f"service {sem} {kw}: two {DEVICE} runs end with different w0 bits")
            check(runs[f"{DEVICE}0"].benign_fraction == runs[f"{DEVICE}1"].benign_fraction,
                  f"service {sem} {kw}: two {DEVICE} runs give benign_fraction "
                  f"{runs[f'{DEVICE}0'].benign_fraction!r} and "
                  f"{runs[f'{DEVICE}1'].benign_fraction!r}")
            for a, b in ((f"{DEVICE}0", "cpu0"), (f"{DEVICE}1", f"{DEVICE}0")):
                got, want = runs[a], runs[b]
                for f in DW_EQUAL:
                    check(getattr(got, f) == getattr(want, f),
                          f"service {sem} {kw}: {a} vs {b} report.{f} "
                          f"{getattr(got, f)!r} vs {getattr(want, f)!r}")
                for f, rtol in (("final_g", 1e-5), ("benign_fraction", 1e-3)):
                    x, y = getattr(got, f), getattr(want, f)
                    check(abs(x - y) <= rtol * abs(y),
                          f"service {sem} {kw}: {a} vs {b} {f} {x!r} vs {y!r} beyond "
                          f"rtol {rtol}")
            g = [runs[k].final_g for k in (f"{DEVICE}0", f"{DEVICE}1", "cpu0")]
            log(f"service {sem} {kw or 'fused'}: cuda, cuda again and cpu agree "
                f"(counts equal, final_g rtol 1e-5, benign_fraction rtol 1e-3; the two "
                f"cuda runs' w0 and benign_fraction bit for bit); final_g {g!r}")


# ---------------------------------------------------------------------------
# phase 4: the main path at Grab4 width
# ---------------------------------------------------------------------------


def phase_grab(stream, n_ticks: int) -> dict:
    import torch

    from repro_torch.core import peel as peel_mod
    from repro_torch.core.semantics import resolve
    from repro_torch.graphstore.structs import device_graph_from_coo
    from repro_torch.kernels.frontier_spmv import ops as k2_ops
    from repro_torch.kernels.peel_round import ops as k1_ops
    from repro_torch.serve import SpadeService

    cut = cut_stream(stream, n_ticks, BATCH)
    n_inc = cut.inc_src.shape[0]
    n_ticks = -(-n_inc // BATCH)
    m_base = stream.base_src.shape[0]
    n = stream.n_vertices
    e_cap = m_base + (WINDOW + 1) * BATCH
    log(f"grab4: n={n} m_base={m_base} increments={stream.inc_src.shape[0]} "
        f"(this run: {n_ticks} ticks of {BATCH}, window {WINDOW}, eps {EPS}, "
        f"max_rounds {MAX_ROUNDS}: spade-grab's); buffers {GRAB_V} x {GRAB_E}")
    # the stream's Grab4 vertices plus its joining actor, and the base graph
    # plus the window, fit the config's capacities as the buffers round them
    check(n <= GRAB_V, f"grab4: {n} vertices exceed the capacity {GRAB_V}")
    check(e_cap <= GRAB_E, f"grab4: {m_base} base edges + a {WINDOW}-tick window "
          f"({e_cap}) exceed the capacity {GRAB_E}")

    # the start-up bulk peel alone, on the graph the service builds
    sem = resolve("DW")
    base_w, in_deg = sem.seed_base(stream.base_src, stream.base_dst,
                                   stream.base_amt, n)
    g = device_graph_from_coo(n, stream.base_src, stream.base_dst, base_w,
                              n_capacity=-(-n // 512) * 512,
                              e_capacity=-(-e_cap // 512) * 512, device=DEVICE)
    sync()
    t0 = time.perf_counter()
    res = peel_mod.bulk_peel(g, eps=EPS)
    sync()
    startup_s = time.perf_counter() - t0
    startup_rounds = int(res.n_rounds)
    log(f"grab4 start-up bulk_peel: V={g.n_capacity} E={g.e_capacity} "
        f"rounds={startup_rounds} seconds={startup_s!r} "
        f"best_g={float(res.best_g)!r}")
    del g, res

    out = {"startup_rounds": startup_rounds, "startup_seconds": startup_s,
           "configs": {}}
    launches = {"peel_round": 0, "frontier_spmv": 0, "suffix_init": 0}
    for name, kw in (("fused", {}), ("workset", {"workset": True})):
        k1_ops.launches = 0
        k2_ops.launches = 0
        k2_ops.suffix_init_launches = 0
        reads0 = peel_mod.HOST_READS[0]
        svc = SpadeService("DW", batch_edges=BATCH, eps=EPS, max_rounds=MAX_ROUNDS,
                           window_ticks=WINDOW, device=DEVICE, **kw)
        t0 = time.perf_counter()
        rep = svc.run(cut)
        sync()
        wall = time.perf_counter() - t0
        l1, l2, lp = k1_ops.launches, k2_ops.launches, k2_ops.suffix_init_launches
        launches["peel_round"] += l1
        launches["frontier_spmv"] += l2
        launches["suffix_init"] += lp
        ts = sorted(rep.tick_seconds)
        ring = [min(BATCH, n_inc - i * BATCH) for i in range(n_ticks)]
        live_expect = m_base + sum(ring[-WINDOW:])
        check(l1 > 0 and l2 > 0, f"grab4 {name}: a kernel never launched")
        # every peel opens with one suffix_init (the start-up bulk peel and
        # each tick's warm peel, full buffer or workset), each tick's w0
        # bookkeeping is one more, and so is the start-up state's w0
        # (DeviceGraph.peel_weights)
        check(lp == 2 * rep.n_ticks + 2,
              f"grab4 {name}: suffix_init launched {lp} times, expected 2 x {rep.n_ticks} "
              f"ticks + 2 at start-up")
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
            "launches_suffix_init": lp,
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


def trace(name: str, reps: int, fn, shares: dict[str, str | tuple[str, ...]]) -> dict:
    """``torch.profiler`` over ``reps`` calls of ``fn``: wall and device-busy
    ms per call, the device's idle share over the traced window, each
    ``shares`` kernel group's share of device time, ms and launches per
    call (the kernels whose name holds the group's substring, or one of its
    substrings) and the top kernels by device time per call."""
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
            if str(getattr(e, "device_type", "")).endswith("CUDA") and e.key not in ANNOTATIONS:
                us = getattr(e, "self_device_time_total", 0) or 0
                if us > 0:
                    kernels[e.key] = (us, e.count)
        busy = sum(us for us, _ in kernels.values())
        if busy > 0:
            break
        log(f"{name} profile: trace {attempt + 1} recorded no device time")
    check(busy > 0, f"{name} profile: no device time recorded")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    groups = {k: [v for key, v in kernels.items()
                  if any(t in key for t in ((tag,) if isinstance(tag, str) else tag))]
              for k, tag in shares.items()}
    out = {"calls": reps, "wall_ms": wall_us / 1e3 / reps,
           "device_busy_ms": busy / 1e3 / reps, "idle_share": 1.0 - busy / wall_us,
           "shares": {k: sum(us for us, _ in g) / busy for k, g in groups.items()},
           "kernel_ms": {k: sum(us for us, _ in g) / 1e3 / reps for k, g in groups.items()},
           "kernel_launches": {k: sum(n for _, n in g) / reps for k, g in groups.items()},
           "top": [(k[:90], us / 1e3 / reps, cnt / reps) for k, (us, cnt) in top[:15]]}
    log(f"{name} profiled ({reps}x): wall {out['wall_ms']!r} ms, device busy "
        f"{out['device_busy_ms']!r} ms, idle share {out['idle_share']!r}; shares of "
        f"device time {out['shares']!r}; ms per call {out['kernel_ms']!r}, launches "
        f"per call {out['kernel_launches']!r}")
    for k, ms, cnt in out["top"]:
        log(f"  {ms:.4f} ms  {cnt:.1f}x  {k}")
    return out


# ---------------------------------------------------------------------------
# phase 5: where a fused Grab4 tick spends its device time
# ---------------------------------------------------------------------------


def phase_profile(stream, n_ticks: int) -> tuple[dict, dict]:
    """Steady-state fused slide ticks at Grab4 width (window of 4 ticks, the
    same per-tick work as the service's window of 64).  One tick runs with
    K2's two entries recorded (:func:`tick_rounds`); then ``n_ticks`` ticks
    are traced with ``torch.profiler`` (0: none) for device time by kernel
    and the device's idle share.  Returns (the trace, the recorded tick)."""
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
    state = inc.init_state(g, eps=EPS)
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
            state = inc.insert_and_maintain(state, *batch, valid, eps=EPS,
                                            max_rounds=MAX_ROUNDS)
        else:
            state = inc.slide_and_maintain(state, drop, *batch, valid, eps=EPS,
                                           max_rounds=MAX_ROUNDS)
    batches = []
    for t in range(window + 1, window + 2 + n_ticks):
        batch, deg = tick(t, state, deg)
        batches.append(batch)
    ticks = iter(batches)

    def one_tick():
        nonlocal state
        state = inc.slide_and_maintain(state, drop, *next(ticks), valid, eps=EPS,
                                       max_rounds=MAX_ROUNDS)

    cost_w0 = w0_bookkeeping_ms(state, drop, batches[0], valid)
    recorded = tick_rounds(one_tick)
    recorded["w0_bookkeeping"] = cost_w0
    if not n_ticks:
        return {}, recorded
    prof = trace("grab4 fused slide tick", n_ticks, one_tick,
                 {"peel_round": "peel_round_kernel",
                  "frontier_spmv": "frontier_spmv_kernel",
                  "suffix_init": "suffix_init_",
                  "suffix_init_count": "suffix_init_count",
                  "suffix_init_scatter": "suffix_init_scatter",
                  "suffix_init_bins": "suffix_init_bins"})
    return prof, recorded


def w0_bookkeeping_ms(state, drop, batch, valid) -> dict:
    """What a fused slide tick's w0 bookkeeping costs on the device, on a
    Grab4 tick's own inputs: as ``core.incremental._tick_w0`` makes it (the
    dropped ``-c`` and the inserted ``cv`` at both ends by one
    ``suffix_init`` over those lanes: float64 sums, rounded once) and as it
    was made before it gave the same bits every run (four float32
    scatter-adds through ``scatter_drop``), device times in turns (package,
    float32, float32, package); the package's result is first held against
    the float32 one (RTOL)."""
    import torch

    from repro_torch.core import incremental as inc
    from repro_torch.graphstore.structs import scatter_drop

    src, dst, c = batch
    bk = inc._slide_prologue(state, drop, src, dst, valid)
    g0, w0 = state.graph, state.w0

    def package():
        return inc._tick_w0(state, bk, src, dst, c, valid, True, 0)

    def float32_scatters():
        cv = torch.where(valid, c.to(torch.float32), 0.0)
        w = scatter_drop(w0, g0.src, None, -bk.cd, accumulate=True)
        w = scatter_drop(w, g0.dst, None, -bk.cd, accumulate=True)
        w = scatter_drop(w, src, None, cv, accumulate=True)
        return scatter_drop(w, dst, None, cv, accumulate=True)

    compare("w0 bookkeeping, package vs float32 scatters", (package(),),
            (float32_scatters(),), exact=False, rtol=RTOL)
    times = {"package": [], "float32_scatters": []}
    for kind in ("package", "float32_scatters", "float32_scatters", "package"):
        fn = package if kind == "package" else float32_scatters
        times[kind].append(device_time_ms(fn, calls=20))
    cost = statistics.mean(times["package"]) - statistics.mean(times["float32_scatters"])
    log(f"w0 bookkeeping of a fused Grab4 tick (E={g0.e_capacity}, V={w0.shape[0]}, dropped "
        f"{int(bk.dropped.sum())}), in turns: package (one suffix_init, float64, rounded once) "
        f"{times['package']!r} ms, four float32 scatters {times['float32_scatters']!r} ms "
        f"device; the repair costs {cost!r} ms a tick")
    return {**times, "cost_ms_per_tick": cost}


def tick_rounds(one_tick) -> dict:
    """Run one fused Grab4 tick with recording wrappers installed around
    ``repro_torch.core.peel``'s ``frontier_spmv``, ``peel_round`` and
    ``suffix_init`` (the package is unchanged; the wrappers are removed
    after the tick), keeping each round's K2 and K1 inputs and the
    prologue's.  Then: each round's counts (:func:`k2_round`), K2 against
    its plain version on it, K2's device time, its in-place bound and its
    share of it; :func:`accumulator_cost_ms` on the tick; and
    ``suffix_init`` at the tick's own inputs against its plain version (the
    tick's DW weights within RTOL, integer weights on the same edges and
    live set bit for bit), with device and call times."""
    import torch

    from repro_torch.core import peel as peel_mod
    from repro_torch.kernels.frontier_spmv import frontier_spmv, suffix_init, suffix_init_ref

    rounds, prologue, k1_rounds = [], [], []
    real_k2, real_si, real_k1 = peel_mod.frontier_spmv, peel_mod.suffix_init, peel_mod.peel_round

    def rec_k2(src, dst, c, alive, peel, dw):
        rounds.append((src, dst, c, alive.clone(), peel.clone()))
        return real_k2(src, dst, c, alive, peel, dw)

    def rec_si(src, dst, c, emask, live, a):
        prologue.append((src, dst, c, emask, live.clone(), a))
        return real_si(src, dst, c, emask, live, a)

    def rec_k1(w, a, active, level, dw, thresh, round_):
        k1_rounds.append((w, a, active, level, dw.clone(), thresh, round_))
        return real_k1(w, a, active, level, dw, thresh, round_)

    peel_mod.frontier_spmv, peel_mod.suffix_init, peel_mod.peel_round = rec_k2, rec_si, rec_k1
    try:
        one_tick()
        sync()
    finally:
        peel_mod.frontier_spmv, peel_mod.suffix_init = real_k2, real_si
        peel_mod.peel_round = real_k1
    check(len(rounds) == 20 and len(prologue) == 1 and len(k1_rounds) == 20,
          f"tick rounds: recorded {len(rounds)} rounds and {len(prologue)} prologues")
    E, V = rounds[0][0].shape[0], rounds[0][4].shape[0]
    acc0 = k2_acc(rounds[0][4])  # the peel's accumulator
    acc = acc0.clone()
    per_round, err = [], 0.0
    for r, args in enumerate(rounds):
        s, d, c, alive0, peel = args
        n = k2_round(args)
        err = max(err, k2_check(f"K2 tick round {r}", args, RTOL, exact=False))
        alive = alive0.clone()
        ms = in_place_timed(lambda: frontier_spmv(s, d, c, alive, peel, acc),
                            [(alive, alive0), (acc, acc0)], calls=20, call_time=False)[0]
        bound = k2_in_place_bound_ms(E, n)
        per_round.append({**n, "ms": ms, "bound_ms": bound, "share": bound / ms})
        log(f"K2 tick round {r:2d}: " + " ".join(f"{k}={v}" for k, v in n.items())
            + f" kernel {ms!r} ms device, in-place bound {bound!r} ms, share {bound / ms!r}")
    total, total_bound = sum(x["ms"] for x in per_round), sum(x["bound_ms"] for x in per_round)
    log(f"K2 tick rounds (E={E}, V={V}): {total!r} ms device over 20 rounds, bound "
        f"{total_bound!r} ms, share {total_bound / total!r}; max_abs_err vs plain "
        f"{err!r} (rtol {RTOL})")
    cost = accumulator_cost_ms(rounds, k1_rounds)
    del rounds, k1_rounds

    src, dst, c, emask, live, a = prologue[0]
    si = {"max_abs_err": compare("suffix_init[grab4 tick]", suffix_init(*prologue[0]),
                                 suffix_init_ref(*prologue[0]), exact=False, rtol=RTOL)}
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    c_int = (torch.rand(E, generator=gen, device=DEVICE) < 0.25).float()
    a_int = torch.randint(0, 2, (V,), generator=gen, device=DEVICE).float()
    ints = (src, dst, c_int, emask, live, a_int)
    want = suffix_init_ref(*ints)
    # every sum of the integer case stays below 2^24: exact in any order
    check(float(want[1]) < 2 ** 24, f"suffix_init int: f0 {float(want[1])!r} >= 2^24")
    compare("suffix_init[grab4 tick, int]", suffix_init(*ints), want, exact=True)
    first = suffix_init(*prologue[0])
    for _ in range(2):
        compare("suffix_init[grab4 tick] run to run", suffix_init(*prologue[0]), first, exact=True)
    n_live, n_both = int(live.sum()), int(want[2].sum())
    ms, call = timed(lambda: suffix_init(*prologue[0]))
    plain, plain_call = timed(lambda: suffix_init_ref(*prologue[0]), calls=10, reps=10)
    bound = suffix_init_bound_ms(E, V)
    si.update(ms=ms, plain_ms=plain, bound_ms=bound, call_ms=call, plain_call_ms=plain_call,
              n_live=n_live, n_both=n_both)
    log(f"suffix_init grab4 tick (E={E}, V={V}, live {n_live}, induced edges {n_both}): "
        f"int bit-identical, DW max_abs_err {si['max_abs_err']!r} (rtol {RTOL}), three runs "
        f"the same bits; kernel "
        f"{ms!r} ms device ({call!r} ms call), plain {plain!r} ms device ({plain_call!r} ms "
        f"call), bound {bound!r} ms (bytes; {bound / ms!r} of it)")
    return {"rounds": per_round, "k2_tick_ms": total, "k2_tick_bound_ms": total_bound,
            "accumulator_cost": cost, "k2_max_abs_err": err, "suffix_init": si}


def float32_variants() -> dict:
    """Libraries of ``csrc/peel_round.cu`` and ``csrc/frontier_spmv.cu``
    with their float64 accumulator made float32 (every ``double`` of the
    source read as ``float``): the same kernels with float32 atomics, built
    here for :func:`accumulator_cost_ms` only, one ``nvcc`` each, in
    parallel."""
    import ctypes
    import re

    from repro_torch.kernels import _build

    out_dir = _build.BUILD_DIR / "float32_accumulator"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for stem in ("peel_round", "frontier_spmv"):
        src = out_dir / f"{stem}.cu"
        text = (_build.CSRC / f"{stem}.cu").read_text()
        src.write_text(re.sub(r"\bdouble\b", "float", text))
        procs[stem] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
             str(out_dir / f"lib{stem}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for stem, proc in procs.items():
        text, _ = proc.communicate()
        check(proc.returncode == 0, f"float32 variant of {stem}.cu: nvcc failed\n{text}")
        libs[stem] = ctypes.CDLL(str(out_dir / f"lib{stem}.so"))
    return libs


def accumulator_cost_ms(rounds, k1_rounds) -> dict:
    """What the float64 accumulator costs one fused Grab4 tick: each of the
    tick's 20 K1 and K2 launches as the package runs them and with float32
    atomics (:func:`float32_variants`), device times in turns on the tick's
    own inputs (float64, float32, float32, float64).  The float32 K1 reads a
    float32 dw and clears it, the float32 K2 adds into a zeroed float32 dw.
    Each variant is first held against the plain versions (RTOL).  The
    prologue is not compared: its float64 sums live in shared memory, with
    no global atomic for float32 ones to replace."""
    import ctypes

    import torch

    from repro_torch.kernels import _launch
    from repro_torch.kernels.frontier_spmv import ops as k2_ops
    from repro_torch.kernels.frontier_spmv import frontier_spmv, frontier_spmv_ref
    from repro_torch.kernels.peel_round import peel_round, peel_round_ref

    t0 = time.perf_counter()
    libs = float32_variants()
    log(f"accumulator cost: float32 variants built in {time.perf_counter() - t0!r} s")
    P, I64 = ctypes.c_void_p, ctypes.c_int64
    k1_32 = libs["peel_round"].peel_round_launch
    k1_32.argtypes = [P] * 12 + [I64, ctypes.c_int, P]
    k2_32 = libs["frontier_spmv"].frontier_spmv_launch
    k2_32.argtypes = [P] * 9 + [I64] * 3 + [ctypes.c_int, P]
    stream = _launch.stream_ptr(torch.device(DEVICE))
    ticket = torch.zeros(1, dtype=torch.int32, device=DEVICE)
    cap = k2_ops._CAP

    def k1_f32(w, a, active, level, dw, thresh, round_):
        V = w.shape[0]
        outs = [torch.empty_like(w), torch.empty_like(active), torch.empty_like(level),
                torch.empty_like(active)]
        nb = _launch.n_blocks(V, 132 * 8)
        partials = torch.empty((nb, 3), dtype=torch.float32, device=DEVICE)
        _launch.check(k1_32(w.data_ptr(), a.data_ptr(), active.data_ptr(), level.data_ptr(),
                            dw.data_ptr(), thresh.data_ptr(), round_.data_ptr(),
                            *(o.data_ptr() for o in outs), partials.data_ptr(), V, nb,
                            stream), "float32 peel_round")
        return (*outs, partials.sum(0))

    def k2_f32(src, dst, c, alive, peel, dw):
        E = src.shape[0]
        drop = torch.empty((), dtype=torch.float32, device=DEVICE)
        partials = torch.empty(cap, dtype=torch.float32, device=DEVICE)
        head, n_groups = k2_ops._vector_split(E, alive.data_ptr(), src.data_ptr(),
                                              dst.data_ptr())
        _launch.check(k2_32(src.data_ptr(), dst.data_ptr(), c.data_ptr(), alive.data_ptr(),
                            peel.data_ptr(), dw.data_ptr(), partials.data_ptr(),
                            ticket.data_ptr(), drop.data_ptr(), E, head, n_groups, cap,
                            stream), "float32 frontier_spmv")
        return dw, drop

    # the variants compute the same functions
    s, d, c, alive, peel = rounds[0]
    a32 = alive.clone()
    got = k2_f32(s, d, c, a32, peel, torch.zeros(peel.shape[0], device=DEVICE))
    a_ref = alive.clone()
    want = frontier_spmv_ref(s, d, c, a_ref, peel, k2_acc(peel))
    compare("float32 frontier_spmv", (got[0].double(), got[1], a32), (*want, a_ref),
            exact=False, rtol=RTOL)
    w, a, act, lev, dw0, th, r = k1_rounds[0]
    compare("float32 peel_round", k1_f32(w, a, act, lev, dw0.float(), th, r),
            peel_round_ref(w, a, act, lev, dw0.clone(), th, r), exact=False, rtol=RTOL)

    times = {k: {"float64": [], "float32": []} for k in ("frontier_spmv", "peel_round")}
    for order in (("float64", "float32"), ("float32", "float64")):
        for kind in order:
            k2_total = k1_total = 0.0
            for (s, d, c, alive0, peel), (w, a, act, lev, dw0, th, r) in zip(rounds, k1_rounds):
                alive = alive0.clone()
                acc0 = torch.zeros(peel.shape[0], device=DEVICE,
                                   dtype=torch.float64 if kind == "float64" else torch.float32)
                acc = acc0.clone()
                k2 = frontier_spmv if kind == "float64" else k2_f32
                k2_total += in_place_timed(lambda: k2(s, d, c, alive, peel, acc),
                                           [(alive, alive0), (acc, acc0)], calls=20,
                                           call_time=False)[0]
                dws = dw0 if kind == "float64" else dw0.float()
                dw = dws.clone()
                k1 = peel_round if kind == "float64" else k1_f32
                k1_total += in_place_timed(lambda: k1(w, a, act, lev, dw, th, r),
                                           [(dw, dws)], calls=20, call_time=False)[0]
            times["frontier_spmv"][kind].append(k2_total)
            times["peel_round"][kind].append(k1_total)
    out = {}
    for k, v in times.items():
        f64, f32 = statistics.mean(v["float64"]), statistics.mean(v["float32"])
        out[k] = {"float64_ms": v["float64"], "float32_ms": v["float32"],
                  "cost_ms_per_tick": f64 - f32}
        log(f"accumulator cost, {k} per tick: float64 {v['float64']!r} ms, float32 atomics "
            f"{v['float32']!r} ms device (in turns); float64 costs {f64 - f32!r} ms a tick")
    out["total_cost_ms_per_tick"] = sum(out[k]["cost_ms_per_tick"] for k in times)
    log(f"accumulator cost: {out['total_cost_ms_per_tick']!r} ms device a tick in all")
    return out


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


def attention_p_rounded(q, k, v, p_dtype, window=None):
    """Dense causal (windowed) attention of q [B, G, S, D] over one kv head
    k/v [B, 1, S, D] in float32, with the unnormalised P = exp(s - m)
    rounded to ``p_dtype`` before P V and l summed in float32: what K3 does
    with bf16, and a control with a coarser type."""
    import torch

    S, D = q.shape[2], q.shape[3]
    s = torch.einsum("bgqd,bkd->bgqk", q.float(), k[:, 0].float()) / D ** 0.5
    masked = torch.ones(S, S, dtype=torch.bool, device=q.device).triu_(1)
    if window is not None:
        masked |= torch.ones(S, S, dtype=torch.bool, device=q.device).tril_(-window)
    s.masked_fill_(masked, -1e30)
    p = s.sub_(s.amax(-1, keepdim=True)).exp_()
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bgqk,bkd->bgqd", p.to(p_dtype).float(), v[:, 0].float()) / l
    return o.to(q.dtype)


def attn_controls(q, k, v, got, G: int, window=None) -> dict:
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
        want = attention_ref(qj, kj, vj, causal=True, window=window)
        late = want.clone()
        late[:, :, S // 2:] = (late[:, :, S // 2:].float() / 1.05).to(late.dtype)
        cands = {"K3": got[:, j * G:(j + 1) * G],
                 "P bf16": attention_p_rounded(qj, kj, vj, torch.bfloat16, window),
                 "P fp8": attention_p_rounded(qj, kj, vj, torch.float8_e4m3fn, window),
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


def k3_simt_bound_ms(B, Hq, Hkv, S, D, window, itemsize) -> tuple[float, str]:
    """K3's SIMT body: f32 FFMA at the FP32 rate, q, k, v and o once each."""
    flops = 4 * B * Hq * D * attn_pairs(S, window)
    nbytes = itemsize * (2 * B * Hq * S * D + 2 * B * Hkv * S * D)
    t_ops, t_bytes = flops / FP32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def phase_attention_simt(seed: int) -> dict:
    """K3's SIMT body against its plain versions at SIMT_CASES (elementwise,
    |err| <= SIMT_TOL * (1 + |want|)); device and call times of the kernel,
    of the blocked plain version and of SDPA at the timed case."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (attention_ref, flash_attention,
                                                     flash_attention_ref)
    from repro_torch.kernels.flash_attention import ops as k3_ops

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    rec = {"max_abs_err": 0.0}
    for dtype, B, Hq, Hkv, S, D, window in SIMT_CASES:
        dt = getattr(torch, dtype)
        # the model layout: q [B, S, Hq, D], k/v [B, S, Hkv, D], read as views
        q, k, v = (torch.randn((B, S, h, D), generator=gen, device=DEVICE).to(dt)
                   .permute(0, 2, 1, 3) for h in (Hq, Hkv, Hkv))
        n0 = k3_ops.launches
        got = flash_attention(q, k, v, causal=True, window=window)
        sync()
        check(k3_ops.launches == n0, "K3 SIMT case ran on the tensor-core body")
        tag = f"K3 SIMT {dtype} B={B} Hq={Hq} Hkv={Hkv} S={S} D={D} window={window}"
        err = 0.0
        for want in (flash_attention_ref(q, k, v, causal=True, window=window),
                     attention_ref(q, k, v, causal=True, window=window)):
            diff = (got.float() - want.float()).abs()
            err = max(err, float(diff.max()))
            check(bool((diff <= SIMT_TOL[dtype] * (1 + want.float().abs())).all()),
                  f"{tag}: max abs err {float(diff.max())!r} beyond {SIMT_TOL[dtype]}")
        check(torch.equal(flash_attention(q, k, v, causal=True, window=window), got),
              f"{tag}: two launches gave different bits")
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        log(f"{tag}: max_abs_err={err!r} vs flash_attention_ref and attention_ref "
            f"(atol = rtol = {SIMT_TOL[dtype]}); two launches the same bits")
        if (dtype, S) == ("float32", 2048):
            ms, call = timed(lambda: flash_attention(q, k, v), calls=10, reps=10)
            plain, plain_call = timed(lambda: flash_attention_ref(q, k, v), calls=3, reps=3)
            lib, lib_call = timed(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), calls=10, reps=10)
            bound, by = k3_simt_bound_ms(B, Hq, Hkv, S, D, window, q.element_size())
            tflops = 4 * B * Hq * D * attn_pairs(S, window) / ms / 1e9
            rec.update(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by,
                       call_ms=call, plain_call_ms=plain_call, library_call_ms=lib_call,
                       timed_case=tag, tflops=tflops)
            log(f"{tag}: kernel {ms!r} ms device ({call!r} ms call; {tflops!r} TFLOP/s, "
                f"{ms / lib!r}x sdpa, {bound / ms!r} of the bound), plain {plain!r} ms device "
                f"({plain_call!r} ms call), sdpa {lib!r} ms device ({lib_call!r} ms call), "
                f"bound {bound!r} ms ({by})")
        if dtype == "float16":
            # logged, not a gate: the SIMT body against SDPA in float16 on the
            # same tensors (the library reaches the tensor cores on 16-bit data)
            ok = torch.ones(S, S, dtype=torch.bool, device=DEVICE).tril()
            if window is not None:
                ok &= ~torch.ones(S, S, dtype=torch.bool, device=DEVICE).tril(-window)
            sdpa = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=ok,
                                                          enable_gqa=True)
            diff = float((sdpa().float() - got.float()).abs().max())
            ms16 = device_time_ms(lambda: flash_attention(q, k, v, causal=True, window=window),
                                  calls=10)
            lib16 = device_time_ms(sdpa, calls=10)
            bound16, by16 = k3_simt_bound_ms(B, Hq, Hkv, S, D, window, q.element_size())
            rec["float16_case"] = {"case": tag, "ms": ms16, "library_ms": lib16,
                                   "bound_ms": bound16, "bound_by": by16,
                                   "sdpa_max_abs_diff": diff}
            log(f"{tag}: kernel {ms16!r} ms device, sdpa (float16, boolean mask) {lib16!r} ms "
                f"device ({ms16 / lib16!r}x), bound {bound16!r} ms ({by16}); sdpa's output "
                f"within {diff!r} of the kernel's (logged, not a gate)")
        del q, k, v, got
    torch.cuda.empty_cache()
    return rec


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
    del gpu, cpu, cache_g, cache_c
    return {"max_logit_err": worst, "prefill_err_over_scale": sound,
            "control_err_over_scale": ctrl, "decided_rows": decided, "tied_rows": tied,
            "smoke_configs": lm_smoke_parity(seed)}


@contextlib.contextmanager
def routing_recorded(rec: list):
    """Inside, every MoE FFN call of the port's transformer first appends
    the :class:`~repro_torch.models.moe.Routing` of its input to ``rec``
    (routed once more, for the record: keep it out of timed runs)."""
    from repro_torch.models import transformer as ttf
    from repro_torch.models.moe import moe_route

    ffn = ttf.moe_ffn

    def recorded(x, router, w_gate, w_up, w_down, spec):
        rec.append(moe_route(x, router, spec))
        return ffn(x, router, w_gate, w_up, w_down, spec)

    ttf.moe_ffn = recorded
    try:
        yield rec
    finally:
        ttf.moe_ffn = ffn


def near_ties(logits, K: int):
    """Tokens whose top-(K+1) router logits [T, E] hold two closer than
    ROUTE_MARGIN (a bool tensor on the logits' device)."""
    top = logits.float().topk(K + 1, dim=-1).values
    return (top[:, :-1] - top[:, 1:]).amin(dim=-1) < ROUTE_MARGIN


def routing_check(name: str, got: list, want: list, n_rows: int) -> dict:
    """Rule 1 on recorded routings of the same calls on two devices (``want``
    the cpu's): ``topi`` equal on every token but near-ties of ``want``'s
    logits; the keep masks equal when every token is routed alike.  Returns
    the counts and ``rows``, the sequences (of ``n_rows`` in the flat token
    order) holding a token routed differently; clears both lists."""
    import torch

    check(len(got) == len(want) > 0, f"{name}: {len(got)} vs {len(want)} MoE calls recorded")
    out = {"near_ties": 0, "rerouted": 0, "dropped": [0, 0], "rows": set()}
    for i, (g, w) in enumerate(zip(got, want)):
        differ = (g.topi.cpu() != w.topi.cpu()).any(dim=-1)
        ties = near_ties(w.logits, w.topi.shape[1]).cpu()
        check(bool(ties[differ].all()), f"{name} call {i}: topi differs on "
              f"{int((differ & ~ties).sum())} tokens that are not near-ties")
        if not differ.any():
            check(torch.equal(g.keep.cpu(), w.keep.cpu()), f"{name} call {i}: keep masks differ")
        out["near_ties"] += int(ties.sum())
        out["rerouted"] += int(differ.sum())
        out["dropped"][0] += int((~g.keep).sum())
        out["dropped"][1] += int((~w.keep).sum())
        per_row = len(differ) // n_rows
        out["rows"] |= {int(t) // per_row for t in torch.nonzero(differ).flatten()}
    check(out["rerouted"] > 0 or out["dropped"][0] == out["dropped"][1],
          f"{name}: dropped assignments {out['dropped']!r} differ with no token rerouted")
    got.clear()
    want.clear()
    return out


def rows_rel_err(got, want, rows_out=()) -> float:
    """Largest ``max |got - want| / max |want|`` over the last-axis rows of
    logits [B, ..., V], leaving out the batch rows in ``rows_out``."""
    import torch

    keep = [b for b in range(got.shape[0]) if b not in rows_out]
    check(bool(keep), "every sequence was routed differently")
    got, want = got.float().cpu()[keep], want.float().cpu()[keep]
    check(bool(torch.isfinite(got).all()), "non-finite logits")
    return float(((got - want).abs().amax(-1) / want.abs().amax(-1)).max())


def lm_smoke_parity(seed: int) -> dict:
    """The five LMs' smoke configs (float32, d_head 16) on cuda, whose
    attention is K3's SIMT body, against the same weights on cpu: prefill
    of 2 x 24 tokens and 3 decode steps, then ``forward`` and ``lm_loss``
    over the prompts; logits within LM_TOL of each row's largest |logit|,
    loss, NLL and aux loss within LOSS_RTOL.  The MoE configs' routing is
    recorded on both devices and held to rule 1 (:func:`routing_check`); a
    sequence with a token routed differently is left out of what follows.
    K3's counters are set to 0 just before and read just after: one SIMT
    launch a layer per prefill, forward and ``lm_loss``, none on the
    tensor cores."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention import ops as k3_ops
    from repro_torch.models import TransformerLM, decode_step, forward, lm_loss, prefill

    k3_ops.launches = 0
    k3_ops.simt_launches = 0
    out, launches = {}, 0
    for arch in LM_SMOKE_ARCHS:
        cfg = get_smoke_config(arch)
        cpu = TransformerLM(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
        gpu = TransformerLM(cfg, device=DEVICE, init=False)
        gpu.load_state_dict(cpu.state_dict())
        rng = np.random.default_rng(seed)
        B, S = 2, 24
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))
        rec_g, rec_c, routing = [], [], []

        def both(fn, *args):
            """``fn`` on cuda, then on cpu, each routing recorded; the
            sequences rerouted so far are out."""
            with routing_recorded(rec_g):
                g = fn(gpu, *(a.to(DEVICE) for a in args))
            with routing_recorded(rec_c):
                c = fn(cpu, *args)
            if cfg.moe is not None:
                routing.append(routing_check(f"{cfg.name} {fn.__name__}", rec_g, rec_c, B))
            return g, c

        (lg, cache_g), (lc, cache_c) = both(prefill, tokens)
        launches += cfg.n_layers
        worst = 0.0
        for step in range(4):
            rows = set().union(*(r["rows"] for r in routing))
            rel = rows_rel_err(lg, lc, rows)
            check(rel <= LM_TOL, f"{cfg.name} step {step}: {rel!r} of the row scale, "
                  f"beyond {LM_TOL}")
            worst = max(worst, rel)
            if step == 3:
                break
            tok = torch.from_numpy(rng.integers(0, cfg.vocab, B))
            pos = torch.full((B,), S + step, dtype=torch.int64)

            def decode(m, t, p):
                return decode_step(m, cache_g if m is gpu else cache_c, t, p)

            (lg, _), (lc, _) = both(decode, tok, pos)
        # the scoring forward and the loss over the prompts (next tokens)
        routing_prefix = len(routing)
        (fg, ag), (fc, ac) = both(forward, tokens)
        labels = torch.roll(tokens, -1, dims=1)
        (loss_g, parts_g), (loss_c, parts_c) = both(lm_loss, tokens, labels)
        launches += 2 * cfg.n_layers
        rows = set().union(*(r["rows"] for r in routing[routing_prefix:]))
        rel_f = rows_rel_err(fg, fc, rows)
        check(rel_f <= LM_TOL, f"{cfg.name} forward: {rel_f!r} of the row scale, "
              f"beyond {LM_TOL}")
        losses = {"loss": (loss_g, loss_c), "nll": (parts_g["nll"], parts_c["nll"]),
                  "aux": (ag, ac)}
        loss_err = {k: abs(float(g) - float(c)) / max(abs(float(c)), 1e-30)
                    for k, (g, c) in losses.items() if float(c) != 0.0 or float(g) != 0.0}
        if not rows:  # the aux loss and the mean NLL mix every sequence
            check(all(e <= LOSS_RTOL for e in loss_err.values()),
                  f"{cfg.name} lm_loss: relative errors {loss_err!r} beyond {LOSS_RTOL}")
        check(cfg.moe is not None or float(ag) == 0.0, f"{cfg.name}: dense aux {float(ag)!r}")
        out[arch] = {"logits": worst, "forward": rel_f, "loss": float(loss_c),
                     "loss_rel_err": loss_err,
                     "routing": [{k: (sorted(v) if k == "rows" else v) for k, v in r.items()}
                                 for r in routing]}
        ties = sum(r["near_ties"] for r in routing)
        rerouted = sum(r["rerouted"] for r in routing)
        log(f"{cfg.name} cuda (K3 SIMT body, float32) vs cpu: prefill, 3 decode steps, "
            f"forward and lm_loss; largest error / row scale {worst!r} (serving), "
            f"{rel_f!r} (forward), tolerance {LM_TOL}; lm_loss {float(loss_g)!r} vs "
            f"{float(loss_c)!r} (relative errors {loss_err!r}, tolerance {LOSS_RTOL})"
            + (f"; routing over {len(routing)} passes: {ties} near-tie tokens (margin "
               f"{ROUTE_MARGIN}), {rerouted} routed differently, dropped assignments "
               f"cuda/cpu {[sum(r['dropped'][i] for r in routing) for i in (0, 1)]!r}"
               if cfg.moe is not None else ""))
    sync()
    check(k3_ops.simt_launches == launches and k3_ops.launches == 0,
          f"smoke configs: K3 SIMT launched {k3_ops.simt_launches} times, tensor-core "
          f"body {k3_ops.launches}; expected {launches} and 0")
    out["simt_launches"] = k3_ops.simt_launches
    return out


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
    k3_ops.simt_launches = 0
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
    check(k3_ops.simt_launches == 0,
          f"{cfg.name}: {k3_ops.simt_launches} attention calls took K3's SIMT body")
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
           "k3_simt_launches": k3_ops.simt_launches,
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
    # ogb_products first: its graph and rows are then held for phase 15b
    # (``held_for_15b_gb`` of the other shapes' peaks)
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
        if "ogb_products_rows" in kept:  # held for phase 15b, inside the peak above
            g_k, r_k = kept["ogb_products_rows"]
            row["held_for_15b_gb"] = sum(t.numel() * t.element_size() for t in list(g_k) + [
                x for r in (r_k.fwd, r_k.bwd) for x in (r.row_ptr, r.col, r.val)]) / 1e9
        log(f"gcn-cora {shape} main path: " + " ".join(f"{k}={v!r}" for k, v in row.items()))
        row["profile"] = trace(f"gcn-cora {shape} forward", 3, lambda: model(g, rows),
                               {"gather_segsum": "gather_segsum_kernel"})
        out[shape] = row
        if shape == "ogb_products":  # phase 15b trains on this graph
            kept["ogb_products_rows"] = (g, rows)
        del g, model, rows, logits
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 12: the host plane against the device plane, tick by tick
# ---------------------------------------------------------------------------

# 12a: insert-only ticks on the stream size that paper_tables' edge-grouping
# benchmark serves through the host plane (16,000 vertices, ~93,000 base
# edges); FD's host inserts go one edge a call (cross_plane_ticks), ~55 ms
# each at this size on a CPU, so its ticks are smaller; 12b: a window of 2
# ticks whose expiry the host makes through DeleteEdge (up to several
# seconds a deletion at this size on a CPU, so few and small ticks); 12c:
# exact_peel at 3,000 vertices
CROSS_INSERT = {"n": 16_000, "m": 100_000, "batch": 512, "fd_batch": 32, "ticks": 16,
                "seed": 3}
CROSS_WINDOW = {"n": 3_000, "m": 15_000, "batch": 8, "ticks": 8, "window": 2, "seed": 5}
CROSS_EXACT = {"n": 3_000, "m": 15_000, "seed": 6}
# tolerances on lognormal weights (DW, FD): the device weighs a tick in
# float32, the host funnel in float64 snapped to 2^-30 (one float32 rounding
# and FD's float32 log: rtol 1e-6); the device's w0 and best_g carry a
# float32 rounding per tick (rtol 1e-5).  Integer weights: bit for bit, and
# best_g (f / |S| rounded once to float32) within rtol 2^-23 of the exact
# density
CROSS_RTOL_W = 1e-6
CROSS_RTOL_ACC = 1e-5
CROSS_RTOL_INT = 2.0 ** -23


def parity_semantics():
    """A user semantics that is not DG/DW/FD: an odd src + dst doubles the
    amount, the vertex prior is id % 3 (tests/test_window_differential.py's
    PARITY_SEM); integer-valued on integer amounts."""
    from repro_torch.core.semantics import SuspSemantics

    return SuspSemantics(
        name="XPARITY",
        esusp=lambda xp, src, dst, raw, deg, aux: raw * (1.0 + (src + dst) % 2),
        vsusp=lambda xp, ids, deg, aux: (ids % 3) * 1.0,
    )


def integer_amounts(stream):
    """The stream with its amounts rounded up to integers: every sum of
    phase 12's integer semantics stays below 2^24, exact in float32."""
    return dataclasses.replace(stream, base_amt=np.ceil(stream.base_amt),
                               inc_amt=np.ceil(stream.inc_amt))


def arrival_in_degree(dst: np.ndarray) -> np.ndarray:
    """The in-degree each edge's destination has just before the edge is
    added, in stream order: what the host funnel's ``esusp`` reads while
    ``Spade.LoadGraph`` adds the base graph edge by edge."""
    order = np.argsort(dst, kind="stable")
    d = dst[order]
    deg = np.empty(dst.shape[0], np.int64)
    deg[order] = np.arange(d.shape[0]) - np.searchsorted(d, d, side="left")
    return deg


def host_base_weights(sem, src, dst, raw) -> np.ndarray:
    """The base graph's edge weights as the host funnel gives them (arrival
    degrees, float64, snapped), in float32.  For a semantics that reads no
    degree these are ``seed_base``'s weights."""
    from repro_torch.core.semantics import _QUANTUM, quantize_susp_array

    w = np.asarray(sem.esusp(np, src, dst, np.asarray(raw, np.float64),
                             arrival_in_degree(dst), None), np.float64)
    w = np.maximum(quantize_susp_array(np.broadcast_to(w, src.shape)), _QUANTUM)
    return w.astype(np.float32)


def cross_close(name: str, got, want, rtol: float) -> float:
    """``got`` equal to ``want`` (rtol 0: bit for bit, after ``want`` is
    rounded to ``got``'s float32) or within ``rtol`` of it; returns the max
    relative error."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    check(got.shape == want.shape, f"{name}: shape {got.shape} vs {want.shape}")
    if not rtol:
        check(np.array_equal(got, want.astype(np.float32).astype(np.float64)),
              f"{name}: not bit-identical")
        return 0.0
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
    err = float(rel.max()) if rel.size else 0.0
    check(err <= rtol, f"{name}: max relative error {err!r} beyond rtol {rtol}")
    return err


def device_edges(state):
    """The device graph's live edges as host arrays, sorted by (src, dst, c)."""
    g = state.graph
    em = g.edge_mask.cpu().numpy()
    s, d, c = (x.cpu().numpy()[em] for x in (g.src, g.dst, g.c))
    o = np.lexsort((c, d, s))
    return s[o].astype(np.int64), d[o].astype(np.int64), c[o].astype(np.float64)


def pair_sums(s, d, c, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Edge weight summed per unordered vertex pair, as ``AdjGraph.adj``
    combines it: (sorted pair keys, float64 sums)."""
    key = np.minimum(s, d) * n + np.maximum(s, d)
    keys, inv = np.unique(key, return_inverse=True)
    return keys, np.bincount(inv, weights=c, minlength=keys.shape[0])


def host_pair_sums(g) -> tuple[np.ndarray, np.ndarray]:
    """The host graph's combined adjacency as (sorted pair keys, sums)."""
    keys, vals = [], []
    for u in range(g.n):
        for v, c in g.adj[u].items():
            if u <= v:
                keys.append(u * g.n + v)
                vals.append(c)
    keys = np.asarray(keys, np.int64)
    o = np.argsort(keys)
    return keys[o], np.asarray(vals, np.float64)[o]


def community_density(state, n: int) -> float:
    """g(S) of the device's own community, from its live edges and priors,
    in float64."""
    comm = state.community.cpu().numpy()[:n]
    size = int(comm.sum())
    check(size > 0, "the device community is empty")
    s, d, c = device_edges(state)
    inside = comm[s] & comm[d]
    a = state.graph.a.cpu().numpy()[:n].astype(np.float64)
    return (a[comm].sum() + c[inside].sum()) / size


def cross_plane_ticks(sem, stream, ticks: int, batch: int, device, eps: float,
                      max_rounds: int, window: int = 0, integer: bool = True,
                      tag: str = "") -> dict:
    """The port's host oracle (``Spade``) and its device plane take the same
    ticks of ``stream``; after every tick: the device batch weights equal
    the host funnel's, the device's live edge multiset equals the host's
    (the base graph and the resident ticks, and the host graph's combined
    adjacency), ``state.w0[:n]`` equals ``peeling_weights_full`` of the host
    graph (bit for bit on integer weights, else within the stated rtol),
    and ``best_g`` is at most the density of the device's own community.
    After the last tick a ``full_refresh`` holds the bulk peel's guarantee
    against ``Spade.Detect``.

    Insert-only (``window = 0``): ``insert_and_maintain``, and the host
    takes each tick through one ``InsertBatchEdges`` (no grouping); for a
    degree-reading semantics one call per edge, since the host funnel reads
    the degree of the graph as it stands and a batch's edges enter it only
    after the whole batch is weighed, while ``batch_weights`` gives each
    edge its arrival degree.  The device graph is seeded with the host
    funnel's base weights (:func:`host_base_weights`).  Windowed: after
    ``window`` ticks each tick is ``slide_and_maintain`` on the device and
    one ``Spade.DeleteEdge`` per expired edge on the host.  Returns the
    counts and the host and device seconds."""
    import torch

    from repro_torch.core import Spade, peeling_weights_full
    from repro_torch.core import incremental as inc
    from repro_torch.graphstore.structs import device_graph_from_coo

    dev = torch.device(device)
    rtol_w = 0.0 if integer else CROSS_RTOL_W
    rtol_acc = 0.0 if integer else CROSS_RTOL_ACC
    rtol_g = CROSS_RTOL_INT if integer else CROSS_RTOL_ACC
    sync_dev = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    n = stream.n_vertices
    src, dst, raw = stream.base_src, stream.base_dst, stream.base_amt
    m_base = src.shape[0]
    n_inc = min(ticks * batch, stream.inc_src.shape[0])
    ticks = -(-n_inc // batch)
    out = {"semantics": sem.name, "n": n, "base_edges": m_base, "ticks": ticks,
           "batch": batch, "window": window, "deletions": 0,
           "max_delete_s": 0.0, "host_s": 0.0, "device_s": 0.0}

    t0 = time.perf_counter()
    sp = Spade(metric=sem)
    sp.LoadGraph(src, dst, raw, n_vertices=n)
    out["host_s"] += time.perf_counter() - t0
    funnel = sp.metric

    base_w = host_base_weights(sem, src, dst, raw)
    in_deg = np.bincount(dst, minlength=n)
    a0 = sem.seed_vertices(n, in_deg)
    if not sem.uses_degree:
        check(np.array_equal(base_w, sem.seed_base(src, dst, raw, n)[0]),
              f"{tag}: seed_base's weights differ from the host funnel's")
    e_cap = m_base + ((window + 1) if window else ticks) * batch
    t0 = time.perf_counter()
    g = device_graph_from_coo(n, src, dst, base_w, a=a0,
                              n_capacity=-(-n // 512) * 512,
                              e_capacity=-(-e_cap // 512) * 512, device=dev)
    state = inc.init_state(g, eps=eps)
    deg = torch.zeros(g.n_capacity, dtype=torch.int32, device=dev)
    deg[:n] = torch.from_numpy(in_deg.astype(np.int32)).to(dev)
    sync_dev()
    out["device_s"] += time.perf_counter() - t0
    slots = torch.arange(g.e_capacity, dtype=torch.int32, device=dev)

    # the host's edges: the base graph, then each resident tick (src, dst,
    # the funnel's weights)
    mirror = [(src, dst, base_w.astype(np.float64))]
    errs = {"weights": 0.0, "edges": 0.0, "w0": 0.0}
    for t in range(ticks):
        lo, hi = t * batch, min((t + 1) * batch, n_inc)
        cnt = hi - lo
        bs = np.zeros(batch, np.int32)
        bd = np.zeros(batch, np.int32)
        amt = np.zeros(batch, np.float32)
        valid = np.zeros(batch, bool)
        bs[:cnt], bd[:cnt] = stream.inc_src[lo:hi], stream.inc_dst[lo:hi]
        amt[:cnt], valid[:cnt] = stream.inc_amt[lo:hi], True
        edges = [(int(u), int(v), float(r)) for u, v, r in
                 zip(stream.inc_src[lo:hi], stream.inc_dst[lo:hi], stream.inc_amt[lo:hi])]
        expired = mirror.pop(1) if window and len(mirror) > window else None

        # the device tick
        t0 = time.perf_counter()
        bs_d, bd_d = (torch.from_numpy(x).to(dev) for x in (bs, bd))
        valid_d = torch.from_numpy(valid).to(dev)
        w, deg = sem.batch_weights(deg, bs_d, bd_d, torch.from_numpy(amt).to(dev), valid_d)
        if expired is not None:
            drop = (slots >= m_base) & (slots < m_base + expired[0].shape[0])
            state = inc.slide_and_maintain(state, drop, bs_d, bd_d, w, valid_d, eps=eps,
                                           max_rounds=max_rounds)
        else:
            state = inc.insert_and_maintain(state, bs_d, bd_d, w, valid_d, eps=eps,
                                            max_rounds=max_rounds)
        sync_dev()
        out["device_s"] += time.perf_counter() - t0

        # the host tick: the funnel's weights, as each edge is inserted
        host_w = []
        t0 = time.perf_counter()
        if sem.uses_degree:
            for e in edges:
                host_w.append(funnel.edge_susp(e[0], e[1], e[2], sp.graph))
                sp.InsertBatchEdges([e])
        else:
            host_w = [funnel.edge_susp(u, v, r, sp.graph) for u, v, r in edges]
            sp.InsertBatchEdges(edges)
        out["host_s"] += time.perf_counter() - t0
        for u, v, c in zip(*(x.tolist() for x in expired)) if expired else ():
            t0 = time.perf_counter()
            sp.DeleteEdge(u, v, c)
            dt = time.perf_counter() - t0
            out["host_s"] += dt
            out["deletions"] += 1
            out["max_delete_s"] = max(out["max_delete_s"], dt)
        mirror.append((bs[:cnt].astype(np.int64), bd[:cnt].astype(np.int64),
                       np.asarray(host_w, np.float64)))

        at = f"{tag} tick {t}"
        # 1. the batch weights
        errs["weights"] = max(errs["weights"], cross_close(
            f"{at}: batch weights", w[:cnt].cpu().numpy(), host_w, rtol_w))
        # 2. the live edge multiset: against the host's base graph and
        # resident ticks, and summed per vertex pair against its graph
        s, d, c = device_edges(state)
        ms, md, mc = (np.concatenate(x) for x in zip(*mirror))
        o = np.lexsort((mc, md, ms))
        check(np.array_equal(s, ms[o]) and np.array_equal(d, md[o]),
              f"{at}: live edge endpoints differ from the host's")
        errs["edges"] = max(errs["edges"], cross_close(f"{at}: live edge weights", c,
                                                       mc[o], rtol_w))
        check(int(state.edge_count) == s.shape[0],
              f"{at}: edge_count {int(state.edge_count)} vs {s.shape[0]} live slots")
        dk, dv = pair_sums(s, d, c, n)
        hk, hv = host_pair_sums(sp.graph)
        check(np.array_equal(dk, hk), f"{at}: vertex pairs differ from the host graph's")
        cross_close(f"{at}: weight per vertex pair", dv, hv, rtol_acc)
        # 3. w0, priors included
        errs["w0"] = max(errs["w0"], cross_close(
            f"{at}: w0", state.w0[:n].cpu().numpy(), peeling_weights_full(sp.graph)[:n],
            rtol_acc))
        # 4. best_g is at most the density of the device's own community
        best_g, g_comm = float(state.best_g), community_density(state, n)
        check(best_g <= g_comm * (1.0 + rtol_g),
              f"{at}: best_g {best_g!r} above its community's density {g_comm!r}")

    t0 = time.perf_counter()
    refreshed = inc.full_refresh(state, eps=eps)
    sync_dev()
    out["device_s"] += time.perf_counter() - t0
    t0 = time.perf_counter()
    _, g_host = sp.Detect()
    out["host_s"] += time.perf_counter() - t0
    g_ref = float(refreshed.best_g)
    check(g_ref >= g_host / (2.0 * (1.0 + eps)) * (1.0 - rtol_g),
          f"{tag}: full_refresh best_g {g_ref!r} below g_host {g_host!r} / (2(1+eps))")
    out.update(best_g=float(state.best_g), refreshed_best_g=g_ref, g_host=g_host,
               live_edges=int(state.edge_count), max_rel_err=errs)
    return out


def exact_peel_check(n: int, m: int, seed: int, device, tied: bool) -> dict:
    """``exact_peel`` on ``device`` against the host oracle's ``static_peel``
    on the base graph of a ``(n, m)`` transaction stream, integer weights
    (``tied``: every edge 1 and no priors, so most weights tie), buffers
    padded to multiples of 512: the same order, ``delta`` bit for bit,
    ``best_g`` within rtol 1e-6 of ``detect``'s density."""
    import torch

    from repro_torch.core.peel import exact_peel
    from repro_torch.core.reference import AdjGraph, detect, static_peel
    from repro_torch.graphstore.generators import make_transaction_stream
    from repro_torch.graphstore.structs import device_graph_from_coo

    dev = torch.device(device)
    stream = make_transaction_stream(n=n, m=m, seed=seed)
    n = stream.n_vertices
    src, dst = stream.base_src, stream.base_dst
    rng = np.random.default_rng(seed)
    if tied:
        c, a = np.ones(src.shape[0], np.float32), np.zeros(n, np.float32)
    else:
        c = np.ceil(stream.base_amt).astype(np.float32)
        a = rng.integers(0, 3, n).astype(np.float32)
    g = device_graph_from_coo(n, src, dst, c, a, n_capacity=-(-n // 512) * 512,
                              e_capacity=-(-src.shape[0] // 512) * 512, device=dev)
    t0 = time.perf_counter()
    res = exact_peel(g)
    order = res.order.cpu().numpy()
    device_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = static_peel(AdjGraph.from_arrays(n, src, dst, c, a))
    _, g_host = detect(host)
    host_s = time.perf_counter() - t0
    tag = f"exact_peel[{'tied' if tied else 'int'}]"
    check(np.array_equal(order[:n], host.order()), f"{tag}: order differs from static_peel's")
    check(bool((order[n:] == -1).all()), f"{tag}: padding slots in the order")
    cross_close(f"{tag}: delta", res.delta.cpu().numpy()[:n], host.delta(), 0.0)
    best_g = float(res.best_g)
    check(abs(best_g - g_host) <= 1e-6 * abs(g_host),
          f"{tag}: best_g {best_g!r} vs detect's {g_host!r} beyond rtol 1e-6")
    delta = host.delta()
    return {"n": n, "edges": int(src.shape[0]), "n_capacity": g.n_capacity,
            "tied_neighbours": int((delta[1:] == delta[:-1]).sum()),
            "best_g": best_g, "g_host": g_host, "device_s": device_s, "host_s": host_s}


def phase_cross_plane(card: str) -> dict:
    """12a, 12b and 12c on the card (sizes above, eps and max_rounds from
    the spade-grab config)."""
    from repro_torch.core.semantics import resolve
    from repro_torch.graphstore.generators import make_transaction_stream

    log(f"phase 12: host seconds are the host CPU of the machine that holds {card}; "
        f"device seconds are the {DEVICE} side's, synchronized")
    out = {"insert": [], "window": [], "exact": []}
    p = CROSS_INSERT
    stream = make_transaction_stream(n=p["n"], m=p["m"], seed=p["seed"])
    for sem, integer, batch in (("DG", True, p["batch"]),
                                (parity_semantics(), True, p["batch"]),
                                ("DW", False, p["batch"]), ("FD", False, p["fd_batch"])):
        sem = resolve(sem)
        rec = cross_plane_ticks(sem, integer_amounts(stream) if integer else stream,
                                p["ticks"], batch, DEVICE, EPS, MAX_ROUNDS,
                                integer=integer, tag=f"12a {sem.name}")
        out["insert"].append(rec)
        log(f"12a {sem.name} insert-only, {rec['ticks']} ticks of {rec['batch']} on "
            f"n={rec['n']} base={rec['base_edges']}: weights, live edges, w0 "
            f"{'bit for bit' if integer else 'within rtol'} every tick (max rel err "
            f"{rec['max_rel_err']!r}); best_g {rec['best_g']!r}, refreshed "
            f"{rec['refreshed_best_g']!r} vs g_host {rec['g_host']!r}; host "
            f"{rec['host_s']!r} s, device {rec['device_s']!r} s")
    p = CROSS_WINDOW
    stream = integer_amounts(make_transaction_stream(n=p["n"], m=p["m"], seed=p["seed"]))
    for sem in ("DG", parity_semantics()):
        sem = resolve(sem)
        rec = cross_plane_ticks(sem, stream, p["ticks"], p["batch"], DEVICE, EPS,
                                MAX_ROUNDS, window=p["window"], tag=f"12b {sem.name}")
        out["window"].append(rec)
        log(f"12b {sem.name} window {rec['window']}, {rec['ticks']} ticks of "
            f"{rec['batch']} on n={rec['n']} base={rec['base_edges']}: "
            f"{rec['deletions']} host DeleteEdge calls (slowest {rec['max_delete_s']!r} s); "
            f"weights, live edges, w0 bit for bit every tick; host {rec['host_s']!r} s, "
            f"device {rec['device_s']!r} s")
    p = CROSS_EXACT
    for tied in (False, True):
        rec = exact_peel_check(p["n"], p["m"], p["seed"], DEVICE, tied)
        out["exact"].append(rec)
        log(f"12c exact_peel {'tied' if tied else 'int'} n={rec['n']} "
            f"(capacity {rec['n_capacity']}) E={rec['edges']}: order and delta equal to "
            f"static_peel's ({rec['tied_neighbours']} equal neighbouring deltas), best_g "
            f"{rec['best_g']!r} vs {rec['g_host']!r}; device {rec['device_s']!r} s, host "
            f"{rec['host_s']!r} s")
    return out


# ---------------------------------------------------------------------------
# phase 13: the edge-sharded engine (repro_torch.dist) on the card
# ---------------------------------------------------------------------------

# 13a: Grab4 ticks per engine at world 1 (nccl), and the slide ticks timed
# after them (window 4, as phase 5: 8 timed, 4 traced, 4 with each
# all_reduce timed)
SHARD_TICKS = 32
SHARD_TIMED = {"window": 4, "timed": 8, "traced": 4, "reduce_timed": 4}
# 13b: world 2 (gloo) on the one card, Grab4, window 4 (ticks 5-8 slide)
SHARD_PAIR = {"ticks": 8, "window": 4, "semantics": ("DG", "DW")}
# 13c: four gloo ranks on cuda against the same on cpu, phase 12a's stream;
# each rank's cpu run takes 2 threads (the card machine's 8 cores)
SHARD_SMALL = {"n": 16_000, "m": 100_000, "seed": 3, "batch": 512, "ticks": 8,
               "window": 4, "world": 4, "cpu_threads": 2}
# DW across ranks: each rank's float64 sums add in another order before
# the one rounding, so w0 and final_g may move by a float32 ulp or so
SHARD_RTOL = 1e-5
SHARD_STATE = ("level", "best_g", "community", "w0", "edge_count")
# seconds a spawn of 13b or 13c may take before its ranks are stopped
SHARD_TIMEOUT = 300
SHARD_EDGES = ("src", "dst", "c", "edge_mask")


def cut_stream(stream, n_ticks: int, batch: int):
    """The stream's base graph and its first ``n_ticks`` ticks of increments."""
    from repro_torch.graphstore.generators import TxStream

    n_inc = min(n_ticks * batch, stream.inc_src.shape[0])
    return TxStream(
        n_vertices=stream.n_vertices, base_src=stream.base_src,
        base_dst=stream.base_dst, base_amt=stream.base_amt,
        inc_src=stream.inc_src[:n_inc], inc_dst=stream.inc_dst[:n_inc],
        inc_amt=stream.inc_amt[:n_inc], inc_time=stream.inc_time[:n_inc],
        fraud_label=stream.fraud_label[:n_inc], fraud_block=stream.fraud_block,
    )


def grab_config(**extra) -> dict:
    """The spade-grab sizes this process runs with, for a spawned rank."""
    return {"batch": BATCH, "eps": EPS, "max_rounds": MAX_ROUNDS, **extra}


def set_grab_config(cfg: dict) -> None:
    global BATCH, EPS, MAX_ROUNDS
    BATCH, EPS, MAX_ROUNDS = cfg["batch"], cfg["eps"], cfg["max_rounds"]


def kernel_counts() -> dict:
    from repro_torch.kernels.frontier_spmv import ops as k2_ops
    from repro_torch.kernels.peel_round import ops as k1_ops

    return {"peel_round": k1_ops.launches, "frontier_spmv": k2_ops.launches,
            "suffix_init": k2_ops.suffix_init_launches}


def zero_kernel_counts() -> None:
    from repro_torch.dist import graph as dg
    from repro_torch.kernels.frontier_spmv import ops as k2_ops
    from repro_torch.kernels.peel_round import ops as k1_ops

    k1_ops.launches = k2_ops.launches = k2_ops.suffix_init_launches = 0
    k2_ops.head_slots = k2_ops.unaligned_launches = 0
    dg.reset_stats()


def k2_split() -> dict:
    """How K2's round launches since zero_kernel_counts() split their
    slots: those before alive's first 16-byte boundary (the scalar head),
    and the launches whose word arrays were off the vector alignment."""
    from repro_torch.kernels.frontier_spmv import ops as k2_ops

    return {"head_slots": k2_ops.head_slots,
            "unaligned_launches": k2_ops.unaligned_launches}


def vector_split_ok(split: dict) -> bool:
    return split["head_slots"] == 0 and split["unaligned_launches"] == 0


def vector_split_control() -> dict:
    """The control of 13b's split check: K2 on views of fresh buffers from
    slot 1 (a scalar head of 15 slots) and with only the word arrays one
    slot off (no vector group); the check must reject both."""
    import torch

    from repro_torch.kernels.frontier_spmv import frontier_spmv

    E, V = 4096, 1024
    gen = torch.Generator().manual_seed(0)
    src, dst = (torch.randint(0, V, (E + 1,), generator=gen, dtype=torch.int32).to(DEVICE)
                for _ in range(2))
    c = torch.ones(E + 1, device=DEVICE)
    peel = torch.zeros(V, dtype=torch.bool, device=DEVICE)
    peel[::3] = True
    out = {}
    for name, lo, alive_lo in (("slot 1 on", 1, 1), ("words one slot off", 1, 0)):
        alive = torch.ones(E + 1, dtype=torch.bool, device=DEVICE)
        dw = torch.zeros(V, dtype=torch.float64, device=DEVICE)
        zero_kernel_counts()
        frontier_spmv(src[lo:lo + E], dst[lo:lo + E], c[lo:lo + E],
                      alive[alive_lo:alive_lo + E], peel, dw)
        torch.cuda.synchronize()
        out[name] = k2_split()
        check(not vector_split_ok(out[name]),
              f"13b control: K2 on views ({name}) passes the split check: {out[name]!r}")
    zero_kernel_counts()
    return out


def quantiles(xs) -> dict:
    xs = sorted(xs)
    return {"median": statistics.median(xs), "p90": xs[min(len(xs) - 1, int(0.9 * len(xs)))]}


def serve(sem: str, stream, mesh=None, device: str | None = None, **kw):
    """``SpadeService`` at the spade-grab config's tick, eps and max_rounds:
    (report, the final state as numpy)."""
    from repro_torch.convert import state_to_numpy
    from repro_torch.serve import SpadeService

    svc = SpadeService(sem, batch_edges=kw.pop("batch", BATCH), eps=EPS,
                       max_rounds=MAX_ROUNDS, device=device or DEVICE, mesh=mesh, **kw)
    rep = svc.run(stream)
    return rep, state_to_numpy(svc.final_state)


def same_state(tag: str, got: dict, want: dict, fields=SHARD_STATE + SHARD_EDGES) -> None:
    for f in fields:
        check(np.array_equal(got[f], want[f]), f"{tag}: {f} differs")


def joined(ranks: list[dict], E: int) -> dict:
    """One state of the ranks' blocks: rank 0's replicated fields and the
    edge blocks joined in rank order, cut to ``E`` slots."""
    out = dict(ranks[0])
    for f in SHARD_EDGES:
        out[f] = np.concatenate([r[f] for r in ranks])[:E]
    return out


def phase_sharded_grab(stream) -> dict:
    """13a: world 1 on ``nccl`` at full width.  The service with and without
    a one-rank mesh on the first SHARD_TICKS ticks, fused and predictive
    workset: final states equal bit for bit; the same K1, K2 and
    ``suffix_init`` launches as the single-device run, that is 20 a tick
    (+ the start-up peel's rounds) and 2 a tick (+ 2), and one all_reduce a
    round.  Then fused slide ticks timed (wall and device) and traced, and
    the all_reduce ms per round."""
    import shutil
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.dist import graph as dg

    cut = cut_stream(stream, SHARD_TICKS, BATCH)
    n_ticks = -(-cut.inc_src.shape[0] // BATCH)
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ROOT / "build")
    # nccl on the card (a cpu rehearsal of this phase takes gloo)
    backend = "nccl" if DEVICE == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.FileStore(f"{tmp}/store", 1), rank=0,
                            world_size=1)
    out = {"ticks": n_ticks, "backend": backend, "configs": {}}
    try:
        mesh = DeviceMesh(DEVICE, [0], mesh_dim_names=("data",))
        for name, kw in (("fused", {}), ("predictive", {"workset": True})):
            zero_kernel_counts()
            rep1, want = serve("DW", cut, window_ticks=WINDOW, **kw)
            n1 = kernel_counts()
            zero_kernel_counts()
            rep, got = serve("DW", cut, mesh=mesh, window_ticks=WINDOW, **kw)
            n = kernel_counts()
            ar = dg.STATS["round_all_reduces"]
            same_state(f"13a {name}", got, want)
            for f in DW_EQUAL + ("final_g",):
                check(getattr(rep, f) == getattr(rep1, f),
                      f"13a {name}: report.{f} {getattr(rep, f)!r} vs {getattr(rep1, f)!r}")
            startup = n1["peel_round"] - MAX_ROUNDS * n_ticks
            check(n == n1 and startup > 0 and n["peel_round"] == n["frontier_spmv"] == ar,
                  f"13a {name}: launches {n!r} and {ar} round all_reduces; the single-device "
                  f"run's {n1!r}: expected K1 = K2 = {MAX_ROUNDS} x {n_ticks} ticks + the "
                  f"start-up rounds, one all_reduce a round")
            check(n["suffix_init"] == 2 * n_ticks + 2,
                  f"13a {name}: suffix_init launched {n['suffix_init']} times")
            row = {"launches": n, "startup_rounds": startup, "round_all_reduces": ar, "all_reduces": dg.STATS["all_reduces"],
                   "final_g": rep.final_g, "tick_wall_s": quantiles(rep.tick_seconds),
                   "single_tick_wall_s": quantiles(rep1.tick_seconds),
                   "fallback_ticks": rep.n_fallback_ticks, "predicted_ticks": rep.n_predicted_ticks}
            out["configs"][name] = row
            log(f"13a {name} world 1 (nccl), {n_ticks} ticks: level, best_g, community, w0, "
                f"edge_count and the edge buffers equal the single-device engine's bit for bit; "
                + " ".join(f"{k}={v!r}" for k, v in row.items()))
        out["slide_ticks"] = sharded_slide_ticks(stream, mesh)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def sharded_slide_ticks(stream, mesh) -> dict:
    """Fused slide ticks of the world-1 engine at Grab4 width (window 4, as
    phase 5): wall and device (CUDA events) time of each, a torch.profiler
    trace, and the all_reduce ms per round with each all_reduce timed."""
    import torch

    from repro_torch.core.semantics import resolve
    from repro_torch.dist import graph as dg
    from repro_torch.graphstore.structs import device_graph_from_coo

    p = SHARD_TIMED
    sem = resolve("DW")
    n, m_base = stream.n_vertices, stream.base_src.shape[0]
    base_w, in_deg = sem.seed_base(stream.base_src, stream.base_dst, stream.base_amt, n)
    e_cap = m_base + (p["window"] + 1) * BATCH
    g = device_graph_from_coo(n, stream.base_src, stream.base_dst, base_w,
                              n_capacity=-(-n // 512) * 512,
                              e_capacity=-(-e_cap // 512) * 512, device=DEVICE)
    state = dg.init_sharded_state(dg.shard_graph(g, mesh), mesh, eps=EPS)
    del g
    deg = torch.zeros(state.graph.n_capacity, dtype=torch.int32, device=DEVICE)
    deg[:n] = torch.from_numpy(in_deg.astype(np.int32)).to(DEVICE)
    slots = torch.arange(state.graph.e_capacity, dtype=torch.int32, device=DEVICE)
    drop = (slots >= m_base) & (slots < m_base + BATCH)
    valid = torch.ones(BATCH, dtype=torch.bool, device=DEVICE)
    t = 0

    def one_tick():
        nonlocal state, deg, t
        sl = slice(t * BATCH, (t + 1) * BATCH)
        cu = lambda x, dt: torch.from_numpy(x[sl].astype(dt)).to(DEVICE)
        bs, bd = cu(stream.inc_src, np.int32), cu(stream.inc_dst, np.int32)
        w, deg = sem.batch_weights(deg, bs, bd, cu(stream.inc_amt, np.float32), valid)
        if t < p["window"]:
            state = dg.sharded_insert_and_maintain(state, bs, bd, w, valid, mesh, eps=EPS,
                                                   max_rounds=MAX_ROUNDS)
        else:
            state = dg.sharded_slide_and_maintain(state, drop, bs, bd, w, valid, mesh,
                                                  eps=EPS, max_rounds=MAX_ROUNDS)
        t += 1

    for _ in range(p["window"] + 1):  # fill the window, then one untimed slide
        one_tick()
    zero_kernel_counts()
    walls, events = [], []
    for _ in range(p["timed"]):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        sync()
        t0 = time.perf_counter()
        e0.record()
        one_tick()
        e1.record()
        sync()
        walls.append(time.perf_counter() - t0)
        events.append(e0.elapsed_time(e1) / 1e3)
    n, ar = kernel_counts(), dg.STATS["round_all_reduces"]
    k = p["timed"]
    check(n["peel_round"] == n["frontier_spmv"] == ar == MAX_ROUNDS * k
          and n["suffix_init"] == 2 * k,
          f"13a slide ticks: launches {n!r} and {ar} round all_reduces in {k} ticks")
    prof = trace("13a sharded fused slide tick", p["traced"], one_tick,
                 {"peel_round": "peel_round_kernel", "frontier_spmv": "frontier_spmv_kernel",
                  "suffix_init": "suffix_init_", "nccl": "nccl"})
    dg.reset_stats()
    dg.TIME_REDUCES[0] = True
    try:
        for _ in range(p["reduce_timed"]):
            one_tick()
    finally:
        dg.TIME_REDUCES[0] = False
    st = dict(dg.STATS)
    out = {"tick_wall_s": quantiles(walls), "tick_device_s": quantiles(events),
           "trace": prof, "reduce_ms_per_round":
           1e3 * st["round_reduce_seconds"] / max(st["round_all_reduces"], 1),
           "reduce_ms_per_tick": 1e3 * st["reduce_seconds"] / p["reduce_timed"],
           "reduced_bytes_per_tick": st["reduced_bytes"] / p["reduce_timed"],
           "exchange_bytes_per_slide": st["exchange_bytes"] / max(st["slides"], 1),
           "moved_edges": st["moved_edges"], "stats": st}
    log(f"13a sharded fused slide ticks (world 1, window {p['window']}): wall "
        f"{out['tick_wall_s']!r} s, device (events) {out['tick_device_s']!r} s; all_reduce "
        f"{out['reduce_ms_per_round']!r} ms a round ({st['round_all_reduces']} timed), "
        f"{out['reduce_ms_per_tick']!r} ms and {out['reduced_bytes_per_tick']!r} bytes a tick; "
        f"exchange {out['exchange_bytes_per_slide']!r} bytes a slide, "
        f"{st['moved_edges']} edges moved")
    return out


def pair_rank(mesh, path: str, device: str, cfg: dict) -> dict:
    """A rank of 13b: the service over a two-rank gloo mesh on the card, on
    the Grab4 stream saved at ``path``, for each semantics; each
    all_reduce timed.  Returns each run's report, state (this rank's
    blocks), kernel launches, how K2's launches split their slots
    (:func:`k2_split`) and engine stats."""
    from repro_torch.dist import graph as dg
    from repro_torch.graphstore.generators import TxStream

    set_grab_config(cfg)
    with np.load(path) as z:
        stream = TxStream(n_vertices=int(z["n_vertices"]),
                          **{k: z[k] for k in z.files if k != "n_vertices"})
    out = {}
    dg.TIME_REDUCES[0] = True
    for sem in SHARD_PAIR["semantics"]:
        zero_kernel_counts()
        t0 = time.perf_counter()
        rep, state = serve(sem, stream, mesh=mesh, device=device,
                           window_ticks=cfg["window"])
        out[sem] = {"report": rep, "state": state, "launches": kernel_counts(),
                    "split": k2_split(), "stats": dict(dg.STATS),
                    "seconds": time.perf_counter() - t0}
    return out


def phase_sharded_pair(stream) -> dict:
    """13b: world 2 on the one card over gloo, Grab4, SHARD_PAIR's ticks and
    window, against the single-device engine: DG bit for bit (the joined
    edge buffers too), DW's final_g and w0 within SHARD_RTOL and its edge
    buffers bit for bit (the layout does not depend on the sums)."""
    from repro_torch.dist import spawn

    p = SHARD_PAIR
    cut = cut_stream(stream, p["ticks"], BATCH)
    path = ROOT / "build" / "phase13" / "grab4_stream.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **dataclasses.asdict(cut))
    want = {sem: serve(sem, cut, window_ticks=p["window"]) for sem in p["semantics"]}
    t0 = time.perf_counter()
    ranks = spawn(pair_rank, 2, backend="gloo", device=DEVICE,
                  args=(str(path), DEVICE, grab_config(window=p["window"])),
                  timeout=SHARD_TIMEOUT)
    spawn_s = time.perf_counter() - t0
    path.unlink()
    out = {"spawn_s": spawn_s, "split_control": vector_split_control()}
    for sem in p["semantics"]:
        split = [r[sem]["split"] for r in ranks]
        check(all(vector_split_ok(x) for x in split),
              f"13b {sem}: K2's launches left the vector path: {split!r}")
        rep1, st1 = want[sem]
        E = st1["src"].shape[0]
        got = joined([r[sem]["state"] for r in ranks], E)
        for r in ranks[1:]:
            same_state(f"13b {sem}: rank 0 vs another rank", r[sem]["state"], ranks[0][sem]["state"],
                       fields=SHARD_STATE)
        rep = ranks[0][sem]["report"]
        same_state(f"13b {sem} edges", got, st1, fields=SHARD_EDGES + ("edge_count",))
        n_level = int((got["level"] != st1["level"]).sum())
        if sem == "DG":
            same_state(f"13b {sem}", got, st1)
            check(rep.final_g == rep1.final_g, f"13b DG: final_g {rep.final_g!r} vs {rep1.final_g!r}")
        else:
            check(abs(rep.final_g - rep1.final_g) <= SHARD_RTOL * abs(rep1.final_g),
                  f"13b {sem}: final_g {rep.final_g!r} vs {rep1.final_g!r}")
            err = np.abs(got["w0"].astype(np.float64) - st1["w0"])
            check(bool((err <= SHARD_RTOL * np.maximum(np.abs(st1["w0"]), 1.0)).all()),
                  f"13b {sem}: w0 beyond rtol {SHARD_RTOL} (max abs err {float(err.max())!r})")
        st = ranks[0][sem]["stats"]
        launches = {k: sum(r[sem]["launches"][k] for r in ranks) for k in ranks[0][sem]["launches"]}
        row = {"final_g": rep.final_g, "single_final_g": rep1.final_g,
               "level_differs": n_level, "launches": launches,
               "tick_wall_s": quantiles(rep.tick_seconds),
               "single_tick_wall_s": quantiles(rep1.tick_seconds),
               "reduce_ms_per_round": 1e3 * st["round_reduce_seconds"]
               / max(st["round_all_reduces"], 1),
               "reduced_bytes": st["reduced_bytes"], "slides": st["slides"],
               "moved_edges": st["moved_edges"],
               "exchange_bytes_per_slide": st["exchange_bytes"] / max(st["slides"], 1),
               "k2_split": split, "rank_seconds": [r[sem]["seconds"] for r in ranks]}
        out[sem] = row
        log(f"13b {sem} world 2 (gloo, one card), {rep.n_ticks} ticks, window {p['window']}: "
            + ("bit for bit with the single-device engine, edge buffers joined included; "
               if sem == "DG" else f"final_g and w0 within rtol {SHARD_RTOL}, edge buffers bit "
               f"for bit, {n_level} level entries differ; ")
            + " ".join(f"{k}={v!r}" for k, v in row.items()))
    log(f"13b: K2's launches in the ranks ran every slot past the tail on the vector "
        f"path (scalar head slots and unaligned launches 0 on each rank); the check's "
        f"control on views rejected {out['split_control']!r}.  Collectives staged through "
        f"the host by hand: 0, by construction (every one is an all_reduce, which gloo "
        f"takes on CUDA tensors); gloo's own copies through host memory are inside "
        f"reduce_ms_per_round")
    return out


def small_rank(mesh, p: dict, device: str, cfg: dict) -> dict:
    """A rank of 13c: the service over a gloo mesh on the card and the same
    over a cpu mesh of the same ranks, on phase 12a's stream."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.graphstore.generators import make_transaction_stream

    import torch

    set_grab_config(cfg)
    torch.set_num_threads(p["cpu_threads"])
    cpu_mesh = DeviceMesh("cpu", list(range(p["world"])), mesh_dim_names=("data",))
    stream = cut_stream(make_transaction_stream(n=p["n"], m=p["m"], seed=p["seed"]),
                        p["ticks"], p["batch"])
    out = {}
    for sem, kw in (("DG", {}), ("DG", {"workset": True}), ("DW", {})):
        tag = f"{sem}{'-workset' if kw else ''}"
        zero_kernel_counts()
        res = serve(sem, stream, mesh=mesh, device=device, batch=p["batch"],
                    window_ticks=p["window"], **kw)
        launches, split = kernel_counts(), k2_split()
        ref = serve(sem, stream, mesh=cpu_mesh, device="cpu", batch=p["batch"],
                    window_ticks=p["window"], **kw)
        out[tag] = {"cuda": res, "cpu": ref, "launches": launches, "split": split}
    zero_kernel_counts()
    res = sharded_deletes(stream, mesh, device)
    launches, split = kernel_counts(), k2_split()
    out["DG-delete"] = {"cuda": res, "cpu": sharded_deletes(stream, cpu_mesh, "cpu"),
                        "launches": launches, "split": split}
    return out


def sharded_deletes(stream, mesh, device: str):
    """Inserts and slot-range deletions through the sharded engine (unit
    weights) over ``stream``'s base graph: deletions in the middle of the
    live prefix move survivors across rank boundaries.  Returns a report
    of the final state (final_g, live edges, ticks, edges moved) and the
    state."""
    import torch

    from repro_torch.convert import state_to_numpy
    from repro_torch.dist import graph as dg
    from repro_torch.graphstore.structs import device_graph_from_coo

    n, m_base = stream.n_vertices, stream.base_src.shape[0]
    g = device_graph_from_coo(n, stream.base_src, stream.base_dst,
                              n_capacity=-(-n // 512) * 512,
                              e_capacity=-(-(m_base + 4 * 512) // 512) * 512, device=device)
    state = dg.init_sharded_state(dg.shard_graph(g, mesh), mesh, eps=EPS)
    rng = np.random.default_rng(5)
    slots = torch.arange(state.graph.e_capacity, dtype=torch.int32, device=device)
    moved = dg.STATS["moved_edges"]
    for _ in range(4):
        bs = torch.from_numpy(rng.integers(0, n, 512).astype(np.int32)).to(device)
        bd = torch.from_numpy(rng.integers(0, n, 512).astype(np.int32)).to(device)
        state = dg.sharded_insert_and_maintain(state, bs, bd, torch.ones(512, device=device),
                                               bs != bd, mesh, eps=EPS, max_rounds=MAX_ROUNDS)
        lo = int(rng.integers(0, m_base // 2))
        drop = (slots >= lo) & (slots < lo + int(rng.integers(1, 2048)))
        state = dg.sharded_delete_and_maintain(state, drop, mesh, eps=EPS,
                                               max_rounds=MAX_ROUNDS)
    rep = SimpleNamespace(final_g=float(state.best_g), live_edges=int(state.edge_count),
                          n_ticks=8, moved_edges=dg.STATS["moved_edges"] - moved)
    return rep, state_to_numpy(state)


def phase_sharded_small() -> dict:
    """13c: four gloo ranks on cuda against the same four on cpu (phase 12a's
    stream, window SHARD_SMALL["window"]): DG fused and predictive workset
    bit for bit, DW within SHARD_RTOL; every rank's replicated state the
    same."""
    from repro_torch.dist import spawn

    p = SHARD_SMALL
    t0 = time.perf_counter()
    ranks = spawn(small_rank, p["world"], backend="gloo", device=DEVICE,
                  args=(p, DEVICE, grab_config()), timeout=SHARD_TIMEOUT)
    out = {"seconds": time.perf_counter() - t0, "launches": {}}
    for tag in ranks[0]:
        for r in ranks[1:]:
            same_state(f"13c {tag}: rank 0 vs another rank", r[tag]["cuda"][1],
                       ranks[0][tag]["cuda"][1], fields=SHARD_STATE)
        for r in ranks:
            (rep, got), (rep1, want) = r[tag]["cuda"], r[tag]["cpu"]
            # DW's weights are computed on each device (its float32 math may
            # differ by an ulp): the layout is held exactly, c through final_g
            same_state(f"13c {tag} edges", got, want,
                       fields=("src", "dst", "edge_mask", "edge_count"))
            if tag.startswith("DG"):
                same_state(f"13c {tag}", got, want)
                check(rep.final_g == rep1.final_g, f"13c {tag}: final_g differs")
            else:
                check(abs(rep.final_g - rep1.final_g) <= SHARD_RTOL * abs(rep1.final_g),
                      f"13c {tag}: final_g {rep.final_g!r} vs cpu {rep1.final_g!r}")
        out["launches"][tag] = {k: sum(r[tag]["launches"][k] for r in ranks)
                                for k in ranks[0][tag]["launches"]}
        split = [r[tag]["split"] for r in ranks]
        check(all(vector_split_ok(x) for x in split),
              f"13c {tag}: K2's launches left the vector path: {split!r}")
        rep = ranks[0][tag]["cuda"][0]
        moved = getattr(rep, "moved_edges", None)
        if moved is not None:
            check(moved > 0, f"13c {tag}: no edge changed rank")
            out["moved_edges"] = moved
        log(f"13c {tag} world {p['world']} (gloo) on cuda == the same on cpu "
            f"({'bit for bit' if tag.startswith('DG') else f'rtol {SHARD_RTOL}'}): "
            f"final_g {rep.final_g!r}, live_edges {rep.live_edges}, {rep.n_ticks} ticks, "
            + (f"{moved} edges moved across ranks, " if moved is not None else "")
            + f"launches {out['launches'][tag]!r}")
    return out


def phase_sharded(stream) -> dict:
    import torch

    if DEVICE == "cuda":  # the spawned ranks need room on the card
        torch.cuda.empty_cache()
        log(f"phase 13: this process holds {torch.cuda.memory_reserved() / 2**30!r} GiB "
            f"of the card before the ranks start")
    t0 = time.perf_counter()
    out = {"grab_world1": phase_sharded_grab(stream)}
    log(f"13a: {time.perf_counter() - t0!r} s")
    t1 = time.perf_counter()
    out["grab_world2"] = phase_sharded_pair(stream)
    log(f"13b: {time.perf_counter() - t1!r} s")
    t1 = time.perf_counter()
    out["small_world4"] = phase_sharded_small()
    log(f"13c: {time.perf_counter() - t1!r} s")
    out["seconds"] = time.perf_counter() - t0
    return out



# ---------------------------------------------------------------------------
# phase 14: the MoE LMs at full width (olmoe-1b-7b, mixtral-8x7b)
# ---------------------------------------------------------------------------

# olmoe-1b-7b at its full depth; mixtral-8x7b at 24 of its 32 layers: its
# 46.7B bf16 parameters (93.4 GB) do not fit one 80 GB card, and 24 layers
# (35.1B, 70.2 GB) is the largest multiple of 4 that leaves >= 8 GB for the
# prefill's buffers and the rolling cache.  Traffic as phase 8's
MOE_LAYERS = {"olmoe-1b-7b": 16, "mixtral-8x7b": 24}
# 14b: one layer's moe_ffn on this many tokens (32 blocks of 16: capacity 2
# for olmoe, 5 for mixtral, so drops), cuda bf16 against cpu float32 on the
# same weights, normwise over the tokens routed alike: the bf16 rounding of
# x @ w_gate, x @ w_up, h and y (2^-9 each) and of the gated sum
MOE_FFN_TOKENS = 512
MOE_FFN_TOL = 1e-2


def moe_attention(seed: int) -> dict:
    """14a: K3 at the MoE LMs' attention shapes (bf16, D 128, B 2, S 8192;
    olmoe's 16 q over 16 kv heads, causal; mixtral's 32 over 8, window
    4096) against its plain versions as in phase 6, with the controls; its
    device time, its operations bound over the window's pairs, and SDPA's
    device time (mixtral's window through a boolean mask, on k and v
    repeated to the q heads outside the timed call)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (attention_ref, flash_attention,
                                                     flash_attention_ref)
    from repro_torch.kernels.flash_attention import ops as k3_ops

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    out = {}
    for arch in MOE_LAYERS:
        cfg = get_config(arch)
        B, S = LM_BATCH, LM_PROMPT
        Hq, Hkv, D, window = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.sliding_window
        G = Hq // Hkv
        q, k, v = (torch.randn((B, S, h, D), generator=gen, device=DEVICE,
                               dtype=torch.float32).to(torch.bfloat16).permute(0, 2, 1, 3)
                   for h in (Hq, Hkv, Hkv))
        n0, s0 = k3_ops.launches, k3_ops.simt_launches
        got = flash_attention(q, k, v, causal=True, window=window)
        sync()
        check(k3_ops.launches == n0 + 1 and k3_ops.simt_launches == s0,
              f"{arch} attention did not run on K3's tensor-core body")
        tag = f"K3 {arch} B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} window={window}"
        err, rel = attn_check(f"{tag} vs flash_attention_ref", got,
                              flash_attention_ref(q, k, v, causal=True, window=window))
        for j in range(Hkv):
            e, r = attn_check(
                f"{tag} vs attention_ref (kv head {j})", got[:, j * G:(j + 1) * G],
                attention_ref(q[:, j * G:(j + 1) * G], k[:, j:j + 1], v[:, j:j + 1],
                              causal=True, window=window))
            err, rel = max(err, e), max(rel, r)
        controls = attn_controls(q, k, v, got, G, window)
        k3 = lambda: flash_attention(q, k, v, causal=True, window=window)
        if window is None:
            sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                          enable_gqa=True)
        else:
            ke, ve = (t.repeat_interleave(G, dim=1) for t in (k, v))
            ok = torch.ones(S, S, dtype=torch.bool, device=DEVICE).tril()
            ok &= ~torch.ones(S, S, dtype=torch.bool, device=DEVICE).tril(-window)
            sdpa = lambda: F.scaled_dot_product_attention(q, ke, ve, attn_mask=ok)
        # device times in turns (K3, SDPA, SDPA, K3) with the SM clock
        # read before them: the spread of one call
        clocks = sm_clocks()
        turns = [device_time_ms(fn) for fn in (k3, sdpa, sdpa, k3)]
        ms, lib = statistics.mean(turns[::3]), statistics.mean(turns[1:3])
        call, lib_call = cuda_time_ms(k3, reps=10), cuda_time_ms(sdpa, reps=10)
        sdpa_diff = float((sdpa().float() - got.float()).abs().max())
        bound = k3_bound_ms(B, Hq, Hkv, S, D, window)
        tflops = 4 * B * Hq * D * attn_pairs(S, window) / ms / 1e9
        out[arch] = {"shape": tag, "max_abs_err": err, "band_rel_err": rel,
                     "controls": controls, "ms": ms, "call_ms": call, "library_ms": lib,
                     "library_call_ms": lib_call, "bound_ms": bound, "bound_by": "operations",
                     "tflops": tflops, "sdpa_max_abs_diff": sdpa_diff,
                     "turns_k3_sdpa_sdpa_k3": turns, "sm_clocks": clocks}
        log(f"{tag}: max_abs_err={err!r}, band relative err {rel!r} vs flash_attention_ref "
            f"and attention_ref; device ms in turns K3, sdpa, sdpa, K3: {turns!r} "
            f"(SM clock, power before: {clocks}); kernel {ms!r} ms device ({call!r} ms "
            f"call; {tflops!r} "
            f"TFLOP/s, {ms / lib!r}x sdpa, {bound / ms!r} of the bound), sdpa {lib!r} ms "
            f"device ({lib_call!r} ms call; within {sdpa_diff!r} of K3), bound {bound!r} ms "
            f"(operations)")
        del q, k, v, got
        torch.cuda.empty_cache()
    return out


def moe_ffn_parity(seed: int) -> dict:
    """14b: one layer's ``moe_ffn`` at each MoE config's width (D, E, K, F,
    capacity factor) on MOE_FFN_TOKENS tokens, cuda bf16 against cpu
    float32 on the same weights (seeded draws): routing under rule 1,
    dropped assignments counted on both devices, outputs normwise within
    MOE_FFN_TOL over the tokens routed alike, aux within LOSS_RTOL, and two
    cuda runs the same bits; its device time."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import moe_ffn
    from repro_torch.models.layers import normal_init
    from repro_torch.models.moe import moe_route

    out = {}
    for arch in MOE_LAYERS:
        cfg = get_config(arch)
        spec, D, T = cfg.moe, cfg.d_model, MOE_FFN_TOKENS
        E, K, F = spec.n_experts, spec.top_k, spec.d_ff_expert
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        bf16 = torch.bfloat16
        w = [normal_init((D, E), D, torch.float32, DEVICE, gen),
             normal_init((E, D, F), D, bf16, DEVICE, gen),
             normal_init((E, D, F), D, bf16, DEVICE, gen),
             normal_init((E, F, D), F, bf16, DEVICE, gen)]
        x = torch.randn((T, D), generator=gen, device=DEVICE).to(bf16)
        with torch.inference_mode():
            got, aux = moe_ffn(x, *w, spec)
            again, aux2 = moe_ffn(x, *w, spec)
            sync()
            check(torch.equal(got, again) and torch.equal(aux, aux2),
                  f"{arch} moe_ffn: two cuda runs gave different bits")
            r_g = moe_route(x, w[0], spec)
            x_c = x.float().cpu()
            w_c = [t.float().cpu() for t in w]
            r_c = moe_route(x_c, w_c[0], spec)
            want, aux_c = moe_ffn(x_c, *w_c, spec)
        routing = routing_check(f"{arch} moe_ffn", [r_g], [r_c], T)
        alike = ((r_g.topi.cpu() == r_c.topi).all(-1)
                 & (r_g.keep.cpu() == r_c.keep).reshape(T, K).all(-1))
        diff = got.float().cpu()[alike] - want[alike]
        rel = float(diff.norm() / want[alike].norm())
        aux_err = abs(float(aux) - float(aux_c)) / abs(float(aux_c))
        check(rel <= MOE_FFN_TOL, f"{arch} moe_ffn: normwise err {rel!r} beyond {MOE_FFN_TOL}")
        check(aux_err <= LOSS_RTOL, f"{arch} moe_ffn: aux {float(aux)!r} vs {float(aux_c)!r}")
        ms = device_time_ms(lambda: moe_ffn(x, *w, spec), calls=10)
        bound, by = moe_ffn_bound_ms(spec, D, T, r_g.slot.shape[0] * r_g.capacity)
        out[arch] = {"tokens": T, "capacity": r_g.capacity, "blocks": r_g.slot.shape[0],
                     "dropped_cuda": routing["dropped"][0], "dropped_cpu": routing["dropped"][1],
                     "near_ties": routing["near_ties"], "rerouted": routing["rerouted"],
                     "tokens_compared": int(alike.sum()), "normwise_err": rel,
                     "max_abs_err": float(diff.abs().max()), "aux_rel_err": aux_err, "ms": ms,
                     "bound_ms": bound, "bound_by": by}
        log(f"{arch} moe_ffn (D {D}, E {E}, top-{K}, F {F}, {T} tokens in "
            f"{r_g.slot.shape[0]} blocks, capacity {r_g.capacity}) cuda bf16 vs cpu float32: "
            f"normwise err {rel!r} over {int(alike.sum())} tokens routed alike (tolerance "
            f"{MOE_FFN_TOL}), max abs err {float(diff.abs().max())!r}, aux relative err "
            f"{aux_err!r}; {routing['near_ties']} near-tie tokens, {routing['rerouted']} "
            f"routed differently; dropped assignments cuda {routing['dropped'][0]}, cpu "
            f"{routing['dropped'][1]} of {T * K}; two cuda runs the same bits; "
            f"{ms!r} ms device, bound {bound!r} ms ({by}; {bound / ms!r} of it)")
        del w, w_c, x, got, again, want
        torch.cuda.empty_cache()
    return out


def moe_ffn_bound_ms(spec, D: int, T: int, rows: int) -> tuple[float, str]:
    """One ``moe_ffn`` call in bf16: the router (float32) and every
    expert's weights read once, x read and the output written once; the
    products of the ``rows`` capacity-buffer rows an expert (three of D x
    F each, what the function computes) at the bf16 tensor-core rate."""
    E, F = spec.n_experts, spec.d_ff_expert
    nbytes = 4 * D * E + 2 * 3 * E * D * F + 2 * 2 * T * D
    flops = 2 * 3 * E * rows * D * F
    t_ops, t_bytes = flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def layer0_keys(model, tokens, pos):
    """Layer 0's roped keys of ``tokens`` [B, S] at positions ``pos`` [S]
    (what its attention block writes to the cache), computed again."""
    from repro_torch.models.layers import apply_rope, rms_norm, rope_angles

    cfg, lp = model.cfg, model.layers[0]
    B, S = tokens.shape
    k = (rms_norm(model.embed[tokens], lp.attn_norm) @ lp.wk).reshape(
        B, S, cfg.n_kv_heads, cfg.d_head)
    if cfg.qk_norm:
        k = rms_norm(k, lp.k_norm)
    cos, sin = rope_angles(pos, cfg.d_head, cfg.rope_theta)
    return apply_rope(k, cos[None, :, None, :], sin[None, :, None, :])


def moe_lm_full(arch: str, seed: int) -> dict:
    """14c / 14d: an MoE LM at full width (MOE_LAYERS deep), random weights
    from a seeded generator on the card, phase 8's traffic: 2 x 8,192-token
    prefill (K3's counters set to 0 just before and read just after: a
    tensor-core launch a layer, none SIMT), 32 greedy decode steps, then
    ``forward`` and ``lm_loss`` over the prompts; the cache's slots checked
    against layer 0's keys recomputed (after the prefill, and the last
    decode step's); drops per prefill from one more, recorded, prefill;
    ``torch.profiler`` traces of a prefill and four decode steps."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as k3_ops
    from repro_torch.models import (TransformerLM, cache_window, decode_step, forward,
                                    lm_loss, moe_ffn, prefill)
    from repro_torch.models.moe import moe_route

    cfg = dataclasses.replace(get_config(arch), n_layers=MOE_LAYERS[arch])
    batch, prompt, n_dec = LM_BATCH, LM_PROMPT, LM_DECODE_STEPS
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = TransformerLM(cfg, device=DEVICE,
                          generator=torch.Generator(device=DEVICE).manual_seed(seed))
    sync()
    init_s = time.perf_counter() - t0
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"{cfg.name}: {cfg.n_layers} of {get_config(arch).n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.moe.n_experts} experts top-{cfg.moe.top_k}, {cfg.n_params} "
        f"params ({n_bytes / 1e9!r} GB), random init {init_s!r} s")
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (batch, prompt))).to(DEVICE)
    W, rolling = cache_window(cfg, prompt)

    k3_ops.launches = 0
    k3_ops.simt_launches = 0
    sync()
    t0 = time.perf_counter()
    logits, cache = prefill(model, tokens)
    sync()
    prefill_s = time.perf_counter() - t0
    launches, simt = k3_ops.launches, k3_ops.simt_launches
    check(launches == cfg.n_layers and simt == 0,
          f"{cfg.name}: K3 launched {launches} times (SIMT {simt}), expected "
          f"{cfg.n_layers} per prefill on the tensor cores")
    check(bool(torch.isfinite(logits).all()), f"{cfg.name} prefill: non-finite logits")
    check(tuple(cache.k.shape) == (cfg.n_layers, batch, W, cfg.n_kv_heads, cfg.d_head),
          f"{cfg.name}: cache {tuple(cache.k.shape)}")
    with torch.inference_mode():
        pos = torch.arange(prompt - W, prompt, device=DEVICE)
        want = layer0_keys(model, tokens, torch.arange(prompt, device=DEVICE))[:, prompt - W:]
        got = cache.k[0][:, pos % W]
        slot_err = float((got.float() - want.float()).abs().max() / want.float().abs().max())
        slot_bits = torch.equal(got, want)
    check(slot_err <= 1e-2, f"{cfg.name}: cache slots p % W do not hold positions "
          f"{prompt - W}-{prompt - 1} (layer 0 keys off by {slot_err!r} of their scale)")
    log(f"{cfg.name}: cache {tuple(cache.k.shape)} ({'rolling' if rolling else 'full'}), "
        f"slots p % {W} hold positions {prompt - W}-{prompt - 1}: layer 0's keys recomputed "
        f"within {slot_err!r} of their scale (bit for bit: {slot_bits})")
    steps, out_tokens = [], []
    tok = logits.argmax(-1)
    for i in range(n_dec):
        out_tokens.append(tok)
        last_tok = tok
        t0 = time.perf_counter()
        logits, cache = decode_step(model, cache, tok, torch.full(
            (batch,), prompt + i, dtype=torch.int64, device=DEVICE))
        sync()
        steps.append(time.perf_counter() - t0)
        check(bool(torch.isfinite(logits).all()),
              f"{cfg.name} decode step {i}: non-finite logits")
        tok = logits.argmax(-1)
    check(k3_ops.launches == launches, f"{cfg.name}: decode launched K3")
    last = prompt + n_dec - 1
    with torch.inference_mode():
        want = layer0_keys(model, last_tok[:, None],
                           torch.tensor([last], device=DEVICE))[:, 0]
        got = cache.k[0][:, last % W]
        wrap_err = float((got.float() - want.float()).abs().max() / want.float().abs().max())
    check(wrap_err <= 1e-2, f"{cfg.name}: decode position {last} is not in slot {last % W} "
          f"({wrap_err!r})")
    log(f"{cfg.name}: decode position {last} in slot {last % W} (layer 0's key within "
        f"{wrap_err!r} of its scale)")
    peak_serve = torch.cuda.max_memory_allocated()

    # drops per prefill: one more prefill, its routing recorded (untimed)
    rec = []
    with routing_recorded(rec):
        prefill(model, tokens)
    drops = [int((~r.keep).sum()) for r in rec]
    n_assign = batch * prompt * cfg.moe.top_k
    rec = None
    t0 = time.perf_counter()
    prefill(model, tokens)
    sync()
    warm_s = time.perf_counter() - t0

    # the scoring forward and the loss over the same prompts (next tokens)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    flogits, faux = forward(model, tokens)
    sync()
    forward_s = time.perf_counter() - t0
    check(tuple(flogits.shape) == (batch, prompt, cfg.vocab)
          and bool(torch.isfinite(flogits).all()), f"{cfg.name} forward: logits")
    del flogits
    torch.cuda.empty_cache()
    labels = torch.roll(tokens, -1, dims=1)
    t0 = time.perf_counter()
    loss, parts = lm_loss(model, tokens, labels)
    sync()
    loss_s = time.perf_counter() - t0
    check(math.isfinite(float(loss)) and float(faux) > 0.0,
          f"{cfg.name} lm_loss: {float(loss)!r}, aux {float(faux)!r}")
    peak = torch.cuda.max_memory_allocated()
    ts = sorted(steps)
    p90 = ts[min(len(ts) - 1, int(0.9 * len(ts)))]
    out = {"n_layers": cfg.n_layers, "n_params": cfg.n_params, "weights_gb": n_bytes / 1e9,
           "prefill_s": prefill_s, "prompt_tokens_per_s": batch * prompt / prefill_s,
           "prefill_warm_s": warm_s, "prompt_tokens_per_s_warm": batch * prompt / warm_s,
           "decode_ms_median": 1e3 * statistics.median(ts), "decode_ms_p90": 1e3 * p90,
           "decode_tokens_per_s": batch / statistics.median(ts),
           "max_memory_allocated_gb": peak / 1e9,
           "max_memory_allocated_serving_gb": peak_serve / 1e9, "k3_launches": launches,
           "k3_simt_launches": simt, "init_s": init_s, "cache_window": W,
           "cache_gb": 2 * cache.k.numel() * 2 / 1e9, "drops_per_prefill": sum(drops),
           "drops_per_layer": drops, "assignments_per_layer": n_assign,
           "forward_s": forward_s, "lm_loss_s": loss_s, "lm_loss": float(loss),
           "nll": float(parts["nll"]), "aux": float(parts["aux"]),
           "tokens": torch.stack(out_tokens, 1)[:, :8].tolist()}
    log(f"{cfg.name} main path: " + " ".join(f"{k}={v!r}" for k, v in out.items()))

    # one layer's moe_ffn alone at the prefill's tokens (a random input)
    lp = model.layers[0]
    h = torch.randn((batch * prompt, cfg.d_model), device=DEVICE).to(lp.w_up.dtype)
    with torch.inference_mode():
        r = moe_route(h, lp.router, cfg.moe)
        rows = r.slot.shape[0] * r.capacity
        moe_ms = device_time_ms(lambda: moe_ffn(h, lp.router, lp.w_gate, lp.w_up, lp.w_down,
                                                cfg.moe), calls=5)
    moe_bound, moe_by = moe_ffn_bound_ms(cfg.moe, cfg.d_model, batch * prompt, rows)
    out.update(moe_ffn_prefill_ms=moe_ms, moe_ffn_prefill_bound_ms=moe_bound,
               moe_ffn_prefill_bound_by=moe_by)
    log(f"{cfg.name} moe_ffn alone, one layer, {batch * prompt} random tokens (capacity "
        f"{r.capacity}): {moe_ms!r} ms device, bound {moe_bound!r} ms ({moe_by}; "
        f"{moe_bound / moe_ms!r} of it)")
    del h, r

    # where a prefill and a decode step spend their device time
    pos = prompt + n_dec
    shares = {"flash_attention": "flash_fwd_kernel",
              "cublas_products": ("nvjet", "gemm", "cutlass", "xmma"),
              "index_scatter_gather": ("index", "scatter", "gather")}
    out["profile_prefill"] = trace(f"{cfg.name} prefill", 1,
                                   lambda: prefill(model, tokens), shares)
    out["profile_decode"] = trace(f"{cfg.name} decode step", 4, lambda: decode_step(
        model, cache, tok, torch.full((batch,), pos, dtype=torch.int64, device=DEVICE)),
        shares)
    del model, cache, logits
    torch.cuda.empty_cache()
    return out


def phase_moe(seed: int) -> dict:
    """Phase 14: 14a K3 at the MoE attention shapes, 14b one layer's
    ``moe_ffn`` cuda against cpu, 14c olmoe-1b-7b and 14d mixtral-8x7b
    served at full width."""
    import torch

    check(not torch.backends.cuda.matmul.allow_tf32,
          "phase 14: TF32 is on for float32 products (the router's logits)")
    t0 = time.perf_counter()
    out = {"attention": moe_attention(seed)}
    log(f"14a: {time.perf_counter() - t0!r} s")
    t1 = time.perf_counter()
    out["moe_ffn"] = moe_ffn_parity(seed)
    log(f"14b: {time.perf_counter() - t1!r} s")
    for tag, arch in zip(("14c", "14d"), MOE_LAYERS):
        t1 = time.perf_counter()
        out[arch] = moe_lm_full(arch, seed)
        log(f"{tag}: {time.perf_counter() - t1!r} s")
    out["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# phase 15: training on the card
# ---------------------------------------------------------------------------

# the CPU tests' optimizer and tolerances (tests/test_torch_train.py): three
# steps at lr 1e-2, warmup 1; loss and grad_norm at rtol 1e-5; parameters
# within 1 % of a step but for a few elements (Adam moves an element by about
# lr * sign(g), which a last-bit difference flips where g is near 0, and int8
# compression flips a quantum at a rounding tie), each within 2 lr a step
TRAIN_ADAM = {"lr": 1e-2, "warmup_steps": 1, "grad_clip": 1.0}
TRAIN_STEPS = 3
TRAIN_RTOL = 1e-5
TRAIN_STEP_TOL = 1e-2
TRAIN_ODD = {False: 1e-3, True: 5e-3}  # share of a leaf's elements, by compression
# 15a: the smoke LMs (microbatches, compression) and the four GNN kinds
TRAIN_SMOKE_LMS = (("qwen3-14b", 2, False), ("olmoe-1b-7b", 1, True))
# 15c: qwen3-14b at its published widths with its depth cut to fit one card
# (bf16 weights and gradients, float32 m and v: 12 bytes a parameter): 12 of
# 40 layers (5.52B parameters, 66.2 GB of state) peak at 68.4 GB on the H100,
# within 90 % of its 80 GB; 13 layers (4.0 GB more) would pass that.  The
# train_4k sequence at batch 1, one microbatch, remat.  lr 3e-3 from step 1
# (warmup 1) so that step 1 moves every bf16 leaf: the weights are bf16
# masters, as the reference keeps them, and the default warmup's first
# update (3e-6) is below half a bf16 ulp of a norm scale of 1
TRAIN_LM_LAYERS = 12
TRAIN_LM_SEQ, TRAIN_LM_BATCH = 4096, 1
TRAIN_LM_ADAM = {"lr": 3e-3, "warmup_steps": 1}
TRAIN_ATTN_TOL = 1e-2  # normwise: bf16 inputs and bf16 gradients (2^-9 a rounding)
ANNOTATIONS = ("flash_attention_backward",)  # record_function ranges of the port


def train_params_check(name: str, got: dict, want: dict, lr: float, compress: bool) -> int:
    """The CPU tests' rule on two ``{name: tensor}`` parameter sets;
    returns the most odd elements of a leaf."""
    worst = 0
    for k, w in want.items():
        d = (got[k].detach().float().cpu() - w.detach().float().cpu()).abs()
        odd = int((d > TRAIN_STEP_TOL * lr).sum())
        check(odd <= max(2, TRAIN_ODD[compress] * d.numel()),
              f"{name} {k}: {odd} of {d.numel()} elements off by more than "
              f"{TRAIN_STEP_TOL * lr!r}")
        check(float(d.max()) <= 2 * lr * TRAIN_STEPS, f"{name} {k}: {float(d.max())!r}")
        worst = max(worst, odd)
    return worst


def train_metrics_check(name: str, got: dict, want: dict) -> float:
    worst = 0.0
    for k in ("loss", "grad_norm", "lr"):
        g, w = float(got[k]), float(want[k])
        rel = abs(g - w) / max(abs(w), 1e-30)
        check(math.isfinite(g) and rel <= TRAIN_RTOL,
              f"{name} {k}: {g!r} on cuda, {w!r} on cpu (relative {rel!r}, beyond {TRAIN_RTOL})")
        worst = max(worst, rel)
    return worst


def named_params(params) -> dict:
    from repro_torch import pytree

    return {pytree.keystr(p): x for p, x in pytree.leaves_with_path(params)}


def train_parity(seed: int) -> dict:
    """15a: three train steps on cuda and on cpu from the same weights: the
    smoke LMs (float32; K3's SIMT body on cuda, two launches a layer a
    microbatch: the forward and the remat recomputation), qwen3-14b's with 2
    microbatches and olmoe-1b-7b's compressed, and the four GNN kinds (GCN's
    8 K4 launches a step: 4 forward, 4 backward)."""
    import torch

    from repro_torch.configs import GNN_SHAPES, get_smoke_config
    from repro_torch.kernels.flash_attention import ops as k3_ops
    from repro_torch.kernels.gather_segsum import ops as k4_ops
    from repro_torch.launch.cells import graph_batch
    from repro_torch.models import GNN, TransformerLM, forward, gnn_loss, lm_loss
    from repro_torch.models.gnn import GraphBatch, gcn_rows
    from repro_torch.train import AdamConfig, init_train_state, make_train_step

    adam = AdamConfig(**TRAIN_ADAM)
    out = {"simt_launches": 0}
    k3_ops.launches = k3_ops.simt_launches = 0
    for arch, micro, compress in TRAIN_SMOKE_LMS:
        cfg = get_smoke_config(arch)
        cpu = TransformerLM(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
        gpu = TransformerLM(cfg, device=DEVICE, init=False)
        gpu.load_state_dict(cpu.state_dict())
        rng = np.random.default_rng(seed)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 24)))
        batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
        routing = None
        if cfg.moe is not None:  # every token routed alike, or the gradients differ
            rec_g, rec_c = [], []
            with torch.no_grad(), routing_recorded(rec_g):
                forward(gpu, tokens.to(DEVICE))
            with torch.no_grad(), routing_recorded(rec_c):
                forward(cpu, tokens)
            routing = routing_check(f"{arch} train", rec_g, rec_c, 2)
            check(not routing["rows"], f"{arch}: tokens routed differently on cuda and cpu")
            routing["rows"] = []
        loss = lambda m, b: lm_loss(m, b["tokens"], b["labels"])
        step = make_train_step(loss, adam, microbatches=micro, compress=compress)
        sg, sc = init_train_state(gpu, compress), init_train_state(cpu, compress)
        n0 = k3_ops.simt_launches
        worst = 0.0
        for _ in range(TRAIN_STEPS):
            sg, mg = step(sg, {k: v.to(DEVICE) for k, v in batch.items()})
            sc, mc = step(sc, batch)
            worst = max(worst, train_metrics_check(f"{arch} cuda vs cpu", mg, mc))
        sync()
        launches = k3_ops.simt_launches - n0
        check(launches == 2 * cfg.n_layers * micro * TRAIN_STEPS,
              f"{arch} train: K3's SIMT body launched {launches} times, expected "
              f"{2 * cfg.n_layers * micro * TRAIN_STEPS}")
        out["simt_launches"] += launches
        odd = train_params_check(f"{arch} params", named_params(sg.params),
                                 named_params(sc.params), adam.lr, compress)
        out[arch] = {"microbatches": micro, "compress": compress, "metrics_rel_err": worst,
                     "odd_elements_max": odd, "loss": float(mc["loss"]),
                     "simt_launches": launches, "routing": routing}
        log(f"15a {arch} (microbatches {micro}, compress {compress}): {TRAIN_STEPS} steps cuda "
            f"vs cpu, loss / grad_norm / lr within {worst!r} relative (tolerance "
            f"{TRAIN_RTOL}), at most {odd} odd elements a leaf; K3 SIMT launches {launches}")
        del cpu, gpu, sg, sc
    check(k3_ops.launches == 0, f"15a: K3's tensor-core body launched {k3_ops.launches} times")

    spec = dataclasses.replace(GNN_SHAPES["full_graph_sm"], n_nodes=700, n_edges=3000, d_feat=8)
    for arch in GNN_ARCHS:
        cfg = get_smoke_config(arch)
        g_cpu = graph_batch(cfg, spec, seed, device="cpu")
        g = GraphBatch(*(t.to(DEVICE) for t in g_cpu))
        d_edge = g.edge_feat.shape[1] or 4
        cpu = GNN(cfg, 8, d_edge, device="cpu", generator=torch.Generator().manual_seed(seed))
        gpu = GNN(cfg, 8, d_edge, device=DEVICE, init=False)
        gpu.load_state_dict(cpu.state_dict())
        rows_g, rows_c = (gcn_rows(x) if cfg.kind == "gcn" else None for x in (g, g_cpu))
        step_g = make_train_step(lambda p, b: gnn_loss(p, b, cfg, rows_g), adam)
        step_c = make_train_step(lambda p, b: gnn_loss(p, b, cfg, rows_c), adam)
        sg, sc = init_train_state(gpu.params()), init_train_state(cpu.params())
        n0 = k4_ops.launches
        worst = 0.0
        for _ in range(TRAIN_STEPS):
            sg, mg = step_g(sg, g)
            sc, mc = step_c(sc, g_cpu)
            worst = max(worst, train_metrics_check(f"{arch} cuda vs cpu", mg, mc))
        sync()
        launches = k4_ops.launches - n0
        want = 8 * TRAIN_STEPS if cfg.kind == "gcn" else 0
        check(launches == want, f"{arch} train: K4 launched {launches} times, expected {want}")
        odd = train_params_check(f"{arch} params", named_params(sg.params),
                                 named_params(sc.params), adam.lr, False)
        out[arch] = {"metrics_rel_err": worst, "odd_elements_max": odd,
                     "loss": float(mc["loss"]), "k4_launches": launches}
        log(f"15a {arch}: {TRAIN_STEPS} steps cuda vs cpu, metrics within {worst!r}, at most "
            f"{odd} odd elements a leaf; K4 launches {launches}")
        del g, g_cpu, cpu, gpu, sg, sc
    torch.cuda.empty_cache()
    return out


def train_gcn(seed: int, kept: dict) -> dict:
    """15b: gcn-cora at its widths trained on whole ogbn-products (phase
    11's graph and rows), three steps, K4's launches counted (8 a step);
    then K4's backward (the Function's) against autograd of
    ``spmm_rows_ref`` at ``minibatch_lg`` in float32, and both timed."""
    import torch

    from repro_torch.configs import GNN_SHAPES, get_config
    from repro_torch.kernels.gather_segsum import gather_segsum
    from repro_torch.kernels.gather_segsum import ops as k4_ops
    from repro_torch.kernels.gather_segsum import spmm_rows_ref
    from repro_torch.launch.cells import graph_batch
    from repro_torch.models import GNN, gnn_loss
    from repro_torch.models.gnn import _GcnAggregate, gcn_rows
    from repro_torch.train import AdamConfig, init_train_state, make_train_step

    cfg = get_config(GNN_ARCH)
    g, rows = kept.pop("ogb_products_rows")
    N = g.node_feat.shape[0]
    model = GNN(cfg, g.node_feat.shape[1], device=DEVICE,
                generator=torch.Generator(device=DEVICE).manual_seed(seed))
    state = init_train_state(model.params())
    step = make_train_step(lambda p, b: gnn_loss(p, b, cfg, rows), AdamConfig())
    torch.cuda.reset_peak_memory_stats()
    k4_ops.launches = 0
    times, losses = [], []
    for _ in range(TRAIN_STEPS):
        sync()
        t0 = time.perf_counter()
        state, m = step(state, g)
        sync()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        check(math.isfinite(losses[-1]) and math.isfinite(float(m["grad_norm"])),
              f"gcn-cora train: loss {losses[-1]!r}, grad_norm {float(m['grad_norm'])!r}")
    launches = k4_ops.launches
    check(launches == 8 * TRAIN_STEPS,
          f"gcn-cora train: K4 launched {launches} times in {TRAIN_STEPS} steps, expected "
          f"{8 * TRAIN_STEPS}")
    out = {"nodes": N, "edges": g.edge_src.shape[0], "step_s": times,
           "step_s_median": statistics.median(times[1:]), "nodes_per_s": N / statistics.median(
               times[1:]), "losses": losses, "k4_launches": launches,
           "k4_launches_per_step": launches / TRAIN_STEPS,
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    out["profile"] = trace("gcn-cora train step (ogb_products)", 1, lambda: step(state, g),
                           {"gather_segsum": "gather_segsum_kernel"})
    del g, rows, model, state, step
    torch.cuda.empty_cache()

    # K4's backward against autograd of the plain aggregation, minibatch_lg
    gb = graph_batch(cfg, GNN_SHAPES["minibatch_lg"], seed, device=DEVICE)
    r = gcn_rows(gb)
    n = gb.node_feat.shape[0]
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    h = torch.randn((n, GCN_WIDTHS[0]), device=DEVICE, generator=gen)
    go = torch.randn((n, GCN_WIDTHS[0]), device=DEVICE, generator=gen)
    ha, hb = h.clone().requires_grad_(True), h.clone().requires_grad_(True)
    got = torch.autograd.grad(_GcnAggregate.apply(ha, r.fwd, r.bwd), ha, go)[0]
    want = torch.autograd.grad(spmm_rows_ref(r.fwd, hb) + spmm_rows_ref(r.bwd, hb), hb, go)[0]
    rel = row_rel_err(got, want)
    check(rel <= GNN_TOL, f"K4 backward at minibatch_lg: {rel!r} of the row scale from "
          f"autograd of spmm_rows_ref, beyond {GNN_TOL}")
    bwd_ms = device_time_ms(lambda: gather_segsum(r.bwd, go, n) + gather_segsum(r.fwd, go, n))
    out_p = spmm_rows_ref(r.fwd, hb) + spmm_rows_ref(r.bwd, hb)
    plain_ms = device_time_ms(lambda: torch.autograd.grad(out_p, hb, go, retain_graph=True))
    out.update(k4_backward_err_over_row_scale=rel, k4_backward_ms=bwd_ms,
               plain_backward_ms=plain_ms)
    log("15b gcn-cora train on ogb_products: " + " ".join(
        f"{k}={v!r}" for k, v in out.items() if k != "profile"))
    del gb, r, h, go, ha, hb, got, want, out_p
    torch.cuda.empty_cache()
    return out


def lm_train_flops(cfg, B: int, S: int) -> float:
    """``repro.launch.cells._lm_train_cell``'s model FLOPs of one step:
    ``6 N B S`` plus the causal attention term."""
    attn = 2 * 3 * cfg.n_layers * B * S * S // 2 * cfg.n_heads * cfg.d_head
    return 6 * cfg.n_active_params * B * S + attn


def range_ms(prof, name: str) -> float:
    """Device ms of the kernels launched inside the ``record_function``
    ranges called ``name`` of a trace (the profiler's ``device_time_total``
    of the range)."""
    from torch.autograd import DeviceType

    return sum(e.device_time_total for e in prof.events()
               if e.name == name and e.device_type == DeviceType.CPU) / 1e3


def step_breakdown(prof, wall_ms: float) -> dict:
    """Where one traced train step's device time goes: its kernels by name
    into K3's forward (``flash_fwd_kernel``), the float32 products (the
    plain attention backward's: ``f32f32``/``sgemm``), the other products
    (``nvjet``/``gemm``/``cutlass``/``xmma``: bf16) and the rest
    (elementwise, reductions, copies); the device time of the
    ``flash_attention_backward`` ranges; the device's idle share; the top
    kernels."""
    from torch.autograd import DeviceType

    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and e.name not in ANNOTATIONS]
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    check(busy > 0, "step trace: no device time recorded")
    part = {"k3_forward": 0.0, "products_f32": 0.0, "products_bf16": 0.0, "rest": 0.0}
    top: dict = {}
    for e in kern:
        n, ms = e.name, e.time_range.elapsed_us() / 1e3
        key = ("k3_forward" if "flash_fwd_kernel" in n else "products_f32"
               if "f32f32" in n or "sgemm" in n else "products_bf16"
               if any(x in n for x in ("nvjet", "gemm", "cutlass", "xmma")) else "rest")
        part[key] += ms
        top[n] = (top.get(n, (0.0, 0))[0] + ms, top.get(n, (0.0, 0))[1] + 1)
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "idle_share": 1 - busy / wall_ms,
            **{f"{k}_ms": v for k, v in part.items()},
            **{f"{k}_share": v / busy for k, v in part.items()},
            **{f"range_{n}_ms": range_ms(prof, n) for n in ANNOTATIONS},
            "top": [(k[:90], ms, n) for k, (ms, n) in sorted(top.items(),
                                                             key=lambda kv: -kv[1][0])[:15]]}


def train_attention(seed: int) -> dict:
    """K3's Function at 15c's attention shape (B 1, S 4,096, Hq 40 / Hkv 8,
    D 128, bf16, causal): the forward (K3's tensor-core body) and dq, dk,
    dv against autograd of ``attention_ref`` in float32, normwise; the
    device times of K3 and of the plain backward."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention_bwd_ref
    from repro_torch.kernels.flash_attention import ops as k3_ops

    cfg = get_config(LM_ARCH)
    B, S, Hq, Hkv, D = TRAIN_LM_BATCH, TRAIN_LM_SEQ, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    mk = lambda *s: torch.randn(s, device=DEVICE, generator=gen).to(torch.bfloat16)
    q, k, v, do = mk(B, Hq, S, D), mk(B, Hkv, S, D), mk(B, Hkv, S, D), mk(B, Hq, S, D)
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    n0 = k3_ops.launches
    o = k3_ops.FlashAttention.apply(*ins, True, None, cfg.q_block, cfg.kv_block)
    grads = torch.autograd.grad(o, ins, do)
    check(k3_ops.launches == n0 + 1, "15c: the Function's forward did not launch K3")
    ref = [t.float().requires_grad_(True) for t in (q, k, v)]
    o_ref = attention_ref(*ref)
    want = torch.autograd.grad(o_ref, ref, do.float())
    out = {"forward_band_err": band_rel_err(o.detach(), o_ref.detach())}
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        out[f"{name}_rel_err"] = float((g.float() - w).norm() / w.norm())
    del ref, o_ref, want
    for key, val in out.items():
        check(val <= TRAIN_ATTN_TOL, f"15c attention {key}: {val!r} beyond {TRAIN_ATTN_TOL}")
    fwd_ms = device_time_ms(lambda: k3_ops.flash_attention(q, k, v), calls=10)
    bwd_ms = device_time_ms(lambda: flash_attention_bwd_ref(q, k, v, do, block_q=cfg.q_block),
                            calls=3)
    out.update(k3_forward_ms=fwd_ms, plain_backward_ms=bwd_ms,
               plain_backward_flops=5 * 2 * B * Hq * D * sum(
                   min(S, q0 + cfg.q_block) * min(cfg.q_block, S - q0)
                   for q0 in range(0, S, cfg.q_block)))
    log("15c K3 Function at " + f"B {B} S {S} Hq {Hq} Hkv {Hkv} D {D} bf16: " + " ".join(
        f"{k}={v!r}" for k, v in out.items()) + f" (tolerance {TRAIN_ATTN_TOL})")
    del q, k, v, do, ins, o, grads
    torch.cuda.empty_cache()
    return out


def train_lm(seed: int, attn_bwd_ms: float, n_layers: int = TRAIN_LM_LAYERS) -> dict:
    """15c: qwen3-14b at its published widths, ``n_layers`` deep, random
    seeded weights, trained three steps on one 4,096-token sequence: K3's
    launches (two a layer a step: the forward and the remat recomputation,
    on the tensor-core body), finite loss and grad_norm, every parameter
    leaf changed by step 1, ``lr`` equal to ``cosine_lr``'s; the step's
    seconds, tokens/s, model-FLOP share of 989 TFLOP/s, peak memory, a
    trace of a fourth step, and its gradient and AdamW halves timed apart
    (events), beside ``n_layers`` times ``attn_bwd_ms``, the plain
    attention backward timed alone at the step's shape."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as k3_ops
    from repro_torch.models import TransformerLM, lm_loss
    from repro_torch.train import (AdamConfig, adamw_update, cosine_lr, init_train_state,
                                   make_train_step)

    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=n_layers)
    B, S = TRAIN_LM_BATCH, TRAIN_LM_SEQ
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = TransformerLM(cfg, device=DEVICE,
                          generator=torch.Generator(device=DEVICE).manual_seed(seed))
    adam = AdamConfig(**TRAIN_LM_ADAM)
    state = init_train_state(model)
    state_gb = sum(t.numel() * t.element_size() for t in model.parameters()) * 6 / 1e9
    log(f"15c {cfg.name}: {n_layers} of 40 layers, {cfg.n_params} parameters; params, "
        f"grads, m and v {state_gb!r} GB")
    before = {n: p.detach().to("cpu", copy=True) for n, p in model.named_parameters()}
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S))).to(DEVICE)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
    step = make_train_step(lambda m, b: lm_loss(m, b["tokens"], b["labels"]), adam)
    k3_ops.launches = k3_ops.simt_launches = 0
    times, losses = [], []
    for i in range(TRAIN_STEPS):
        sync()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        sync()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        check(math.isfinite(losses[-1]) and math.isfinite(float(m["grad_norm"])),
              f"15c step {i + 1}: loss {losses[-1]!r}, grad_norm {float(m['grad_norm'])!r}")
        lr = float(cosine_lr(adam, i + 1))
        check(float(m["lr"]) == lr, f"15c step {i + 1}: lr {float(m['lr'])!r}, cosine_lr {lr!r}")
        if i == 0:
            same = [n for n, p in model.named_parameters() if torch.equal(p.detach().cpu(),
                                                                          before[n])]
            check(not same, f"15c: step 1 left {len(same)} leaves unchanged: {same[:4]!r}")
            del before
    launches, simt = k3_ops.launches, k3_ops.simt_launches
    check(launches == 2 * n_layers * TRAIN_STEPS and simt == 0,
          f"15c: K3 launched {launches} times (SIMT {simt}), expected "
          f"{2 * n_layers * TRAIN_STEPS} on the tensor-core body")
    peak = torch.cuda.max_memory_allocated()
    step_s = statistics.median(times[1:])
    flops = lm_train_flops(cfg, B, S)
    out = {"n_layers": n_layers, "n_params": cfg.n_params, "state_gb": state_gb,
           "step_s": times, "step_s_median_2_3": step_s, "tokens_per_s": B * S / step_s,
           "model_tflop": flops / 1e12, "share_of_989_tflops": flops / step_s / BF16_FLOPS_PER_S,
           "max_memory_allocated_gb": peak / 1e9,
           "total_memory_gb": torch.cuda.get_device_properties(0).total_memory / 1e9,
           "losses": losses, "k3_launches": launches, "k3_launches_per_step": launches /
           TRAIN_STEPS, "k3_simt_launches": simt}
    log("15c main path: " + " ".join(f"{k}={v!r}" for k, v in out.items()))

    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        sync()
        wall = time.perf_counter() - t0
    prof_out = step_breakdown(prof, 1e3 * wall)
    out["profile"] = prof_out
    # the step's two halves timed apart (CUDA events, two calls each): the
    # gradient (forward, remat and backward) and the AdamW update
    leaves = list(model.parameters())
    names = [n for n, _ in model.named_parameters()]

    def grads():
        with torch.enable_grad():
            loss, _ = lm_loss(model, batch["tokens"], batch["labels"])
            return dict(zip(names, torch.autograd.grad(loss, leaves)))

    out["gradient_ms"] = cuda_time_ms(grads, reps=2, warmup=0)
    g = grads()
    out["adamw_ms"] = cuda_time_ms(lambda: adamw_update(state, g, adam), reps=2, warmup=0)
    out["attention_backward_ms_x_layers"] = n_layers * attn_bwd_ms
    log(f"15c step halves: gradient {out['gradient_ms']!r} ms, AdamW {out['adamw_ms']!r} ms, "
        f"the plain attention backward x {n_layers} layers "
        f"{out['attention_backward_ms_x_layers']!r} ms")
    del g
    log("15c traced step: " + " ".join(f"{k}={v!r}" for k, v in prof_out.items()
                                       if k != "top"))
    for k, ms, n in prof_out["top"]:
        log(f"  {ms:.4f} ms  {n}x  {k}")
    del model, state, step, batch, tokens, prof
    torch.cuda.empty_cache()
    return out


def train_resume(seed: int) -> dict:
    """15d: the qwen3-14b smoke LM (float32, dense) on the card: 4 steps
    straight against 2 steps, a ``CheckpointManager`` save, a restore into
    a fresh state and 2 more steps, bit for bit."""
    import shutil

    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.ft import CheckpointManager, latest_step, load_pytree
    from repro_torch.models import TransformerLM, lm_loss
    from repro_torch.train import AdamConfig, init_train_state, make_train_step

    cfg = get_smoke_config(LM_ARCH)
    cpu = TransformerLM(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))

    def fresh():
        m = TransformerLM(cfg, device=DEVICE, init=False)
        m.load_state_dict(cpu.state_dict())
        return init_train_state(m)

    tokens = torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab, (2, 24)))
    batch = {"tokens": tokens.to(DEVICE), "labels": torch.roll(tokens, -1, dims=1).to(DEVICE)}
    step = make_train_step(lambda m, b: lm_loss(m, b["tokens"], b["labels"]),
                           AdamConfig(**TRAIN_ADAM))
    a = fresh()
    for _ in range(4):
        a, _ = step(a, batch)
    directory = ROOT / "build" / "phase15_checkpoints"
    shutil.rmtree(directory, ignore_errors=True)
    b = fresh()
    mgr = CheckpointManager(str(directory), keep=1, every_steps=2)
    t0 = time.perf_counter()
    for i in range(1, 3):
        b, _ = step(b, batch)
        mgr.maybe_save(b, i)
    mgr.wait()
    mgr.check()
    save_s = time.perf_counter() - t0
    check(latest_step(str(directory)) == 2, f"15d: latest step {latest_step(str(directory))}")
    b = load_pytree(fresh(), str(directory))
    mgr.close()
    check(int(b.step) == 2 and b.params.device.type == "cuda", "15d: restored state")
    for _ in range(2):
        b, _ = step(b, batch)
    pairs = [(f"params {n}", p, b.params.get_parameter(n)) for n, p in a.params.named_parameters()]
    pairs += [(f"{f} {n}", x, getattr(b, f)[n]) for f in ("m", "v")
              for n, x in getattr(a, f).items()]
    differ = [k for k, x, y in pairs if not torch.equal(x, y)]
    check(not differ and int(a.step) == int(b.step) == 4,
          f"15d: resumed run differs from the straight run in {differ[:4]!r}")
    shutil.rmtree(directory, ignore_errors=True)
    out = {"leaves_compared": len(pairs), "steps": 4, "saved_at": 2, "save_and_wait_s": save_s}
    log(f"15d checkpoint round trip on the card: {len(pairs)} leaves bit for bit after "
        f"2 + restore + 2 steps against 4 straight")
    return out


def phase_train(seed: int, kept: dict) -> dict:
    """Phase 15: 15a cuda against cpu, 15b gcn-cora on ogbn-products, 15c
    qwen3-14b at full width, 15d a checkpoint round trip."""
    import torch

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products as on the cpu
    out = {"parity": train_parity(seed)}
    log(f"15a: {time.perf_counter() - t0!r} s")
    t1 = time.perf_counter()
    out["gcn_cora"] = train_gcn(seed, kept)
    log(f"15b: {time.perf_counter() - t1!r} s")
    t1 = time.perf_counter()
    out["attention"] = train_attention(seed)
    out["qwen3_14b"] = train_lm(seed, out["attention"]["plain_backward_ms"])
    log(f"15c: {time.perf_counter() - t1!r} s")
    t1 = time.perf_counter()
    out["resume"] = train_resume(seed)
    log(f"15d: {time.perf_counter() - t1!r} s")
    out["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# phase 16: two-tower retrieval at full width, the cell matrix, the launcher
# ---------------------------------------------------------------------------

TT_ARCH = "two-tower-retrieval"
TT_SEED = 0
TT_SAMPLE = 256  # rows of each traffic recomputed in float64
# a score's distance from its float64 recomputation (and bulk's from p99's,
# and cuda's from cpu's), as a share of temp (the largest |score|): float32
# products over fan-ins up to 2,048, no TF32 (which would be ~1e-3)
TT_TOL = 1e-4
TT_TOP_K = 100
TT_TIMED = 10  # calls a traffic is timed over
# 16b: the full config's widths, batch and vocabularies cut to one card:
# parameters, gradients, m and v take 4 x 61.44 GB at full vocabulary; at
# B 16,384 a step peaks 2.4 GB above them on the H100 (the forward's
# gathers and [B, B] logits come and go before the gradients exist), so a
# quarter of each vocabulary (rounded up to 128 rows: 61.5 GB of state,
# 63.9 GB at the peak) is the largest unit share under 90 % of 80 GB; a
# third would hold 81.9 GB of state alone
TT_TRAIN_BATCH = 16_384
TT_TRAIN_VOCAB_DIV = 4
TT_TRAIN_STEPS = 3
TT_TRAIN_ADAM = {"lr": 1e-3, "warmup_steps": 1, "weight_decay": 0.0}
# 16c: the smoke cells' LM logits on cuda (K3's SIMT body, float32) against
# cpu, as a share of each row's largest |logit|
CELL_LM_TOL = 1e-3
CELL_SEED = 0


def recsys_batch(cfg, B: int, rng, device):
    """A batch drawn as the recsys cells draw theirs (user lookups, then
    item lookups, from ``rng``; unit weights; ``log_q`` 0) on ``device``."""
    import torch

    from repro_torch.models.two_tower import RecsysBatch

    Fu, Fi, M = cfg.n_user_fields, cfg.n_item_fields, cfg.multi_hot
    draw = lambda V, F: torch.from_numpy(rng.integers(0, V, (B, F, M)).astype(np.int32))
    uidx, iidx = draw(cfg.user_vocab, Fu), draw(cfg.item_vocab, Fi)
    return RecsysBatch(user_idx=uidx.to(device), user_wt=torch.ones((B, Fu, M), device=device),
                       item_idx=iidx.to(device), item_wt=torch.ones((B, Fi, M), device=device),
                       log_q=torch.zeros(B, device=device))


def tower64(table, mlp, idx, wt, n_layers: int):
    """A tower in float64 from the same table rows and weights."""
    import torch

    rows = table[idx.long()].double() * wt.double()[..., None]  # [s, F, M, D]
    x = rows.sum(dim=2).reshape(idx.shape[0], -1)
    for i in range(n_layers):
        x = x @ mlp[f"w{i}"].double() + mlp[f"b{i}"].double()
        if i < n_layers - 1:
            x = torch.relu(x)
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-9)


def scores64(params, batch, rows, cfg):
    """float64 ``score_pairs`` of ``rows`` of ``batch``."""
    L = len(cfg.tower_mlp)
    u = tower64(params["user_table"], params["user_mlp"], batch.user_idx[rows],
                batch.user_wt[rows], L)
    it = tower64(params["item_table"], params["item_mlp"], batch.item_idx[rows],
                 batch.item_wt[rows], L)
    return (u * it).sum(dim=-1) * params["temp"].double()


def tt_close(name: str, got, want, temp: float) -> float:
    """``max |got - want|`` as a share of temp, checked against TT_TOL."""
    err = float((got.double().cpu() - want.double().cpu()).abs().max()) / temp
    check(math.isfinite(err) and err <= TT_TOL,
          f"{name}: {err!r} of temp from the reference, beyond {TT_TOL}")
    return err


def timed_calls(fn, n: int = TT_TIMED) -> float:
    """Median seconds of ``n`` calls of ``fn``, each to a synchronize."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def two_tower_serve(seed: int) -> dict:
    """16a: two-tower-retrieval's full config on the card (61.44 GB of
    float32 tables from a seeded generator): ``score_pairs`` at serve_p99
    and serve_bulk (serve_p99's rows repeated inside it), and
    ``retrieval_scores`` over retrieval_cand's 1,000,448 candidates, top
    100; each held to a float64 recomputation on the card, twice the same
    bits; times, rows/s, peak memory and a traced serve_bulk call."""
    import torch

    from repro_torch.configs import RECSYS_SHAPES, get_config
    from repro_torch.models.two_tower import (RecsysBatch, init_two_tower_params,
                                              retrieval_scores, score_pairs, user_tower)

    cfg = get_config(TT_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_two_tower_params(cfg, device=DEVICE,
                                   generator=torch.Generator(device=DEVICE).manual_seed(seed))
    sync()
    table_gb = sum(params[k].numel() * 4 for k in ("user_table", "item_table")) / 1e9
    log(f"16a: {TT_ARCH} at full width: tables {table_gb!r} GB drawn in "
        f"{time.perf_counter() - t0!r} s; allocated "
        f"{torch.cuda.memory_allocated() / 1e9!r} GB")
    temp = float(params["temp"])
    rng = np.random.default_rng(seed)
    B_p99, B_bulk = RECSYS_SHAPES["serve_p99"].batch, RECSYS_SHAPES["serve_bulk"].batch
    p99 = recsys_batch(cfg, B_p99, rng, DEVICE)
    bulk = recsys_batch(cfg, B_bulk, rng, DEVICE)
    at = torch.from_numpy(np.sort(rng.choice(B_bulk, B_p99, replace=False))).to(DEVICE)
    bulk = RecsysBatch(*(b.index_copy(0, at, p) for b, p in zip(bulk, p99)))
    out = {"table_gb": table_gb, "temp": temp}
    scores = {}
    for name, batch in (("serve_p99", p99), ("serve_bulk", bulk)):
        s1 = score_pairs(params, batch, cfg)
        s2 = score_pairs(params, batch, cfg)
        check(torch.equal(s1, s2), f"16a {name}: two runs differ")
        rows = torch.from_numpy(np.sort(rng.choice(batch.log_q.shape[0], TT_SAMPLE,
                                                   replace=False))).to(DEVICE)
        err = tt_close(f"16a {name} vs float64", s1[rows], scores64(params, batch, rows, cfg),
                       temp)
        sec = timed_calls(lambda: score_pairs(params, batch, cfg))
        B = batch.log_q.shape[0]
        out[name] = {"batch": B, "ms": sec * 1e3, "rows_per_s": B / sec,
                     "err_vs_float64_of_temp": err}
        scores[name] = s1
        log(f"16a {name}: B {B}, {sec * 1e3!r} ms a call (median of {TT_TIMED}), "
            f"{B / sec!r} rows/s; {TT_SAMPLE} rows within {err!r} of temp of float64 "
            f"(tolerance {TT_TOL}); two runs the same bits")
    out["bulk_vs_p99_of_temp"] = tt_close("16a serve_bulk's repeated rows vs serve_p99",
                                          scores["serve_bulk"][at], scores["serve_p99"], temp)

    # retrieval: one query against 1,000,448 candidate embeddings
    spec = RECSYS_SHAPES["retrieval_cand"]
    N = -(-spec.n_candidates // 512) * 512
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 1)
    cand = torch.randn((N, cfg.tower_mlp[-1]), generator=gen, device=DEVICE)
    q = recsys_batch(cfg, 1, rng, DEVICE)
    v1, i1 = retrieval_scores(params, q.user_idx, q.user_wt, cand, cfg, top_k=TT_TOP_K)
    v2, i2 = retrieval_scores(params, q.user_idx, q.user_wt, cand, cfg, top_k=TT_TOP_K)
    check(torch.equal(v1, v2) and torch.equal(i1, i2), "16a retrieval: two runs differ")
    u64 = tower64(params["user_table"], params["user_mlp"], q.user_idx, q.user_wt,
                  len(cfg.tower_mlp))[0]
    s64 = (cand.double() @ u64) * temp
    top64 = torch.topk(s64, TT_TOP_K + 1)
    err_v = tt_close("16a retrieval top-k vs float64", v1, s64[i1], temp)
    check(bool((v1[:-1] >= v1[1:]).all()), "16a retrieval: scores not in descending order")
    check(float(v1[-1]) >= float(top64.values[TT_TOP_K]) - TT_TOL * temp,
          f"16a retrieval: the 100th score {float(v1[-1])!r} is below the 101st "
          f"{float(top64.values[TT_TOP_K])!r}")
    missed = len(set(top64.indices[:TT_TOP_K].tolist()) - set(i1.tolist()))
    sec = timed_calls(lambda: retrieval_scores(params, q.user_idx, q.user_wt, cand, cfg,
                                               top_k=TT_TOP_K))
    sec_u = timed_calls(lambda: user_tower(params, q.user_idx, q.user_wt, cfg))
    out["retrieval_cand"] = {"candidates": N, "ms": sec * 1e3, "user_tower_ms": sec_u * 1e3,
                             "err_vs_float64_of_temp": err_v,
                             "float64_top100_not_returned": missed}
    log(f"16a retrieval_cand: {N} candidates, top {TT_TOP_K} in {sec * 1e3!r} ms a call "
        f"(the query's tower {sec_u * 1e3!r} ms), scores within {err_v!r} of temp of float64, "
        f"{missed} of float64's top {TT_TOP_K} not returned (near-ties at the cut); two runs "
        f"the same bits")
    out["trace_serve_bulk"] = trace("16a serve_bulk", 1, lambda: score_pairs(params, bulk, cfg),
                                    {"gather": "gather_kernel", "bag_sum": "reduce_kernel",
                                     "products": ("gemm", "gemv", "cutlass"),
                                     "elementwise": "elementwise_kernel"})
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"16a: peak memory {out['peak_gb']!r} GB")
    del params, bulk, p99, cand, scores
    torch.cuda.empty_cache()
    return out


def two_tower_smoke(seed: int) -> dict:
    """16a and 16b on the smoke config: serving on cuda against cpu from the
    same weights, and three train steps on each at the CPU tests'
    tolerances."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.models.two_tower import (init_two_tower_params, retrieval_scores,
                                              score_pairs, two_tower_loss)
    from repro_torch.train import AdamConfig, init_train_state, make_train_step

    cfg = get_smoke_config(TT_ARCH)
    cpu = init_two_tower_params(cfg, device="cpu",
                                generator=torch.Generator().manual_seed(seed))
    move = lambda tree: {k: move(v) if isinstance(v, dict) else v.to(DEVICE, copy=True)
                         for k, v in tree.items()}
    gpu = move(cpu)
    batch = recsys_batch(cfg, 64, np.random.default_rng(seed), "cpu")
    bg = type(batch)(*(x.to(DEVICE) for x in batch))
    temp = float(cpu["temp"])
    cand = torch.randn((512, cfg.tower_mlp[-1]), generator=torch.Generator().manual_seed(seed))
    out = {"score": tt_close("16a smoke score_pairs cuda vs cpu", score_pairs(gpu, bg, cfg),
                             score_pairs(cpu, batch, cfg), temp)}
    vg, ig = retrieval_scores(gpu, bg.user_idx[:1], bg.user_wt[:1], cand.to(DEVICE), cfg, 10)
    vc, ic = retrieval_scores(cpu, batch.user_idx[:1], batch.user_wt[:1], cand, cfg, 10)
    out["retrieval"] = tt_close("16a smoke retrieval cuda vs cpu", vg, vc, temp)
    check(torch.equal(ig.cpu(), ic), "16a smoke retrieval: top-10 indices differ")
    adam = AdamConfig(**TRAIN_ADAM, weight_decay=0.0)
    step = make_train_step(lambda p, b: two_tower_loss(p, b, cfg), adam)
    sg, sc = init_train_state(gpu), init_train_state(cpu)
    worst = 0.0
    with torch.enable_grad():
        for _ in range(TRAIN_STEPS):
            sg, mg = step(sg, bg)
            sc, mc = step(sc, batch)
            worst = max(worst, train_metrics_check("16b smoke cuda vs cpu", mg, mc))
    odd = train_params_check("16b smoke params", named_params(sg.params),
                             named_params(sc.params), adam.lr, False)
    out.update(train_metrics_rel_err=worst, train_odd_elements_max=odd)
    log(f"16a/16b smoke {TT_ARCH} cuda vs cpu: scores within {out['score']!r} of temp, "
        f"top-10 equal; {TRAIN_STEPS} train steps, metrics within {worst!r} relative, at most "
        f"{odd} odd elements a leaf")
    return out


def two_tower_train(seed: int) -> dict:
    """16b: the full config's widths at TT_TRAIN_BATCH rows and a
    TT_TRAIN_VOCAB_DIV-th of each vocabulary, TT_TRAIN_STEPS steps: step
    seconds, rows/s, peak memory, and every leaf changed by step 1."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.two_tower import init_two_tower_params, two_tower_loss
    from repro_torch.train import AdamConfig, init_train_state, make_train_step

    full = get_config(TT_ARCH)
    cut = lambda V: -(-V // TT_TRAIN_VOCAB_DIV // 128) * 128
    cfg = dataclasses.replace(full, user_vocab=cut(full.user_vocab),
                              item_vocab=cut(full.item_vocab))
    torch.cuda.reset_peak_memory_stats()
    params = init_two_tower_params(cfg, device=DEVICE,
                                   generator=torch.Generator(device=DEVICE).manual_seed(seed))
    state = init_train_state(params)
    batch = recsys_batch(cfg, TT_TRAIN_BATCH, np.random.default_rng(seed), DEVICE)
    step = make_train_step(lambda p, b: two_tower_loss(p, b, cfg), AdamConfig(**TT_TRAIN_ADAM))
    state_gb = 4 * sum(p.numel() * 4 for p in named_params(params).values()) / 1e9

    def sig():  # a leaf's float64 sum and sum of squares, a chunk of 2^25 elements at a time
        out = {}
        for k, x in named_params(state.params).items():
            s1 = s2 = 0.0
            for c in x.detach().reshape(-1).split(1 << 25):
                c = c.double()
                s1, s2 = s1 + c.sum(), s2 + c.square().sum()
            out[k] = (float(s1), float(s2))
        return out

    before = sig()
    torch.cuda.reset_peak_memory_stats()  # the steps' peak, with the state held
    secs, losses = [], []
    with torch.enable_grad():
        for i in range(TT_TRAIN_STEPS):
            t0 = time.perf_counter()
            state, m = step(state, batch)
            sync()
            secs.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
            if i == 0:
                after = sig()
                same = [k for k in before if before[k] == after[k]]
                check(not same, f"16b: leaves unchanged by step 1: {same!r}")
    check(all(math.isfinite(x) for x in losses), f"16b: losses {losses!r}")
    med = statistics.median(secs[1:])
    out = {"user_vocab": cfg.user_vocab, "item_vocab": cfg.item_vocab,
           "batch": TT_TRAIN_BATCH, "state_gb": state_gb, "step_s": secs,
           "step_s_median_2_3": med, "rows_per_s": TT_TRAIN_BATCH / med, "losses": losses,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "leaves_changed_by_step_1": len(before)}
    log(f"16b: {TT_ARCH} widths, vocabularies {cfg.user_vocab} / {cfg.item_vocab} (a "
        f"{TT_TRAIN_VOCAB_DIV}th), batch {TT_TRAIN_BATCH}: state {state_gb!r} GB, steps "
        f"{secs!r} s, {out['rows_per_s']!r} rows/s (median of steps 2-3), losses {losses!r}, "
        f"peak {out['peak_gb']!r} GB; all {len(before)} leaves changed by step 1")
    del params, state, batch
    torch.cuda.empty_cache()
    return out


def lm_rows_close(name: str, got, want, rows_out=()) -> float:
    rel = rows_rel_err(got, want, rows_out)
    check(rel <= CELL_LM_TOL, f"{name}: {rel!r} of the row scale, beyond {CELL_LM_TOL}")
    return rel


def cell_params_check(name: str, got: dict, want: dict, lr: float) -> int:
    """A train step's parameters, cuda against cpu: within 1 % of a step
    plus 2 ulps of the parameter, but for at most 2 elements of a leaf or
    0.1 % of them, each within ``2 lr``; returns the most odd elements."""
    import torch

    worst = 0
    for k, w in want.items():
        w = w.detach().float().cpu()
        d = (got[k].detach().float().cpu() - w).abs()
        ulp = torch.nextafter(w.abs(), torch.tensor(float("inf"))) - w.abs()
        odd = int((d > TRAIN_STEP_TOL * lr + 2 * ulp).sum())
        check(odd <= max(2, TRAIN_ODD[False] * d.numel()),
              f"{name} {k}: {odd} of {d.numel()} elements off")
        check(float(d.max()) <= 2 * lr, f"{name} {k}: {float(d.max())!r}")
        worst = max(worst, odd)
    return worst


def cell_parity(arch: str, shape: str, seed: int) -> dict:
    """One smoke cell (``build_cell(..., concrete=True, smoke=True)``) on cpu
    and the same cell moved to cuda (``Cell.to``): the step on each, the
    outputs compared (a train step at the CPU tests' rule, LM logits within
    CELL_LM_TOL of the row scale, scores within TT_TOL of temp, the Spade
    cells bit for bit), the MoE routing held to rule 1.  Returns what was
    compared and the cuda run's K3 and K4 launches."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention import ops as k3_ops
    from repro_torch.kernels.gather_segsum import ops as k4_ops
    from repro_torch.launch.cells import build_cell

    cpu = build_cell(arch, shape, concrete=True, smoke=True, seed=seed, device="cpu")
    gpu = cpu.to(DEVICE)
    cfg = get_smoke_config(arch)
    name = f"16c {arch} {shape}"
    moe = getattr(cfg, "moe", None) is not None
    rec_g, rec_c = [], []
    k3, k4 = k3_ops.simt_launches + k3_ops.launches, k4_ops.launches
    with torch.set_grad_enabled(cpu.step_name == "train_step"):
        with routing_recorded(rec_g):
            g = gpu.fn(*gpu.args)
        sync()
        k3, k4 = k3_ops.simt_launches + k3_ops.launches - k3, k4_ops.launches - k4
        with routing_recorded(rec_c):
            c = cpu.fn(*cpu.args)
    out = {"step": cpu.step_name, "k3_launches": k3, "k4_launches": k4}
    rows = set()
    if moe:
        n_rows = (cpu.args[1]["tokens"] if cpu.step_name == "train_step" else cpu.args[-2]
                  if cpu.step_name == "decode_step" else cpu.args[1]).shape[0]
        r = routing_check(name, rec_g, rec_c, n_rows)
        rows = r["rows"]
        out["routing"] = {k: (sorted(v) if k == "rows" else v) for k, v in r.items()}
    if cpu.step_name == "train_step":
        check(not rows, f"{name}: tokens routed differently on cuda and cpu")
        (sg, mg), (sc, mc) = g, c
        out["metrics_rel_err"] = train_metrics_check(name, mg, mc)
        out["odd_elements_max"] = cell_params_check(name, named_params(sg.params),
                                                    named_params(sc.params), float(mc["lr"]))
    elif cpu.step_name in ("prefill", "decode_step"):
        out["logits_rel_err"] = lm_rows_close(name, g[0], c[0], rows)
        keep = [b for b in range(c[0].shape[0]) if b not in rows]
        out["cache_rel_err"] = 0.0
        for k in ("k", "v"):  # [L, B, W, Hkv, Dh]; unwritten slots hold 0 on both
            gk, ck = (getattr(x[1], k)[:, keep].float().cpu() for x in (g, c))
            rel = float((gk - ck).abs().max()) / max(float(ck.abs().max()), 1e-30)
            check(rel <= CELL_LM_TOL, f"{name} cache {k}: {rel!r} of its scale, beyond "
                  f"{CELL_LM_TOL}")
            out["cache_rel_err"] = max(out["cache_rel_err"], rel)
    elif cpu.step_name == "score_pairs":
        out["err_of_temp"] = tt_close(name, g, c, float(cpu.args[0]["temp"]))
    elif cpu.step_name == "retrieval":
        out["err_of_temp"] = tt_close(name, g.values, c.values, float(cpu.args[0]["temp"]))
        check(torch.equal(g.indices.cpu(), c.indices), f"{name}: top-k indices differ")
    elif cpu.step_name == "bulk_peel":
        for f in ("level", "best_level", "best_g", "n_rounds", "delta"):
            check(torch.equal(getattr(g, f).cpu(), getattr(c, f)), f"{name}: {f} differs")
    else:
        for f in ("level", "best_g", "community", "edge_count", "w0"):
            check(torch.equal(getattr(g, f).cpu(), getattr(c, f)), f"{name}: {f} differs")
        for f in ("src", "dst", "c", "edge_mask"):
            check(torch.equal(getattr(g.graph, f).cpu(), getattr(c.graph, f)),
                  f"{name}: graph {f} differs")
    return out


def spade_cells_full(seed: int) -> dict:
    """16c's Spade cells at full width (the spade-grab capacities rounded
    up to 512): each step with K1's, K2's and ``suffix_init``'s counters set
    to 0 just before and read just after, then the same step again, which
    must give the same bits."""
    import torch

    from repro_torch.launch.cells import build_cell

    out = {}
    for shape in ("grab4_static", "grab4_stream"):
        t0 = time.perf_counter()
        cell = build_cell("spade-grab", shape, concrete=True, seed=seed, device=DEVICE)
        sync()
        build_s = time.perf_counter() - t0
        zero_kernel_counts()
        t0 = time.perf_counter()
        first = cell.fn(*cell.args)
        sync()
        step_s = time.perf_counter() - t0
        counts = kernel_counts()
        second = cell.fn(*cell.args)
        fields = (("level", "best_level", "best_g", "n_rounds", "delta")
                  if shape == "grab4_static"
                  else ("level", "best_g", "community", "edge_count", "w0"))
        for f in fields:
            check(torch.equal(getattr(first, f), getattr(second, f)),
                  f"16c spade-grab {shape}: {f} differs between two runs")
        if shape == "grab4_stream":
            for f in ("src", "dst", "c", "edge_mask"):
                check(torch.equal(getattr(first.graph, f), getattr(second.graph, f)),
                      f"16c spade-grab {shape}: graph {f} differs between two runs")
        check(all(counts[k] > 0 for k in ("peel_round", "frontier_spmv", "suffix_init")),
              f"16c spade-grab {shape}: a kernel never launched: {counts!r}")
        g = cell.args[0] if shape == "grab4_static" else cell.args[0].graph
        out[shape] = {"n_capacity": g.n_capacity, "e_capacity": g.e_capacity,
                      "edges": int(g.edge_mask.sum()), "best_g": float(first.best_g),
                      "launches": {k: counts[k] for k in
                                   ("peel_round", "frontier_spmv", "suffix_init")},
                      "build_s": build_s, "step_s": step_s}
        log(f"16c spade-grab {shape} at full width ({g.n_capacity} vertices, "
            f"{g.e_capacity} edge slots): {cell.step_name} in {step_s!r} s, best_g "
            f"{float(first.best_g)!r}, launches {out[shape]['launches']!r}; a second run "
            f"the same bits")
        del cell, first, second, g
    torch.cuda.empty_cache()
    return out


def cells_matrix(seed: int) -> dict:
    """16c: every cell of ``all_cells()`` at smoke size, cuda against cpu
    (the four long_500k skips counted), then the Spade cells at full width."""
    from repro_torch.configs import Skip, all_cells

    out = {"smoke": {}, "skips": 0, "k3_launches": 0, "k4_launches": 0}
    for arch, shape, spec in all_cells():
        if isinstance(spec, Skip):
            out["skips"] += 1
            continue
        r = cell_parity(arch, shape, seed)
        out["smoke"][f"{arch}/{shape}"] = r
        out["k3_launches"] += r["k3_launches"]
        out["k4_launches"] += r["k4_launches"]
    log(f"16c: {len(out['smoke'])} smoke cells cuda == cpu within their tolerances, "
        f"{out['skips']} skips; K3 launches {out['k3_launches']}, K4 {out['k4_launches']}; "
        "LM logits within " + repr(max((r.get("logits_rel_err", 0.0)
                                        for r in out["smoke"].values()))) +
        f" of the row scale (tolerance {CELL_LM_TOL})")
    out["spade_full"] = spade_cells_full(seed)
    return out


def launcher_resume(seed: int) -> dict:
    """16d: ``repro_torch.launch.train``'s ``main`` on cuda for the smoke
    qwen3-14b, checkpoints under ``build/``: 4 steps straight against 2, a
    fresh start that resumes, and 2 more; the final states the same bits."""
    import shutil

    import torch

    from repro_torch import pytree
    from repro_torch.convert import train_state_to_reference
    from repro_torch.launch import train

    base = ROOT / "build" / "phase16_launcher"
    shutil.rmtree(base, ignore_errors=True)
    common = ["--arch", LM_ARCH, "--smoke", "--device", DEVICE, "--ckpt-every", "2",
              "--seed", str(seed)]
    t0 = time.perf_counter()
    with torch.enable_grad():
        a = train.main(common + ["--steps", "4", "--ckpt-dir", str(base / "straight")])
        train.main(common + ["--steps", "2", "--ckpt-dir", str(base / "resumed")])
        b = train.main(common + ["--steps", "2", "--ckpt-dir", str(base / "resumed")])
    leaves = lambda s: dict(pytree.leaves_with_path(train_state_to_reference(s)))
    la, lb = leaves(a), leaves(b)
    differ = [pytree.keystr(k) for k in la if not torch.equal(la[k], lb[k])]
    check(not differ and int(a.step) == int(b.step) == 4,
          f"16d: the resumed run differs from the straight run in {differ[:4]!r}")
    shutil.rmtree(base, ignore_errors=True)
    out = {"leaves_compared": len(la), "seconds": time.perf_counter() - t0}
    log(f"16d: the launcher on {DEVICE}: 4 steps straight and 2 + resume + 2, {len(la)} "
        f"leaves bit for bit")
    return out


def phase_cells(seed: int) -> dict:
    """Phase 16: 16a two-tower serving at full width, 16b two-tower
    training, 16c the cell matrix, 16d the launcher."""
    import torch

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products as on the cpu
    torch.cuda.empty_cache()
    log(f"phase 16: {torch.cuda.memory_allocated() / 1e9!r} GB allocated at the start")
    out = {"serve": two_tower_serve(seed)}
    out["smoke"] = two_tower_smoke(seed)
    out["train"] = two_tower_train(seed)
    t1 = time.perf_counter()
    out["cells"] = cells_matrix(CELL_SEED)
    log(f"16c: {time.perf_counter() - t1!r} s")
    out["launcher"] = launcher_resume(seed)
    out["seconds"] = time.perf_counter() - t0
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

    torch.set_grad_enabled(False)  # serving and the engine; phase 15 turns it on

    load_grab_config()

    t_start = time.perf_counter()
    smi = nvidia_smi()
    log(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # phase 1: build every kernel (one nvcc per source, in parallel)
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"phase 1: built {sorted(libs)} in {build_s!r} s; per source (nvcc in parallel): "
        + ", ".join(f"{k} {v!r} s" for k, v in sorted(_build.BUILD_SECONDS.items())))
    for stem, text in sorted(_build.BUILD_LOG.items()):
        for line in text.splitlines():
            if ("registers" in line or "spill" in line or "error" in line
                    or (stem == "flash_attention" and "entry function" in line)):
                log(f"  nvcc[{stem}]: {line.strip()}")
    from repro_torch.kernels.flash_attention import ops as k3_ops

    log("  K3 dynamic shared memory per CTA: " + ", ".join(
        f"D {d}: {k3_ops.smem_bytes(d)} bytes" for d in k3_ops.HEAD_DIMS))

    from repro_torch.configs import SPADE_SHAPES
    from repro_torch.graphstore.generators import make_transaction_stream

    t0 = time.perf_counter()
    # Grab4's 6,023,000 vertices; 27.8M background edges, 90 % of which
    # (with the two standing dense blocks, ~25.0M) form the base graph
    stream = make_transaction_stream(n=SPADE_SHAPES["grab4_stream"].n_nodes,
                                     m=27_800_000, seed=0)
    log(f"grab4 stream generated in {time.perf_counter() - t0!r} s")

    rec = phase_kernels({"src": stream.base_src.astype(np.int32),
                         "dst": stream.base_dst.astype(np.int32)})
    log("phase 2: kernels agree with their plain versions")
    phase_parity()
    log("phase 3: service parity cuda==cpu")
    grab = phase_grab(stream, max(args.ticks, 32))
    log("phase 4: grab4 main path ran through both kernels")
    grab["profile"], tick = phase_profile(stream, args.profile_ticks)
    grab["tick_rounds"] = tick
    log("phase 5: a tick's K2 rounds and prologue recorded and timed"
        + (", and the tick traced" if args.profile_ticks else ""))

    t_lm = time.perf_counter()
    attn, attn_norm = phase_attention(LM_SEED)
    attn_simt = phase_attention_simt(LM_SEED)
    log("phase 6: K3's two bodies agree with their plain versions")
    lm_parity = phase_lm_parity(LM_SEED)
    log("phase 7: LM cuda==cpu within tolerance, the smoke configs through K3's SIMT body")
    lm = phase_lm_full(LM_SEED)
    log(f"phase 8: qwen3-14b main path ran through K3; phases 6-8 took "
        f"{time.perf_counter() - t_lm!r} s")

    t_gnn = time.perf_counter()
    kept = {}  # the ogb_products graph, from phase 9 to phase 11, and its rows to 15b
    k4, k4_cases = phase_k4(GNN_SEED, kept)
    log("phase 9: K4 agrees with its plain versions")
    gnn_parity, gcn_cpu_logits = phase_gnn_parity(GNN_SEED)
    log("phase 10: GNN forward cuda==cpu within tolerance")
    gcn = phase_gcn(GNN_SEED, gcn_cpu_logits, kept)
    log(f"phase 11: gcn-cora main path ran through K4; phases 9-11 took "
        f"{time.perf_counter() - t_gnn!r} s")

    # phase 15 runs here, so that 15b trains on phase 11's ogbn-products
    # graph and rows, which phase 14's memory could not share the card with
    with torch.enable_grad():
        train = phase_train(LM_SEED, kept)
    t15 = train["qwen3_14b"]
    log(f"phase 15: trained on {smi}: the smoke LMs and GNN kinds cuda == cpu, gcn-cora on "
        f"ogbn-products ({train['gcn_cora']['k4_launches_per_step']!r} K4 launches a step), "
        f"{LM_ARCH} at {t15['n_layers']} layers ({t15['k3_launches_per_step']!r} K3 launches "
        f"a step, {t15['step_s_median_2_3']!r} s a step), a checkpoint round trip bit for "
        f"bit; {train['seconds']!r} s")

    # phase 12 launches K1, K2 and suffix_init off the main path: counted
    # apart from the main-path counts of the kernels line
    from repro_torch.kernels.frontier_spmv import ops as k2_ops
    from repro_torch.kernels.peel_round import ops as k1_ops

    t_cross = time.perf_counter()
    k1_ops.launches = k2_ops.launches = k2_ops.suffix_init_launches = 0
    cross = phase_cross_plane(smi)
    cross["launches"] = {"peel_round": k1_ops.launches, "frontier_spmv": k2_ops.launches,
                         "suffix_init": k2_ops.suffix_init_launches}
    check(all(cross["launches"].values()),
          f"phase 12: a kernel never launched: {cross['launches']!r}")
    log(f"phase 12: host plane == device plane tick by tick, exact_peel == static_peel; "
        f"{time.perf_counter() - t_cross!r} s on {smi}; launches off the main path "
        f"{cross['launches']!r}")

    # phase 13 launches K1, K2 and suffix_init off the main path too (13a in
    # this process, 13b and 13c in spawned ranks): logged apart
    sharded = phase_sharded(stream)
    del stream
    log(f"phase 13: the edge-sharded engine on {smi}: world 1 (nccl) and world 2 (gloo) "
        f"held against the single-device engine at Grab4 width, world 4 (gloo) cuda == "
        f"cpu; {sharded['seconds']!r} s")

    moe = phase_moe(LM_SEED)
    log(f"phase 14: the MoE LMs at full width through K3 on {smi}: "
        + ", ".join(f"{a} {moe[a]['n_layers']} layers, {moe[a]['k3_launches']} K3 launches "
                    f"a prefill" for a in MOE_LAYERS) + f"; {moe['seconds']!r} s")

    kept.clear()  # phase 16 puts 61.44 GB of tables on the card
    cells = phase_cells(LM_SEED)
    serve16, train16 = cells["serve"], cells["train"]
    log(f"phase 16 on {smi}: {TT_ARCH} served at full width ("
        f"{serve16['table_gb']!r} GB of tables; serve_p99 {serve16['serve_p99']['ms']!r} ms, "
        f"serve_bulk {serve16['serve_bulk']['rows_per_s']!r} rows/s, retrieval_cand "
        f"{serve16['retrieval_cand']['ms']!r} ms) and trained at a "
        f"{TT_TRAIN_VOCAB_DIV}th of its vocabularies ({train16['step_s_median_2_3']!r} s a "
        f"step of {TT_TRAIN_BATCH} rows); {len(cells['cells']['smoke'])} smoke cells cuda == "
        f"cpu, the Spade cells at full width, the launcher's resume bit for bit; "
        f"{cells['seconds']!r} s")

    for mod in ("jax", "repro"):
        check(mod not in sys.modules, f"{mod} was imported")

    k3_paths = {"qwen3-14b": lm["k3_launches"],
                **{a: moe[a]["k3_launches"] for a in MOE_LAYERS},
                "qwen3-14b-train": train["qwen3_14b"]["k3_launches"]}
    simt_paths = {"smoke": lm_parity["smoke_configs"]["simt_launches"],
                  "smoke-train": train["parity"]["simt_launches"]}
    k4_paths = {"gcn-cora": gcn["launches"], "gcn-cora-train": train["gcn_cora"]["k4_launches"]}
    simt_paths["cells"] = cells["cells"]["k3_launches"]  # the smoke LM cells: float32
    k4_paths["cells"] = cells["cells"]["k4_launches"]
    spade_cells = cells["cells"]["spade_full"]
    spade_paths = {k: {"grab4_engines": grab["launches"][k],
                       "spade_cells": sum(c["launches"][k] for c in spade_cells.values())}
                   for k in ("peel_round", "frontier_spmv", "suffix_init")}
    kernels = [
        {"name": "peel_round", "route": "cuda",
         "source": "src/repro_torch/csrc/peel_round.cu",
         "replaces": "src/repro/kernels/peel_round/kernel.py:76",
         "launches": sum(spade_paths["peel_round"].values()),
         "launches_by_path": spade_paths["peel_round"], "bound_by": "bytes",
         "library_ms": None, **rec["peel_round"]},
        {"name": "frontier_spmv", "route": "cuda",
         "source": "src/repro_torch/csrc/frontier_spmv.cu",
         "replaces": "src/repro/core/peel.py:201",
         "launches": sum(spade_paths["frontier_spmv"].values()),
         "launches_by_path": spade_paths["frontier_spmv"], "bound_by": "bytes",
         "library_ms": None, **rec["frontier_spmv"]},
        {"name": "suffix_init", "route": "cuda",
         "source": "src/repro_torch/csrc/frontier_spmv.cu",
         "replaces": "src/repro/core/peel.py:324",
         "launches": sum(spade_paths["suffix_init"].values()),
         "launches_by_path": spade_paths["suffix_init"], "bound_by": "bytes",
         "library_ms": None, **tick["suffix_init"],
         **{f"f64_mode_{k}": v for k, v in rec["suffix_init_f64"].items()}},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:116",
         "launches": sum(k3_paths.values()), "launches_by_path": k3_paths,
         "bound_by": "operations", **attn,
         "max_abs_err": max([attn["max_abs_err"]]
                            + [moe["attention"][a]["max_abs_err"] for a in MOE_LAYERS]),
         "moe_shapes": {a: {k: moe["attention"][a][k] for k in
                            ("shape", "ms", "library_ms", "bound_ms", "max_abs_err")}
                        for a in MOE_LAYERS}},
        {"name": "flash_attention_simt", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:116",
         "launches": sum(simt_paths.values()), "launches_by_path": simt_paths, **attn_simt},
        {"name": "gather_segsum", "route": "cuda",
         "source": "src/repro_torch/csrc/gather_segsum.cu",
         "replaces": "src/repro/kernels/gather_segsum/kernel.py:72",
         "launches": sum(k4_paths.values()), "launches_by_path": k4_paths, **k4},
    ]
    log("kernels launched on their paths: " + ", ".join(
        f"{k['name']} {k['launches']}" for k in kernels))
    log(f"total seconds {time.perf_counter() - t_start!r}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": smi, "kernels": kernels, "grab4": grab, "attention": attn_norm,
             "attention_simt": attn_simt,
             "lm_parity": lm_parity,
             "qwen3_14b": lm, "gather_segsum": k4_cases, "gnn_parity": gnn_parity,
             "gcn_cora": gcn, "cross_plane": cross, "sharded": sharded, "moe": moe,
             "train": train, "cells": cells},
            indent=1,
            default=repr))
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
