#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100 for the
sm_90a kernels).

    python3 chip_smoke.py [--ticks N] [--profile-ticks N] [--out results.json]

Phases (any failure exits non-zero):

1. build the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a; the
   seconds of each source's build) and print the card's name and power
   limit; another process draws the Grab4 stream from the start, beside
   phase 1 and phases 6-11 and 15, and phases 2-5 run after them;
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
    eight comparisons run at once, a spawned process each, beside phase
    17 (whose two ranks leave the card's memory and most of the host's
    cores free).  The kernels' launches in phase 12 are logged apart from
    the main path's;
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
    the same four on cpu on phase 12a's stream, the same K2 check, run
    beside 19c (13b's single-device runs go beside its ranks' start).
    Phase 2 also
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
    train; phase 15 turns it on;
17. (run last; phase 8 keeps its outputs on the host for it) the dense
    LM serving path sharded on a ``DeviceMesh``: 17c first, then 17a, one
    ``nccl`` rank on a (data 1, model 1) mesh: phase 8's model, drawn
    again from its seed, through ``shard_cell`` (every parameter a DTensor
    whose one shard is the whole tensor), serving phase 8's traffic (2 x
    8,192-token prefill, 32 decode steps fed phase 8's greedy tokens): the
    prefill's logits and cache and every decode step's logits phase 8's
    bits, K3 40 launches a prefill; 17b, that model freed, the model at
    TP_LAYERS of its 40 layers drawn from phase 8's seed and run
    unsharded on the same traffic (the reference), then two ``gloo``
    ranks on the one card on a (data 1, model 2) mesh, each
    drawing that model in turn behind a barrier and
    keeping its shards: the same traffic, sequence-sharded attention (K3
    on each rank's 4,096 query rows, at ``q_offset`` 0 and 4,096), the
    logits within LM_TOL of the reference's row scale and the greedy tokens equal
    on every decided row, each rank's collectives a step equal to the dry
    run's prediction for the mesh (gloo's gathers issued as all-to-alls);
    17c, K3 with a non-zero ``q_offset`` against its plain version and bit
    for bit against the same rows of K3 over the whole sequence;
18. (run last, after 17; 15c keeps its step 1 on the host for it) the
    dense LM train step sharded on a ``DeviceMesh`` with FSDP: 18k, K3's
    ``FlashAttention`` Function under ``local_map`` with the q heads
    sharded on two ``gloo`` ranks on the card, dq, dk and dv against plain
    autograd; 18a, one ``nccl`` rank on a (data 1, model 1) mesh: 15c's
    step (its seeded weights drawn again, its batch) through
    ``shard_cell``, its loss, grad_norm and every updated parameter, ``m``
    and ``v`` leaf (digests of their bits) 15c's step 1's, K3 two launches
    a layer; 18b, two ``gloo`` ranks on the one card on (data 2, model 1),
    FSDP proper: qwen3-14b at FSDP_LAYERS layers, B 2 (a 4,096-token row a
    rank), FSDP_STEPS steps against the unsharded port's on the same
    weights and batch (run first, kept on the host), each rank's state
    half the unsharded one, its peak memory, and its collectives in a
    step equal to the dry run's prediction for the mesh;
19. (run last, after 18; 14c keeps its olmoe-1b-7b outputs on the host for
    it) the MoE LM serving path sharded on a ``DeviceMesh``: 19a, one
    ``nccl`` rank on (data 1, model 1): 14c's model drawn again from its
    seed through ``shard_cell``, 14c's prompts, its first MOE_TP_DECODE
    greedy tokens fed, ``forward`` and ``lm_loss``: 14c's bits (the
    logits, digests of ``forward``'s logits and aux and of the loss), K3
    16 launches a prefill, its routing recorded; 19b, four ``gloo`` ranks
    on the one card on (data 2, model 2), each drawing the model in turn
    and keeping its shards (experts and attention halved on ``model``):
    the same traffic, token blocks routed on each data shard (decode's
    one block gathered), every logits row within MOE_TP_TOL of 14c's row
    scale and rows routed alike as 19a within MOE_TP_ALIKE_TOL, greedy
    tokens equal on decided rows, the routing counted against 19a's, the
    loss and aux within MOE_TP_LOSS_RTOL, one layer's ``moe_ffn`` at 14b's
    inputs sharded against unsharded, each rank's collectives a prefill
    and a decode step equal to the dry run's, and two controls (each
    rank's expert shards swapped with its partner's, then its rows of
    ``wo`` too) that the logits check must reject by
    MOE_TP_CONTROL_FACTOR times its tolerance; 19c, mixtral-8x7b at
    MIXTRAL_TP_LAYERS layers on two ``gloo`` ranks on (data 1, model 2),
    its experts unfolded into 16 virtual experts, 8 a rank, the prefill
    and MOE_TP_DECODE decode steps held to the same model run unsharded
    just before, the same controls;
20. (run last, after 19; 16c keeps its Spade cells' outputs on the host
    for it) the Spade cells and gcn-cora's train step through
    ``shard_cell``: 20a, one ``nccl`` rank on (data 1, model 1), both
    Spade cells at the spade-grab capacities on the edge-sharded engine:
    16c's bits in every field and the joined graph (``unshard_graph``),
    K1, K2 and ``suffix_init`` launched as in 16c, 21 all-reduces a step
    as the dry run counts them; 20b, four ``gloo`` ranks on the one card
    on (data 2, model 2), the edges split two ways and replicated over
    ``model``: the same bits (``best_g`` within :func:`best_g_bound`,
    whose dropped-partials control must fall outside it), every rank's
    all-reduces and bytes the dry run's, K2 on the vector path; 20c,
    gcn-cora's train cell on whole ogbn-products on the same four ranks
    (one spawn for 20b and 20c): GCN_TP_STEPS steps held to the unsharded steps
    (run first, kept on the host), K4 8 launches a step on each rank,
    each rank's collectives the dry run's, peak memory and step seconds a
    rank, a control (one rank's aggregate partials dropped) that the check
    must reject; 20d, GAT, MeshGraphNet and DimeNet's train cells at
    GNN_TP_SHAPE on the same four ranks, GNN_TP_STEPS step held to their
    unsharded steps, the collectives the dry run's, GAT's
    unsummed-denominators control rejected.  Their launches are counted
    off the main path;
21. (run last, after 20) the MoE LM train step sharded on a ``DeviceMesh``
    with FSDP: olmoe-1b-7b at MOE_FSDP_LAYERS of its 16 layers, B 2 x
    4,096 tokens, its unsharded steps run twice first (their bits repeat or
    not: the gathers' backward adds with float atomics); 21a, one ``nccl``
    rank on (data 1, model 1) through ``shard_cell``, MOE_FSDP_STEPS steps
    held to the unsharded ones bit for bit where those repeat, else within
    MOE_FSDP_SPREAD times their spread (step 1's forward bit for bit
    either way), K3 two launches a layer a step; then mixtral-8x7b's
    unsharded step at MIXTRAL_FSDP_LAYERS layers, and one spawn of four
    ``gloo`` ranks on the card on (data 2, model 2), each drawing the
    weights two ranks at a time and keeping its shards (experts on
    ``model``, their ``D``, the router and the attention on ``data``,
    tokens on ``data``): 21b olmoe MOE_FSDP_STEPS steps, 21c mixtral (16
    virtual experts, 8 a rank, pair-summed locally) MIXTRAL_FSDP_STEPS
    step, each held to its unsharded steps (loss, aux and grad_norm within
    MOE_FSDP_STEP1_RTOL in step 1 and MOE_FSDP_LATER_RTOL after it, step
    1's per-token NLL within MOE_FSDP_NLL_TOL on average, every parameter
    by ``ulp_errs`` within MOE_FSDP_ODD), the share of token-layers routed
    to other experts printed, state and peak GB and step seconds a rank,
    step 1's collectives equal to the dry run's at the mesh and depth, K3
    two launches a layer a step, and a control (each rank's expert shards
    swapped with its ``model`` partner's before a forward) whose per-token
    NLL must miss by MOE_TP_CONTROL_FACTOR times MOE_FSDP_NLL_TOL;
22. (run last, after 21; 16a and 16b keep on the host the outputs it is
    held to) two-tower-retrieval on ``rows`` through ``shard_cell``, and a
    sharded state's checkpoints: 22a, one ``nccl`` rank on (data 1, model
    1), 16a's weights (drawn again from its seed) and traffic: serve_p99,
    retrieval_cand and one serve_bulk call, 16a's bits, no collective;
    then one spawn of four ``gloo`` ranks on the card on (data 2, model 2),
    each drawing only its quarter of the tables (15.36 GB): 22b serves the
    same traffic (serve_p99 and retrieval_cand timed over TT_TIMED calls,
    serve_bulk once), the scores within TT_TOL of temp of 16a's, the top
    100 16a's but at ties, each rank's collectives a call equal to the dry
    run's prediction for the mesh, ms a call and the peak a rank; 22c
    trains 16b's cut (batch 16,384, a quarter of each vocabulary) two
    steps, loss and grad_norm within TT_TP_RTOL of 16b's and every leaf's
    sums after step 1 within 16c's rule summed over the leaf, step 1's
    collectives the dry run's, s a step, state and peak GB a rank, and a
    control (one rank's user-table rows drawn one block off) that moves
    the loss by TT_TP_CONTROL_FACTOR times its tolerance; 22d saves the
    smoke train state with a ``CheckpointManager`` on the four ranks (each
    writing only its own shards), updates it in place at once, and
    restores it onto (data 1, model 2) and onto one device, bit for bit.
    No hand kernel launches in phase 22.

The run must end within 1,200 s on a slow host.  So the phases that
leave the card and the host room run beside others (the stream's draw,
phase 12 beside 17, 13c beside 19c), and the gloo ranks of 13b and 17-22
start ahead (:class:`RanksAhead`): they reach the card and join their
group while the phase before them or their own phase's work on one
device runs, and wait at a gate until it is done (rank 0 logs how long).

The last two lines of standard output are the card's name and power limit
as ``nvidia-smi`` gives them, then ``{"ok": true, "device": {...}}``; the
line before them is the per-kernel JSON record.  Imports nothing of JAX
and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import dataclasses
import json
import math
import multiprocessing
import shutil
import statistics
import subprocess
import sys
import threading
import time
import warnings
from concurrent.futures import ProcessPoolExecutor
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
# kernels a trace may lose and still be read (device_times), or a quarter
# of the kernels it kept where that is more: the profiler loses a fixed
# number of kernels from a trace on the H100, whatever its length, one to
# five early in a run (K4 at ogb_products: 46 of 50, 96 of 100, ..., 396
# of 400) and 20 to 28 from phase 14 on (K3 at olmoe-1b-7b: 22 of 50, 72
# of 100, ..., 772 of 800; the MoE FFN's 26 of 10 calls' 600, of 80's 4,800)
DROPPED_MAX = 8


_LOG = threading.Lock()


def log(*args) -> None:
    with _LOG:  # phases that run beside each other log from their threads
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


def device_times(fn, calls: int = 50, restore=None) -> tuple[float, float]:
    """(device ms, span ms) of one call of ``fn``: ``torch.profiler`` over
    ``calls`` back-to-back calls (after one untraced call), the device
    kernels (and copies) that each call launches summed, the median over
    the calls; and CUDA events around the same calls, their span over the
    calls, a second clock that the kernels' sum cannot exceed.
    ``restore``, when given, runs before every call and its copies are left
    out of the device time.  The profiler drops a few kernels from a trace
    (a fixed number on the H100, whatever the number of calls): a trace
    short by up to DROPPED_MAX kernels of a whole number a call, or by up
    to a quarter of the kernels it kept, is read kernel by kernel, each
    kernel's median time times the times a call launches it.  A trace that
    records no device time, or is short by more, is taken again, after a
    pause, over twice the calls; after PROFILE_ATTEMPTS such traces the
    run fails: no other clock stands in for the device's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def one():
        if restore is not None:
            restore()
        fn()

    one()
    sync()
    n = calls
    for attempt in range(PROFILE_ATTEMPTS):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0.record()
            for _ in range(n):
                one()
            t1.record()
            sync()
        span_us = 1e3 * t0.elapsed_time(t1)
        evs = sorted((e for e in prof.events() if str(e.device_type).endswith("CUDA")
                      and not (restore is not None and "Memcpy" in e.name)),
                     key=lambda e: e.time_range.start)
        us, fault = read_trace(evs, n, span_us)
        if fault is None:
            return us / 1e3, span_us / n / 1e3
        log(f"device_time_ms: trace {attempt + 1} ({n} calls) {fault}")
        time.sleep(0.2)
        n *= 2
    check(False, f"device_time_ms: {fault}")


def read_trace(evs, n: int, span_us: float) -> tuple[float, str | None]:
    """(us a call, None) from the device events ``evs`` of ``n`` calls
    traced in ``span_us``, or (0, what is wrong with the trace).  A read
    per kernel is logged beside the span a call, which bounds the mean
    and not the median: under back-to-back launches the card's clock
    falls from its boost, so the first calls run faster than the rest
    (K3's median over 50 calls 3 % above the span a call on the H100)."""
    us = [e.time_range.elapsed_us() for e in evs]
    if sum(us) <= 0:
        return 0.0, "recorded no device time"
    per, rest = divmod(len(us), n)
    if not rest:
        return statistics.median(sum(us[i * per:(i + 1) * per]) for i in range(n)), None
    names: dict[str, list[float]] = {}
    for e, t in zip(evs, us):
        names.setdefault(e.name, []).append(t)
    a_call = {name: -(-len(ts) // n) for name, ts in names.items()}
    missing = sum(k * n - len(names[name]) for name, k in a_call.items())
    if missing > max(DROPPED_MAX, len(us) // 4):
        return 0.0, f"is short of {missing} kernels of {n} whole calls (" + ", ".join(
            f"{name[:60]} {len(names[name])} of {k * n}" for name, k in a_call.items()) + ")"
    read = sum(statistics.median(names[name]) * k for name, k in a_call.items())
    log(f"device_time_ms: {len(us)} device events for {n} calls, {missing} dropped, read "
        f"per kernel ({read!r} us a call beside a span of {span_us / n!r} us)")
    return read, None


def device_time_ms(fn, calls: int = 50, restore=None) -> float:
    """The device ms of :func:`device_times`."""
    return device_times(fn, calls, restore)[0]


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


def beside(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` started in a thread of this process (the dry
    run's predictions, traced on meta while this process only waits for
    spawned ranks); the returned function joins it and gives its result,
    raising its error."""
    box = {}

    def run():
        try:
            box["out"] = fn(*args, **kwargs)
        except BaseException as e:  # raised again by result()
            box["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def result():
        thread.join()
        if "error" in box:
            raise box["error"]
        return box["out"]

    return result


_GATES: list = []  # the gates of RanksAhead, closed with "stop" at exit if still shut


def gated_rank(mesh, gate: str, t_start: float, fn, *args):
    """A rank started ahead (:class:`RanksAhead`): it has reached the card
    and joined its group, and waits for its parent to open ``gate``, a
    file: "go" runs ``fn(mesh, *args)``, "stop" raises.  Rank 0 logs when
    it reached the gate (``t_start``: the spawn's start, on the host's
    clock) and how long it waited there."""
    import torch.distributed as dist

    path = Path(gate)
    t_ready = time.time()
    while not path.exists():
        time.sleep(0.05)
    if path.read_text() != "go":
        raise RuntimeError(f"{fn.__name__}: stopped at the gate (its parent failed)")
    if dist.get_rank() == 0:
        log(f"  ranks of {fn.__name__}: rank 0 at the gate {t_ready - t_start!r} s after the "
            f"spawn began, held there {time.time() - t_ready!r} s")
    return fn(mesh, *args)


class RanksAhead:
    """``spawn(fn, world, args=args, **kwargs)`` started now, in a thread of
    this process, its ranks held at a gate (:func:`gated_rank`): they
    start, reach the card and join their group while this process does
    the phase's own work on the card (or the phase before it); until
    :meth:`go` each holds a CUDA context and nothing else there.  Whatever
    the ranks read must be in place before :meth:`go`, which then calls
    ``on_go``'s functions (the next phase's ranks started once this
    phase's one-device work has left the card).  :meth:`join` opens the
    gate if it is shut and gives spawn's result."""

    def __init__(self, fn, world: int, args: tuple = (), **kwargs):
        import tempfile

        from repro_torch.dist import spawn

        self.gate = Path(tempfile.mkdtemp(prefix="chip_smoke_gate_")) / "gate"
        _GATES.append(self.gate)
        self.on_go = []  # functions of no argument, called once the gate opens
        self._ranks = beside(spawn, gated_rank, world,
                             args=(str(self.gate), time.time(), fn, *args), **kwargs)

    def go(self) -> None:
        _open_gate(self.gate, "go")
        while self.on_go:
            self.on_go.pop(0)()

    def join(self) -> list:
        self.go()
        try:
            return self._ranks()
        finally:
            _GATES.remove(self.gate)
            shutil.rmtree(self.gate.parent, ignore_errors=True)


def _open_gate(gate: Path, word: str) -> None:
    if not gate.exists():
        tmp = gate.with_suffix(".tmp")
        tmp.write_text(word)
        tmp.replace(gate)  # the ranks never read a half-written gate


@atexit.register
def _stop_gates() -> None:
    """Ranks still held at a gate when this process ends (a phase failed
    before it let them run) are stopped, so that they end too."""
    for gate in list(_GATES):
        _open_gate(gate, "stop")


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
            ms, span = device_times(lambda: flash_attention(q, k, v))
            call = cuda_time_ms(lambda: flash_attention(q, k, v), reps=10)
            plain = device_time_ms(lambda: flash_attention_ref(q, k, v), calls=3)
            plain_call = cuda_time_ms(lambda: flash_attention_ref(q, k, v), reps=3, warmup=1)
            lib, lib_call = timed(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), reps=10)
            bound = k3_bound_ms(B, Hq, Hkv, S, D, window)
            tflops = 4 * B * Hq * D * attn_pairs(S, window) / ms / 1e9
            rec.update(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, call_ms=call,
                       plain_call_ms=plain_call, library_call_ms=lib_call, span_ms=span)
            norm.update(tflops=tflops, k3_over_sdpa=ms / lib)
            log(f"{tag}: kernel {ms!r} ms device ({span!r} ms a call back to back by CUDA "
                f"events, {call!r} ms call; {tflops!r} TFLOP/s, "
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


def greedy_check(name, got, want, tol: float = LM_TOL) -> tuple[int, int]:
    """Logits [B, V]: ``|got - want| <= tol * max|want row|`` (``tol``
    LM_TOL unless given), and the
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
    check(bool((err <= tol * scale).all()),
          f"{name}: max abs err {float(err.max())!r} beyond {tol} of the row scale "
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
    """Inside, every MoE FFN call of the port appends to ``rec`` the
    :class:`~repro_torch.models.moe.Routing` it computes (``moe_route``
    wrapped: no second routing); on a mesh, its DTensors hold this rank's
    tokens and blocks (:func:`host_routing`)."""
    from repro_torch.models import moe

    route = moe.moe_route

    def recorded(x, router, spec):
        r = route(x, router, spec)
        rec.append(r)
        return r

    moe.moe_route = recorded
    try:
        yield rec
    finally:
        moe.moe_route = route


@contextlib.contextmanager
def nll_recorded(rec: list):
    """Inside, every ``lm_loss`` of the port appends to ``rec`` its
    per-token NLL on the host (``transformer._token_nll`` wrapped): this
    rank's rows [B, S] (float32) and the global index of its first row."""
    from repro_torch.dist.sharding import local, shard_span
    from repro_torch.models import transformer

    token_nll = transformer._token_nll
    depth = [0]  # _token_nll calls itself on a rank's local tensors

    def recorded(logits, labels):
        depth[0] += 1
        try:
            out = token_nll(logits, labels)
        finally:
            depth[0] -= 1
        if not depth[0]:
            rec.append({"b0": shard_span(out, 0)[0], "nll": local(out).detach().float().cpu()})
        return out

    transformer._token_nll = recorded
    try:
        yield rec
    finally:
        transformer._token_nll = token_nll


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


def phase_lm_full(seed: int) -> tuple[dict, dict]:
    """Phase 8; also returns what phase 17 holds its sharded runs to, on
    the host: the prompts, the prefill's logits and cache (taken before
    decode writes the cache), the tokens each decode step was fed and its
    logits."""
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
    ref = {"tokens": tokens.cpu(), "prefill_logits": logits.cpu(),
           "cache": (cache.k.cpu(), cache.v.cpu()), "fed": [], "decode_logits": []}
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
        ref["fed"].append(tok.cpu())
        ref["decode_logits"].append(logits.cpu())
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
    return out, ref


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


def cross_plane_job(part: str, sem: str, p: dict, device: str, eps: float,
                    max_rounds: int) -> dict:
    """One comparison of phase 12 in a process of its own on ``device``:
    ``part`` 12a (:func:`cross_plane_ticks`, insert-only, ``p`` as
    CROSS_INSERT) or 12b (windowed, ``p`` as CROSS_WINDOW) of semantics
    ``sem`` (XPARITY: :func:`parity_semantics`), or 12c
    (:func:`exact_peel_check`, ``p`` as CROSS_EXACT; ``sem`` ``int`` or
    ``tied``).  Returns the record with the K1, K2 and ``suffix_init``
    launches the comparison made, or the failed check's message."""
    import torch

    from repro_torch.core.semantics import resolve
    from repro_torch.graphstore.generators import make_transaction_stream

    global DEVICE
    DEVICE = device
    torch.set_num_threads(1)  # the jobs share the host's cores
    torch.set_grad_enabled(False)
    zero_kernel_counts()
    try:
        if part == "12c":
            rec = exact_peel_check(p["n"], p["m"], p["seed"], device, sem == "tied")
        else:
            semantics = parity_semantics() if sem == "XPARITY" else resolve(sem)
            stream = make_transaction_stream(n=p["n"], m=p["m"], seed=p["seed"])
            integer = part == "12b" or sem in ("DG", "XPARITY")
            rec = cross_plane_ticks(
                semantics, integer_amounts(stream) if integer else stream, p["ticks"],
                p["fd_batch"] if sem == "FD" else p["batch"], device, eps, max_rounds,
                window=p.get("window", 0) if part == "12b" else 0, integer=integer,
                tag=f"{part} {semantics.name}")
    except SystemExit as e:
        return {"failed": str(e)}
    return rec | {"launches": kernel_counts()}


def phase_cross_plane(card: str) -> dict:
    """12a, 12b and 12c on the card (sizes above, eps and max_rounds from
    the spade-grab config), each comparison in a process of its own
    (:func:`cross_plane_job`), all at once: the host plane is a single
    thread of Python and NumPy a comparison.  Returns the records and the
    launches of all of them."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    log(f"phase 12: host seconds are the host CPU of the machine that holds {card}; "
        f"device seconds are the {DEVICE} side's, synchronized; the comparisons run at "
        f"once, a process each")
    # longest first: FD's host inserts go one edge a call, 12b's host
    # deletions take seconds each
    jobs = [("12a", "FD", CROSS_INSERT), ("12b", "XPARITY", CROSS_WINDOW),
            ("12b", "DG", CROSS_WINDOW), ("12a", "DG", CROSS_INSERT),
            ("12a", "XPARITY", CROSS_INSERT), ("12a", "DW", CROSS_INSERT),
            ("12c", "int", CROSS_EXACT), ("12c", "tied", CROSS_EXACT)]
    with ProcessPoolExecutor(len(jobs), mp_context=multiprocessing.get_context("spawn")) as ex:
        futures = [ex.submit(cross_plane_job, part, sem, p, DEVICE, EPS, MAX_ROUNDS)
                   for part, sem, p in jobs]
        recs = {(part, sem): f.result() for (part, sem, _), f in zip(jobs, futures)}
    for (part, sem), rec in recs.items():
        check("failed" not in rec, f"phase 12 {part} {sem}: {rec.get('failed')}")
    out = {"insert": [], "window": [], "exact": [],
           "launches": {k: sum(r["launches"][k] for r in recs.values())
                        for k in ("peel_round", "frontier_spmv", "suffix_init")}}
    for sem in ("DG", "XPARITY", "DW", "FD"):
        rec = recs["12a", sem]
        out["insert"].append(rec)
        log(f"12a {rec['semantics']} insert-only, {rec['ticks']} ticks of {rec['batch']} on "
            f"n={rec['n']} base={rec['base_edges']}: weights, live edges, w0 "
            f"{'bit for bit' if sem in ('DG', 'XPARITY') else 'within rtol'} every tick (max "
            f"rel err {rec['max_rel_err']!r}); best_g {rec['best_g']!r}, refreshed "
            f"{rec['refreshed_best_g']!r} vs g_host {rec['g_host']!r}; host "
            f"{rec['host_s']!r} s, device {rec['device_s']!r} s")
    for sem in ("DG", "XPARITY"):
        rec = recs["12b", sem]
        out["window"].append(rec)
        log(f"12b {rec['semantics']} window {rec['window']}, {rec['ticks']} ticks of "
            f"{rec['batch']} on n={rec['n']} base={rec['base_edges']}: "
            f"{rec['deletions']} host DeleteEdge calls (slowest {rec['max_delete_s']!r} s); "
            f"weights, live edges, w0 bit for bit every tick; host {rec['host_s']!r} s, "
            f"device {rec['device_s']!r} s")
    for sem in ("int", "tied"):
        rec = recs["12c", sem]
        out["exact"].append(rec)
        log(f"12c exact_peel {sem} n={rec['n']} "
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


def hand_kernel_launches() -> dict:
    """Every hand kernel's launch counter (K3's two bodies apart)."""
    from repro_torch.kernels.flash_attention import ops as k3_ops
    from repro_torch.kernels.gather_segsum import ops as k4_ops

    return kernel_counts() | {"flash_attention": k3_ops.launches,
                              "flash_attention_simt": k3_ops.simt_launches,
                              "gather_segsum": k4_ops.launches}


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
    (report, the final state as numpy).  On a mesh (edges on ``data``) the
    state's graph is the ranks' edge blocks joined by ``unshard_graph``,
    whose all-reduce is left out of ``dist.graph.STATS``."""
    from repro_torch.convert import state_to_numpy
    from repro_torch.dist import graph as dg
    from repro_torch.serve import SpadeService

    svc = SpadeService(sem, batch_edges=kw.pop("batch", BATCH), eps=EPS,
                       max_rounds=MAX_ROUNDS, device=device or DEVICE, mesh=mesh, **kw)
    rep = svc.run(stream)
    state = svc.final_state
    if mesh is not None:
        kept = dict(dg.STATS)
        state = dataclasses.replace(state, graph=dg.unshard_graph(state.graph, mesh, "data"))
        dg.STATS.update(kept)
    return rep, state_to_numpy(state)


def same_state(tag: str, got: dict, want: dict, fields=SHARD_STATE + SHARD_EDGES) -> None:
    for f in fields:
        check(np.array_equal(got[f], want[f]), f"{tag}: {f} differs")




def phase_sharded_grab(stream) -> dict:
    """13a: world 1 on ``nccl`` at full width.  The service with and without
    a one-rank mesh on the first SHARD_TICKS ticks, fused and predictive
    workset: final states equal bit for bit; the same K1, K2 and
    ``suffix_init`` launches as the single-device run, that is 20 a tick
    (+ the start-up peel's rounds) and 2 a tick (+ 2), and one all_reduce a
    round.  Then fused slide ticks timed (wall and device) and traced, and
    the all_reduce ms per round."""
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


SHARD_PAIR_PATH = ROOT / "build" / "phase13" / "grab4_stream.npz"


def sharded_pair_ranks() -> RanksAhead:
    """13b's two ranks, started ahead (they read SHARD_PAIR_PATH at go)."""
    return RanksAhead(pair_rank, 2, backend="gloo", device=DEVICE,
                      args=(str(SHARD_PAIR_PATH), DEVICE,
                            grab_config(window=SHARD_PAIR["window"])),
                      timeout=SHARD_TIMEOUT)


def phase_sharded_pair(stream, ahead: RanksAhead | None = None) -> dict:
    """13b: world 2 on the one card over gloo, Grab4, SHARD_PAIR's ticks and
    window, against the single-device engine: DG bit for bit (the joined
    edge buffers too), DW's final_g and w0 within SHARD_RTOL and its edge
    buffers bit for bit (the layout does not depend on the sums).  The
    ranks are ``ahead``'s (:func:`sharded_pair_ranks`), or started here."""
    p = SHARD_PAIR
    t0 = time.perf_counter()
    ahead = ahead or sharded_pair_ranks()
    cut = cut_stream(stream, p["ticks"], BATCH)
    path = SHARD_PAIR_PATH
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **dataclasses.asdict(cut))
    want = {sem: serve(sem, cut, window_ticks=p["window"]) for sem in p["semantics"]}
    ranks = ahead.join()
    spawn_s = time.perf_counter() - t0
    path.unlink()
    out = {"spawn_s": spawn_s, "split_control": vector_split_control()}
    for sem in p["semantics"]:
        split = [r[sem]["split"] for r in ranks]
        check(all(vector_split_ok(x) for x in split),
              f"13b {sem}: K2's launches left the vector path: {split!r}")
        rep1, st1 = want[sem]
        got = ranks[0][sem]["state"]  # the edge blocks joined by unshard_graph
        for r in ranks[1:]:
            same_state(f"13b {sem}: rank 0 vs another rank", r[sem]["state"], got)
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
    pair = sharded_pair_ranks()  # 13b's ranks start while 13a runs
    out = {"grab_world1": phase_sharded_grab(stream)}
    log(f"13a: {time.perf_counter() - t0!r} s")
    t1 = time.perf_counter()
    out["grab_world2"] = phase_sharded_pair(stream, pair)
    log(f"13b: {time.perf_counter() - t1!r} s")
    out["seconds"] = time.perf_counter() - t0  # 13c runs beside 19c (main)
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


def moe_ffn_inputs(cfg, seed: int):
    """14b's seeded draws for one layer of ``cfg`` on DEVICE: tokens ``x
    [MOE_FFN_TOKENS, D]`` and ``[router, w_gate, w_up, w_down]`` (the
    router float32, the rest in ``cfg.dtype``)."""
    import torch

    from repro_torch.models.layers import normal_init

    spec, D, T = cfg.moe, cfg.d_model, MOE_FFN_TOKENS
    E, F = spec.n_experts, spec.d_ff_expert
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    dt = getattr(torch, cfg.dtype)
    w = [normal_init((D, E), D, torch.float32, DEVICE, gen),
         normal_init((E, D, F), D, dt, DEVICE, gen),
         normal_init((E, D, F), D, dt, DEVICE, gen),
         normal_init((E, F, D), F, dt, DEVICE, gen)]
    return torch.randn((T, D), generator=gen, device=DEVICE).to(dt), w


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
    from repro_torch.models.moe import moe_route

    out = {}
    for arch in MOE_LAYERS:
        cfg = get_config(arch)
        spec, D, T = cfg.moe, cfg.d_model, MOE_FFN_TOKENS
        E, K, F = spec.n_experts, spec.top_k, spec.d_ff_expert
        x, w = moe_ffn_inputs(cfg, seed)
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
    ``torch.profiler`` traces of a prefill and four decode steps.  Of
    MOE_TP_ARCH it keeps on the host, under ``tp_ref``, what phase 19 holds
    its sharded runs to: the prompts and labels, the prefill's logits, the
    first MOE_TP_DECODE decode steps' tokens and logits, and digests of the
    bits of ``forward``'s logits and aux and of ``lm_loss``'s value."""
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
    # what phase 19 holds its sharded runs of this model to, on the host
    tp_ref = {"tokens": tokens.cpu(), "prefill_logits": logits.to("cpu", copy=True), "fed": [],
            "decode_logits": []} if arch == MOE_TP_ARCH else None
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
        if tp_ref is not None and i < MOE_TP_DECODE:
            tp_ref["fed"].append(tok.cpu())
            tp_ref["decode_logits"].append(logits.to("cpu", copy=True))
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
    if tp_ref is not None:
        tp_ref["forward_digest"] = bits_digest(flogits)
        tp_ref["aux_digest"] = bits_digest(faux)
    del flogits
    torch.cuda.empty_cache()
    labels = torch.roll(tokens, -1, dims=1)
    t0 = time.perf_counter()
    loss, parts = lm_loss(model, tokens, labels)
    sync()
    loss_s = time.perf_counter() - t0
    check(math.isfinite(float(loss)) and float(faux) > 0.0,
          f"{cfg.name} lm_loss: {float(loss)!r}, aux {float(faux)!r}")
    if tp_ref is not None:
        tp_ref.update(labels=labels.cpu(), loss_digest=bits_digest(loss), loss=float(loss),
                    aux=float(faux), n_layers=cfg.n_layers)
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
    if tp_ref is not None:
        out["tp_ref"] = tp_ref
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
    sdpa_ms = device_time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), calls=10)
    bwd_ms = device_time_ms(lambda: flash_attention_bwd_ref(q, k, v, do, block_q=cfg.q_block),
                            calls=3)
    out.update(k3_forward_ms=fwd_ms, sdpa_forward_ms=sdpa_ms, plain_backward_ms=bwd_ms,
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
            # what phase 18a's sharded step at this depth must repeat bit for bit
            step1 = {"n_layers": n_layers, "loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]), "digest": train_digests(state)}
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
    out["step1"] = step1

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


def tt_traffic(cfg, seed: int, device, sizes: dict | None = None):
    """16a's traffic on ``device``, which 22 draws again: the serve_p99
    batch, the serve_bulk batch with serve_p99's rows at ``at`` among its
    own, retrieval's query, all from ``np.random.default_rng(seed)``, and
    retrieval_cand's 1,000,448 candidates from a generator on ``device``
    seeded ``seed + 1``."""
    import torch

    from repro_torch.configs import RECSYS_SHAPES
    from repro_torch.models.two_tower import RecsysBatch

    rng = np.random.default_rng(seed)
    B_p99, B_bulk = RECSYS_SHAPES["serve_p99"].batch, RECSYS_SHAPES["serve_bulk"].batch
    N = -(-RECSYS_SHAPES["retrieval_cand"].n_candidates // 512) * 512
    if sizes is not None:  # phase 22's rehearsal
        B_p99, B_bulk, N = sizes["p99"], sizes["bulk"], sizes["cand"]
    p99 = recsys_batch(cfg, B_p99, rng, device)
    bulk = recsys_batch(cfg, B_bulk, rng, device)
    at = torch.from_numpy(np.sort(rng.choice(B_bulk, B_p99, replace=False))).to(device)
    bulk = RecsysBatch(*(b.index_copy(0, at, p) for b, p in zip(bulk, p99)))
    q = recsys_batch(cfg, 1, rng, device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    cand = torch.randn((N, cfg.tower_mlp[-1]), generator=gen, device=device)
    return p99, bulk, at, q, cand


def two_tower_serve(seed: int) -> dict:
    """16a: two-tower-retrieval's full config on the card (61.44 GB of
    float32 tables from a seeded generator): ``score_pairs`` at serve_p99
    and serve_bulk (serve_p99's rows repeated inside it), and
    ``retrieval_scores`` over retrieval_cand's 1,000,448 candidates, top
    100; each held to a float64 recomputation on the card, twice the same
    bits; times, rows/s, peak memory and a traced serve_bulk call."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.two_tower import (init_two_tower_params, retrieval_scores,
                                              score_pairs, user_tower)

    cfg = get_config(TT_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_two_tower_params(cfg, device=DEVICE, seed=seed)
    sync()
    table_gb = sum(params[k].numel() * 4 for k in ("user_table", "item_table")) / 1e9
    log(f"16a: {TT_ARCH} at full width: tables {table_gb!r} GB drawn in "
        f"{time.perf_counter() - t0!r} s; allocated "
        f"{torch.cuda.memory_allocated() / 1e9!r} GB")
    temp = float(params["temp"])
    p99, bulk, at, q, cand = tt_traffic(cfg, seed, DEVICE)
    rng = np.random.default_rng(seed + 2)  # the rows held to float64
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
    N = cand.shape[0]
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
    # phase 22 holds its sharded serving to these, kept on the host
    out["phase22"] = {"serve_p99": scores["serve_p99"].cpu(),
                      "serve_bulk": scores["serve_bulk"].cpu(), "top_v": v1.cpu(),
                      "top_i": i1.cpu(), "temp": temp}
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
    cpu = init_two_tower_params(cfg, device="cpu", seed=seed)
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


def leaf_sums(params) -> dict:
    """Each leaf's float64 sum, sum of squares, largest ``|x|`` and number
    of elements (a DTensor's local shard's), a chunk of 2^25 elements at a
    time."""
    from repro_torch.dist.sharding import local

    out = {}
    for k, x in named_params(params).items():
        s1 = s2 = top = 0.0
        for c in local(x).detach().reshape(-1).split(1 << 25):
            c = c.double()
            s1, s2, top = s1 + c.sum(), s2 + c.square().sum(), max(top, float(c.abs().max()))
        out[k] = (float(s1), float(s2), top, local(x).numel())
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
    params = init_two_tower_params(cfg, device=DEVICE, seed=seed)
    state = init_train_state(params)
    batch = recsys_batch(cfg, TT_TRAIN_BATCH, np.random.default_rng(seed), DEVICE)
    step = make_train_step(lambda p, b: two_tower_loss(p, b, cfg), AdamConfig(**TT_TRAIN_ADAM))
    state_gb = 4 * sum(p.numel() * 4 for p in named_params(params).values()) / 1e9

    sig = lambda: leaf_sums(state.params)
    before = sig()
    torch.cuda.reset_peak_memory_stats()  # the steps' peak, with the state held
    secs, losses, norms = [], [], []
    with torch.enable_grad():
        for i in range(TT_TRAIN_STEPS):
            t0 = time.perf_counter()
            state, m = step(state, batch)
            sync()
            secs.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            if i == 0:
                after = sig()
                same = [k for k in before if before[k][:2] == after[k][:2]]
                check(not same, f"16b: leaves unchanged by step 1: {same!r}")
    check(all(math.isfinite(x) for x in losses), f"16b: losses {losses!r}")
    med = statistics.median(secs[1:])
    out = {"user_vocab": cfg.user_vocab, "item_vocab": cfg.item_vocab,
           "batch": TT_TRAIN_BATCH, "state_gb": state_gb, "step_s": secs,
           "step_s_median_2_3": med, "rows_per_s": TT_TRAIN_BATCH / med, "losses": losses,
           "grad_norms": norms, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "leaves_changed_by_step_1": len(before),
           # phase 22c holds its sharded steps to these
           "phase22": {"losses": losses[:2], "grad_norms": norms[:2], "before": before,
                       "after": after}}
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
        # what phase 20 holds its sharded steps to, kept on the host
        out[shape]["bits"] = spade_host(first, shape) | {
            k: out[shape][k] for k in ("edges", "launches")}
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


# ---------------------------------------------------------------------------
# phase 17: the dense LM serving path sharded on a DeviceMesh
# ---------------------------------------------------------------------------

# 17b holds the logits of two ranks (model 2) to phase 8's at LM_TOL, its
# ceiling, relative to the row's largest |logit|: each row-parallel
# product's two partial sums are rounded to bf16 before they are added, two
# roundings more than one device's, in each of 80 products over 40 layers;
# measured 0.0194-0.0265 on the H100 over the prefill and 32 decode steps.
# 17b runs TP_LAYERS of the 40 (its ranks' prefill took 23.0-32.2 s and
# its decode steps 0.82 s each at 40), against the same depth unsharded
# (tp_depth_ref): the whole run must end within 1,200 s on a slow host
# (PERF.md §6); 17a keeps all 40 and phase 8's bits
TP_LAYERS = 10
TP_TIMEOUT = 600  # seconds for 17b's spawn
# 17c: (S, q_offset, window)
TP_OFFSETS = ((8192, 4096, None), (8192, 4000, None), (4096, 2048, 1024))


def prefill_cell(arch: str, model, tokens, smoke: bool = False):
    """``arch``'s prefill cell (its logical axes) holding ``model`` and
    ``tokens``: the traffic of a sharded serving phase through
    ``shard_cell`` (``smoke``: the smoke config's cell, for a rehearsal on
    the CPU)."""
    from repro_torch.launch.cells import build_cell

    cell = build_cell(arch, "prefill_32k", smoke=smoke)
    return dataclasses.replace(cell, args=(model, tokens))


def tp_gather(x):
    """A sharded result made whole on the host (the gloo ranks' all-gather
    goes through ``sharding.redistribute``)."""
    from torch.distributed.tensor import Replicate

    from repro_torch.dist import sharding

    whole = sharding.redistribute(x, [Replicate()] * x.device_mesh.ndim)
    return whole.to_local().to("cpu", copy=True)


def tp_serve(env, cell, fed, prompt: int, keep_cache: bool = False) -> dict:
    """Phase 8's traffic through a sharded cell on ``env``'s mesh: the
    prefill, then a decode step on each fed token (phase 8's greedy
    tokens), K3's counters set to 0 just before and read just after; the
    collectives of the prefill and of the first decode step on this rank
    (``LocalCost``, whose Python work a op is inside those two steps'
    seconds), seconds, the logits on the host and, with ``keep_cache``,
    host copies of this rank's prefill cache shards."""
    import torch

    from repro_torch.dist.sharding import LocalCost, place, use_axis_env
    from repro_torch.kernels.flash_attention import ops as k3_ops
    from repro_torch.models import decode_step

    model = cell.args[0]
    out = {"decode": [], "decode_s": []}
    with use_axis_env(env):
        fed = [place(t.to(DEVICE), "batch") for t in fed]
        pos = [place(torch.full((t.shape[0],), prompt + i, dtype=torch.int64, device=DEVICE),
                     "batch") for i, t in enumerate(fed)]
        k3_ops.launches = k3_ops.simt_launches = 0
        sync()
        t0 = time.perf_counter()
        with LocalCost() as cost:
            logits, cache = cell.fn(*cell.args)
        sync()
        out["prefill_s"] = time.perf_counter() - t0
        out["prefill"] = tp_gather(logits)
        if keep_cache:
            out["cache"] = tuple(t.to_local().to("cpu", copy=True) for t in cache)
        out["prefill_cost"] = {"bytes": cost.collectives, "calls": cost.calls}
        for i in range(len(fed)):
            t0 = time.perf_counter()
            with LocalCost() if i == 0 else contextlib.nullcontext() as cost:
                logits, cache = decode_step(model, cache, fed[i], pos[i])
            sync()
            out["decode_s"].append(time.perf_counter() - t0)
            out["decode"].append(tp_gather(logits))
            if i == 0:
                out["decode_cost"] = {"bytes": cost.collectives, "calls": cost.calls}
    out["k3_launches"], out["k3_simt_launches"] = k3_ops.launches, k3_ops.simt_launches
    return out


def tp_world1(ref: dict, model) -> dict:
    """17a: one ``nccl`` rank on a (data 1, model 1) mesh.  ``model``
    (phase 8's, drawn again from its seed; sharded in place: every shard
    is the whole tensor, nothing is copied) through ``shard_cell``;
    prefill's logits and cache, and every decode step's logits, phase 8's
    bits."""
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.dist.sharding import AxisEnv
    from repro_torch.launch.cells import shard_cell

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ROOT / "build")
    # nccl on the card (a cpu rehearsal takes gloo)
    dist.init_process_group("nccl" if DEVICE == "cuda" else "gloo",
                            store=dist.FileStore(f"{tmp}/store", 1), rank=0, world_size=1)
    try:
        env = AxisEnv(DeviceMesh(DEVICE, [[0]], mesh_dim_names=("data", "model")))
        cell = shard_cell(prefill_cell(LM_ARCH, model, ref["tokens"].to(DEVICE),
                                       ref.get("smoke", False)), env)
        got = tp_serve(env, cell, ref["fed"], int(ref["tokens"].shape[1]), keep_cache=True)
        check(torch.equal(got["prefill"], ref["prefill_logits"]),
              "17a: the prefill's logits differ from phase 8's")
        for name, t, want in zip(("k", "v"), got.pop("cache"), ref["cache"]):
            check(torch.equal(t, want), f"17a: the cache's {name} differs from phase 8's "
                  f"prefill cache")
        for i, (a, b) in enumerate(zip(got.pop("decode"), ref["decode_logits"])):
            check(torch.equal(a, b), f"17a: decode step {i}'s logits differ from phase 8's")
        got.pop("prefill")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    cfg = model.cfg
    # (a rehearsal on the CPU launches no kernel)
    check(DEVICE != "cuda" or (got["k3_launches"] == cfg.n_layers
                               and got["k3_simt_launches"] == 0),
          f"17a: K3 launched {got['k3_launches']} (SIMT {got['k3_simt_launches']}) times, "
          f"expected {cfg.n_layers} per prefill on the tensor-core body")
    got["decode_ms_median"] = 1e3 * statistics.median(got.pop("decode_s"))
    log("17a world 1 (nccl, data 1 x model 1): prefill logits and cache and all "
        f"{len(ref['fed'])} decode steps' logits equal phase 8's bit for bit; "
        + " ".join(f"{k}={v!r}" for k, v in got.items()))
    return got


def tp_rank(mesh, path: str, seed: int, device: str, smoke: bool, n_layers: int) -> dict:
    """A rank of 17b: qwen3-14b at ``n_layers`` drawn whole from phase 8's
    seed, one rank after the other behind a barrier (two whole copies
    never coexist), sharded by ``shard_cell`` (each rank keeps its
    shards), then phase 8's traffic (prompts and fed tokens read from
    ``path``).  ``smoke``: the smoke config on ``device``, for a rehearsal
    on the CPU."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.dist.sharding import AxisEnv
    from repro_torch.launch.cells import shard_cell
    from repro_torch.models import TransformerLM

    global DEVICE
    DEVICE = device
    torch.set_grad_enabled(False)
    env = AxisEnv(mesh)
    with np.load(path) as z:
        tokens = torch.from_numpy(z["tokens"]).to(DEVICE)
        fed = [torch.from_numpy(t) for t in z["fed"]]
    rank = dist.get_rank()
    t0 = time.perf_counter()
    for r in range(dist.get_world_size()):
        if r == rank:
            cfg = dataclasses.replace((get_smoke_config if smoke else get_config)(LM_ARCH),
                                      n_layers=n_layers)
            model = TransformerLM(cfg, device=DEVICE,
                                  generator=torch.Generator(device=DEVICE).manual_seed(seed))
            cell = shard_cell(prefill_cell(LM_ARCH, model, tokens, smoke), env)
            del model
            if DEVICE == "cuda":
                torch.cuda.empty_cache()
        dist.barrier()
    draw_s = time.perf_counter() - t0
    weights = sum(p.to_local().numel() * p.element_size() for p in cell.args[0].parameters())
    cuda = DEVICE == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    out = tp_serve(env, cell, fed, int(tokens.shape[1]))
    out.update(draw_s=draw_s, weights_gb=weights / 1e9,
               serve_peak_gb=torch.cuda.max_memory_allocated() / 1e9 if cuda else None,
               prefill=out["prefill"].numpy(), decode=np.stack([d.numpy() for d in out["decode"]]))
    return out


def sharded_predicted(arch: str, mesh_shape: dict, n_layers: int | None, batch: int,
                      prompt: int, smoke: bool = False) -> dict:
    """The dry run's prediction for a mesh of ``mesh_shape``: the
    collectives of one rank's prefill of ``batch`` prompts of ``prompt``
    tokens and of one decode step on their cache (its batch split as the
    prefill leaves it, the tokens and positions on ``batch``), traced on
    meta under a fake process group of the mesh's ranks and extrapolated
    to ``n_layers`` (the config's depth when None), as
    ``repro_torch.launch.dryrun`` does for its cells."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.dist.sharding import AxisEnv
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.dryrun import sharded_cost
    from repro_torch.models import KVCache, cache_window

    meta = torch.device("meta")
    cfg = get_config(arch) if not smoke else get_smoke_config(arch)
    n_layers = n_layers or cfg.n_layers
    W, _ = cache_window(cfg, prompt)

    def prefill_at(n):
        cell = build_cell(arch, "prefill_32k", smoke=smoke, override_layers=n)
        return dataclasses.replace(cell, args=(cell.args[0], torch.empty(
            (batch, prompt), dtype=torch.int64, device=meta)))

    def decode_at(n):
        cell = build_cell(arch, "decode_32k", smoke=smoke, override_layers=n)
        kv = lambda: torch.empty((n, batch, W, cfg.n_kv_heads, cfg.d_head),
                                 dtype=getattr(torch, cfg.dtype), device=meta)
        vec = lambda: torch.empty((batch,), dtype=torch.int64, device=meta)
        cl = (None, "batch", "model", None, None)
        return dataclasses.replace(
            cell, args=(cell.args[0], KVCache(kv(), kv()), vec(), vec()),
            in_logical=(cell.in_logical[0], KVCache(cl, cl), ("batch",), ("batch",)))

    world = math.prod(mesh_shape.values())
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        env = AxisEnv(DeviceMesh(DEVICE, torch.arange(world).reshape(
            tuple(mesh_shape.values())), mesh_dim_names=tuple(mesh_shape)))
        return {step: sharded_cost(make, env, n_layers)
                for step, make in (("prefill", prefill_at), ("decode", decode_at))}
    finally:
        dist.destroy_process_group()


TP_TRAFFIC = ROOT / "build" / "phase17" / "traffic.npz"


def tp_ranks(seed: int, smoke: bool, n_layers: int) -> RanksAhead:
    """17b's two ranks, started ahead (they read TP_TRAFFIC at go)."""
    return RanksAhead(tp_rank, 2, backend="gloo", device=DEVICE,
                      args=(str(TP_TRAFFIC), seed, DEVICE, smoke, n_layers),
                      timeout=TP_TIMEOUT, mesh_shape={"data": 1, "model": 2})


def tp_world2(ref: dict, seed: int, ahead: RanksAhead | None = None) -> dict:
    """17b: two ``gloo`` ranks on the one card on a (data 1, model 2) mesh,
    phase 8's weights at ``ref["model_layers"]`` layers (each rank's shards
    of the seeded draw) and phase 8's traffic, held to ``ref``'s logits
    (that model unsharded, :func:`tp_depth_ref`; phase 8's own in the CPU
    rehearsal): within LM_TOL of the row's largest |logit|
    and the greedy tokens equal on every row whose top-2 margin that
    cannot close; each rank's collectives a step beside the dry run's
    prediction for this mesh.  gloo has no all-gather on CUDA tensors:
    the port gathers by an all-to-all of the same bytes there, so the
    ranks count as all-to-all what the prediction (the card's NCCL, the
    dry run's fake group) counts as all-gather.  The ranks are
    ``ahead``'s (:func:`tp_ranks`), or started here."""
    smoke = ref.get("smoke", False)
    t0 = time.perf_counter()
    ahead = ahead or tp_ranks(seed, smoke, ref["model_layers"])
    path = TP_TRAFFIC
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, tokens=ref["tokens"].numpy(),
             fed=np.stack([t.numpy() for t in ref["fed"]]))
    pred = beside(sharded_predicted, LM_ARCH, {"data": 1, "model": 2}, ref["model_layers"],
                  *ref["tokens"].shape, smoke=smoke)
    ranks = ahead.join()
    spawn_s = time.perf_counter() - t0
    path.unlink()
    import torch

    pairs = [(r, name, torch.from_numpy(a), want) for r, got in enumerate(ranks)
             for name, a, want in [("prefill", got["prefill"], ref["prefill_logits"])] + [
                 (f"decode step {i}", got["decode"][i], w)
                 for i, w in enumerate(ref["decode_logits"])]]
    errs = {}
    for r, name, a, want in pairs:
        scale = want.float().abs().amax(dim=-1, keepdim=True)
        errs[(r, name)] = float(((a - want.float()).abs() / scale).max())
    worst = max(errs.values())
    log(f"17b: largest |logit - the unsharded run's| over the row's largest |logit|, rank 0: "
        + ", ".join(f"{n} {e!r}" for (r, n), e in errs.items() if r == 0)
        + f"; worst over both ranks {worst!r}")
    log("17b ranks: " + " ".join(
        f"rank {r}: draw_s={g['draw_s']!r} weights_gb={g['weights_gb']!r} "
        f"serve_peak_gb={g['serve_peak_gb']!r} prefill_s={g['prefill_s']!r} "
        f"decode_ms_median={1e3 * statistics.median(g['decode_s'])!r};"
        for r, g in enumerate(ranks)) + f" spawn_s={spawn_s!r}")
    decided = tied = 0
    for r, name, a, want in pairs:
        d, t = greedy_check(f"17b rank {r} {name}", a, want)
        decided, tied = decided + d, tied + t
    counts = collectives_check("17b", ranks, pred())
    for r, got in enumerate(ranks):
        check(DEVICE != "cuda" or (got["k3_launches"] == ref["model_layers"]
                                   and got["k3_simt_launches"] == 0),
              f"17b rank {r}: K3 launched {got['k3_launches']} times "
              f"(SIMT {got['k3_simt_launches']}), expected {ref['model_layers']} a prefill")
    out = {"spawn_s": spawn_s, "n_layers": ref["model_layers"], "logit_rel_err_max": worst,
           "tolerance": LM_TOL,
           "rows_decided": decided, "rows_tied": tied, "collectives": counts,
           "ranks": [{k: got[k] for k in ("draw_s", "weights_gb", "serve_peak_gb", "prefill_s",
                                          "k3_launches")}
                     | {"decode_ms_median": 1e3 * statistics.median(got["decode_s"])}
                     for got in ranks]}
    log(f"17b world 2 (gloo, data 1 x model 2, one card): logits within {worst!r} of the row "
        f"scale of the unsharded run's at {ref['model_layers']} layers (tolerance {LM_TOL}), "
        f"greedy tokens equal on {decided} decided "
        f"rows ({tied} near-ties); " + " ".join(f"{k}={v!r}" for k, v in out.items()
                                                if k != "collectives"))
    return out


def k3_offset_checks(seed: int) -> dict:
    """17c: K3 with a non-zero ``q_offset`` (the rows of a sequence shard
    at qwen3-14b's attention shape, bf16) against its plain version with
    the same offset (the phase-6 checks) and against the same rows of K3
    over the whole sequence (bit for bit).  A correctness check: the
    launches are not timed."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

    B, Hq, Hkv, D = ATTN_SHAPE
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    out = {}
    for S, off, window in TP_OFFSETS:
        q, k, v = (torch.randn((B, S, h, D), generator=gen, device=DEVICE,
                               dtype=torch.float32).to(torch.bfloat16).permute(0, 2, 1, 3)
                   for h in (Hq, Hkv, Hkv))
        part = q[:, :, off:]
        got = flash_attention(part, k, v, window=window, q_offset=off)
        whole = flash_attention(q, k, v, window=window)
        sync()
        tag = f"K3 S={S} q_offset={off} window={window}"
        err, rel = attn_check(f"{tag} vs flash_attention_ref", got, flash_attention_ref(
            part, k, v, window=window, q_offset=off))
        same = bool(torch.equal(got, whole[:, :, off:]))
        check(same, f"{tag}: rows differ from K3 over the whole sequence")
        out[tag] = {"max_abs_err": err, "band_rel_err": rel, "same_bits_as_whole": same}
        log(f"17c {tag}: " + " ".join(f"{k}={v!r}" for k, v in out[tag].items()))
        del q, k, v, part, got, whole
    torch.cuda.empty_cache()
    return out


def phase_tensor_parallel(ref: dict, seed: int, ahead: RanksAhead | None = None) -> dict:
    """Phase 17, run last: 17c, then 17a on phase 8's model drawn again
    from its seed, freed before 17b's reference (:func:`tp_depth_ref`) and
    its ranks (``ahead``'s, or started here) draw theirs at TP_LAYERS.
    Last, so that the spawned ranks and the sharded runs precede no other
    phase's timing."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import TransformerLM

    t0 = time.perf_counter()
    torch.cuda.empty_cache()  # what earlier phases left reserved, for 17b's ranks too
    ahead = ahead or tp_ranks(seed, False, TP_LAYERS)  # they start while 17c and 17a run
    out = {"k3_offsets": k3_offset_checks(seed)}
    cfg = get_config(LM_ARCH)
    model = TransformerLM(cfg, device=DEVICE,
                          generator=torch.Generator(device=DEVICE).manual_seed(seed))
    out["world1"] = tp_world1(ref, model)
    del model
    torch.cuda.empty_cache()
    out["world2"] = tp_world2(tp_depth_ref(ref, seed, TP_LAYERS), seed, ahead)
    out["seconds"] = time.perf_counter() - t0
    return out


def tp_depth_ref(ref: dict, seed: int, n_layers: int) -> dict:
    """17b's reference: phase 8's model at ``n_layers`` layers, drawn from
    its seed, unsharded, on phase 8's prompts and fed tokens (``ref``):
    the prefill's and every decode step's logits on the host; the model
    freed after."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import TransformerLM, decode_step, prefill

    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=n_layers)
    model = TransformerLM(cfg, device=DEVICE,
                          generator=torch.Generator(device=DEVICE).manual_seed(seed))
    tokens = ref["tokens"].to(DEVICE)
    batch, prompt = tokens.shape
    logits, cache = prefill(model, tokens)
    out = {"tokens": ref["tokens"], "fed": ref["fed"], "prefill_logits": logits.cpu(),
           "decode_logits": [], "model_layers": n_layers}
    for i, tok in enumerate(ref["fed"]):
        logits, cache = decode_step(model, cache, tok.to(DEVICE), torch.full(
            (batch,), prompt + i, dtype=torch.int64, device=DEVICE))
        out["decode_logits"].append(logits.cpu())
    del model, cache, logits
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 18: the dense LM train step sharded on a DeviceMesh with FSDP
# ---------------------------------------------------------------------------

# 18a: 15c's step (qwen3-14b at TRAIN_LM_LAYERS, B 1 x 4,096 tokens,
# TRAIN_LM_ADAM) through shard_cell on one nccl rank, 15c's bits.  18b: two
# gloo ranks on the one card on (data 2, model 1), FSDP proper: the state
# (bf16 weights, float32 m and v) halved, each layer's weights gathered for
# its use and its gradients reduce-scattered, at FSDP_LAYERS of 40 layers,
# B 2 (one 4,096-token row a rank), FSDP_STEPS steps, against the unsharded
# port's steps on the same weights and batch.
# 8 layers are the largest depth whose two ranks peak under 90 % of the
# card's 80 GB together (35.61 GB a rank, 71.22 GB in all; 9 would take
# about 74.6 GB).  FSDP_LAYERS is 4, fsdp_controls' depth, where 18b's
# sharded steps (its "none" run on the H100) kept all but 3.43 % of a
# leaf's elements within the rule below: a step at 8 took 18.7-34.0 s a
# rank, and the whole run must end within 1,200 s on a slow host (PERF.md
# §6)
FSDP_LAYERS = 4
FSDP_STEPS = 2
FSDP_BATCH = 2
FSDP_TIMEOUT = 900  # seconds for 18b's spawn
FSDP_MEM_GB = 0.9 * 80  # both ranks' peaks together
# 18b's tolerances against the unsharded steps, set from the H100 runs at
# 6 and 8 layers (PERF.md): the ranks' bf16 gradient partials are rounded
# before the reduce-scatter adds them.  The loss moved by at most 1.9e-5
# relative, grad_norm by 4.8e-4 (step 2's, on the updated weights).  A
# parameter's elements lie within FSDP_ULPS of its ulps (or 1 % of a step,
# TRAIN_STEP_TOL, the float32 rehearsal's rule) of the reference's but for
# at most 4.06 % of a leaf's (w_down, wk, wq: Adam's second step divides m
# by sqrt(v), and where a leaf's two gradients nearly cancel the rounding
# moves the update).  fsdp_controls (--fsdp-controls) reads the rules on a
# wrong gradient and on the rounding's cause (PERF.md)
FSDP_LOSS_RTOL = 1e-4
FSDP_NORM_RTOL = 2e-3
FSDP_ULPS = 1
FSDP_ODD = 0.06
# fsdp_controls' alterations of 18b's sharded steps (rs_control), at
# FSDP_CONTROL_LAYERS: the unsharded step on two microbatches keeps a
# float32 gradient sum, which at 8 layers ran out of the card's memory
FSDP_CONTROLS = ("none", "drop", "f32")
FSDP_CONTROL_LAYERS = 4
# 18k: K3's Function under local_map, heads sharded on two gloo ranks
FSDP_K3_SHAPE = (1, 1024, 8, 2, 128)  # B, S, Hq, Hkv, D (bf16)
FSDP_BATCH_LOGICAL = {"tokens": ("batch", None), "labels": ("batch", None)}
DIGEST_CHUNK = 1 << 24


def bits_digest(t) -> tuple[int, int]:
    """A checksum of a tensor's bits, on its device: the sum of its
    elements' bit patterns as integers, and their sum weighted by the
    position modulo a prime (so that a moved or changed bit shows)."""
    import torch

    v = t.detach().contiguous().view(-1)
    v = v.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[v.element_size()])
    s1 = torch.zeros((), dtype=torch.int64, device=v.device)
    s2 = torch.zeros_like(s1)
    for i in range(0, v.numel(), DIGEST_CHUNK):
        c = v[i:i + DIGEST_CHUNK].to(torch.int64)
        w = torch.arange(i, i + c.numel(), device=v.device) % 65521 + 1
        s1 += c.sum()
        s2 += (c * w).sum()
    return int(s1), int(s2)


def train_digests(state) -> dict:
    """``bits_digest`` of every parameter, ``m`` and ``v`` leaf of an LM
    train state (a DTensor's local shard)."""
    from repro_torch.dist.sharding import local

    out = {f"params.{n}": bits_digest(local(p)) for n, p in state.params.named_parameters()}
    for tree in ("m", "v"):
        out.update({f"{tree}.{n}": bits_digest(local(t)) for n, t in getattr(state, tree).items()})
    return out


def fsdp_cfg(n_layers: int, smoke: bool):
    from repro_torch.configs import get_config, get_smoke_config

    cfg = (get_smoke_config if smoke else get_config)(LM_ARCH)
    return cfg if smoke else dataclasses.replace(cfg, n_layers=n_layers)


def fsdp_batch(cfg, B: int, S: int, seed: int) -> dict:
    """15c's batch: seeded tokens, the labels their roll by one."""
    import torch

    tokens = torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)))
    return {"tokens": tokens.to(DEVICE), "labels": torch.roll(tokens, -1, dims=1).to(DEVICE)}


def fsdp_step(microbatches: int = 1):
    """The train cells' step function at 15c's optimizer, each
    microbatch placed on ``batch`` when the state is sharded."""
    from repro_torch.models import lm_loss
    from repro_torch.train import AdamConfig, make_train_step

    return make_train_step(lambda m, b: lm_loss(m, b["tokens"], b["labels"]),
                           AdamConfig(**TRAIN_LM_ADAM), microbatches=microbatches,
                           batch_logical=FSDP_BATCH_LOGICAL)


def fsdp_state(cfg, seed: int, env=None):
    """The seeded weights drawn whole on the card and their train state; on
    ``env``'s mesh through ``shard_cell`` (the qwen3-14b train cell's
    logical axes), the module sharded before ``m`` and ``v`` are made, so
    that each rank allocates only its shards of them."""
    import torch

    from repro_torch.launch.cells import build_cell, shard_cell
    from repro_torch.models import TransformerLM
    from repro_torch.train import TrainState, init_train_state

    model = TransformerLM(cfg, device=DEVICE,
                          generator=torch.Generator(device=DEVICE).manual_seed(seed))
    if env is None:
        return init_train_state(model)
    cell = build_cell(LM_ARCH, "train_4k", override_layers=cfg.n_layers)
    bare = TrainState(params=model, m=None, v=None, step=None)
    cell = shard_cell(dataclasses.replace(cell, args=(bare, None), fn=None), env)
    return init_train_state(cell.args[0].params)


def fsdp_train(state, batch: dict, steps: int, env=None, cost_step: int | None = None,
               digest_step: int | None = None, microbatches: int = 1,
               digests: bool = False, routing: list | None = None,
               nll: list | None = None) -> tuple[dict, object]:
    """``steps`` train steps of ``state`` (sharded on ``env``'s mesh when
    given) of ``microbatches`` microbatches, K3's counters set to 0 just before and read just after: each
    step's loss, aux (a MoE LM's), grad_norm, lr and seconds; the
    collectives of step ``cost_step`` (``LocalCost``); the digests after
    step ``digest_step`` (``digests``: after every step, a list); with
    ``routing``, the routing of each step's forward (its first MoE call a
    layer, not the remat's) appended to it on the host
    (:func:`host_routing`); with ``nll``, each step's per-token NLL
    (:func:`nll_recorded`) appended to it; the state's bytes on this rank
    and the peak memory of the steps.  Returns the record and the state."""
    import torch

    from repro_torch.dist.sharding import LocalCost, local, use_axis_env
    from repro_torch.kernels.flash_attention import ops as k3_ops

    cuda = DEVICE == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    leaves = list(state.params.parameters()) + list(state.m.values()) + list(state.v.values())
    nbytes = lambda ts: sum(local(t).numel() * local(t).element_size() for t in ts)
    step = fsdp_step(microbatches)
    out = {"n_layers": state.params.cfg.n_layers, "metrics": [], "step_s": [],
           "state_gb": nbytes(leaves) / 1e9,  # on this rank
           "whole_gb": nbytes(t for t in leaves if local(t).numel() == t.numel()) / 1e9}
    n_layers = state.params.cfg.n_layers
    out["digests"] = []
    k3_ops.launches = k3_ops.simt_launches = 0
    with torch.enable_grad(), use_axis_env(env) if env is not None else contextlib.nullcontext():
        for i in range(steps):
            rec = []
            sync()
            t0 = time.perf_counter()
            with (LocalCost() if i == cost_step else contextlib.nullcontext() as cost,
                  routing_recorded(rec) if routing is not None else contextlib.nullcontext(),
                  nll_recorded(nll) if nll is not None else contextlib.nullcontext()):
                state, m = step(state, batch)
            sync()
            out["step_s"].append(time.perf_counter() - t0)
            out["metrics"].append({k: float(m[k]) for k in ("loss", "aux", "grad_norm", "lr")
                                   if k in m})
            if routing is not None:
                routing.extend(host_routing(r) for r in rec[:n_layers])
            del rec
            if i == cost_step:
                out["cost"] = {"bytes": dict(cost.collectives), "calls": dict(cost.calls)}
            if i == digest_step:
                out["digest"] = train_digests(state)
            if digests:
                out["digests"].append(train_digests(state))
    out["k3_launches"], out["k3_simt_launches"] = k3_ops.launches, k3_ops.simt_launches
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    return out, state


def fsdp_world1(step1: dict | None, seed: int, smoke: bool = False) -> dict:
    """18a: one ``nccl`` rank on a (data 1, model 1) mesh: 15c's train step
    (the seeded weights drawn again, 15c's batch) through ``shard_cell``,
    its loss, grad_norm and every updated parameter, ``m`` and ``v`` leaf
    (their digests) 15c's step 1 bit for bit.  ``step1`` None: the
    unsharded step is run here first at 18a's depth (a rehearsal)."""
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.dist.sharding import AxisEnv

    n_layers = step1["n_layers"] if step1 is not None else TRAIN_LM_LAYERS
    cfg = fsdp_cfg(n_layers, smoke)
    B, S = (TRAIN_LM_BATCH, TRAIN_LM_SEQ) if not smoke else (1, 64)
    batch = fsdp_batch(cfg, B, S, seed)
    if step1 is None:
        plain, state = fsdp_train(fsdp_state(cfg, seed), batch, 1, digest_step=0)
        step1 = {"n_layers": n_layers, "digest": plain["digest"], **plain["metrics"][0]}
        del state
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ROOT / "build")
    dist.init_process_group("nccl" if DEVICE == "cuda" else "gloo",
                            store=dist.FileStore(f"{tmp}/store", 1), rank=0, world_size=1)
    try:
        env = AxisEnv(DeviceMesh(DEVICE, [[0]], mesh_dim_names=("data", "model")))
        got, state = fsdp_train(fsdp_state(cfg, seed, env), batch, 1, env, cost_step=0,
                                digest_step=0)
        del state
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    m = got["metrics"][0]
    for k in ("loss", "grad_norm"):
        check(m[k] == step1[k], f"18a: {k} {m[k]!r}, 15c's step 1 {step1[k]!r}")
    differ = [k for k, d in step1["digest"].items() if got["digest"][k] != d]
    check(set(got["digest"]) == set(step1["digest"]) and not differ,
          f"18a: {len(differ)} leaves differ from 15c's step 1: {differ[:4]!r}")
    check(not any(got["cost"]["bytes"].values()), f"18a: one rank ran collectives "
          f"{got['cost']['bytes']!r}")
    check(DEVICE != "cuda" or (got["k3_launches"] == 2 * n_layers
                               and got["k3_simt_launches"] == 0),
          f"18a: K3 launched {got['k3_launches']} times (SIMT {got['k3_simt_launches']}), "
          f"expected {2 * n_layers} on the tensor-core body")
    out = {k: got[k] for k in ("n_layers", "metrics", "step_s", "state_gb", "peak_gb",
                               "k3_launches")} | {"leaves_equal": len(step1["digest"])}
    log("18a world 1 (nccl, data 1 x model 1): 15c's step 1 bit for bit (loss, grad_norm "
        f"and {len(step1['digest'])} parameter, m and v leaves); "
        + " ".join(f"{k}={v!r}" for k, v in out.items()))
    return out


def fsdp_draw(cfg, seed: int, env):
    """The seeded state on ``env``'s mesh (:func:`fsdp_state`), drawn by
    the ranks one after the other behind a barrier (two whole copies
    never coexist)."""
    import torch
    import torch.distributed as dist

    for r in range(dist.get_world_size()):
        if r == dist.get_rank():
            state = fsdp_state(cfg, seed, env)
            if DEVICE == "cuda":
                torch.cuda.empty_cache()
        dist.barrier()
    return state


def fsdp_shards(state) -> dict:
    """The rank's parameter shards on the host (bf16 as int16 bits), each
    with where it lies in its leaf."""
    import torch

    from repro_torch.dist.sharding import shard_span

    shards = {}
    for n, p in state.params.named_parameters():
        spans = [shard_span(p, d) for d in range(p.dim())]
        loc = p.to_local().detach().cpu()
        shards[n] = (loc.view(torch.int16).numpy() if loc.dtype == torch.bfloat16
                     else loc.numpy(), spans)
    return shards


def fsdp_rank_setup(device: str, smoke: bool, n_layers: int, path: str):
    """A spawned rank's config and batch (read from ``path``)."""
    import torch

    global DEVICE
    DEVICE = device
    torch.set_grad_enabled(False)
    with np.load(path) as z:
        batch = {k: torch.from_numpy(z[k]).to(DEVICE) for k in ("tokens", "labels")}
    return fsdp_cfg(n_layers, smoke), batch


def fsdp_rank(mesh, path: str, seed: int, device: str, smoke: bool, n_layers: int) -> dict:
    """A rank of 18b (and first 18k's, on a (data 1, model 2) mesh of the
    same ranks): the seeded model drawn whole and sharded by
    ``shard_cell`` (:func:`fsdp_draw`); FSDP_STEPS steps on the batch read
    from ``path``; the rank's updated parameter shards on the host."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.dist.sharding import AxisEnv

    cfg, batch = fsdp_rank_setup(device, smoke, n_layers, path)
    # 18k first, on the same ranks as (data 1, model 2): heads sharded
    k3 = fsdp_k3_rank(DeviceMesh(DEVICE, [list(range(dist.get_world_size()))],
                                 mesh_dim_names=("data", "model")), DEVICE)
    env = AxisEnv(mesh)
    t0 = time.perf_counter()
    state = fsdp_draw(cfg, seed, env)
    draw_s = time.perf_counter() - t0
    got, state = fsdp_train(state, batch, FSDP_STEPS, env, cost_step=0)
    got["draw_s"], got["k3"], got["shards"] = draw_s, k3, fsdp_shards(state)
    return got


def train_predicted(arch: str, mesh_shape: dict, n_layers: int, batch: int, seq: int,
                    smoke: bool = False) -> dict:
    """The dry run's prediction for a mesh of ``mesh_shape``: one rank's
    collectives in one train step of ``arch`` on ``batch`` x ``seq``
    tokens, traced on meta under a fake process group of the mesh's ranks
    at 1 and 2 layers and extrapolated to ``n_layers``, as
    ``repro_torch.launch.dryrun`` does for the train cells."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.dist.sharding import AxisEnv
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.dryrun import sharded_cost

    meta = torch.device("meta")

    def make(n):
        cell = build_cell(arch, "train_4k", smoke=smoke, override_layers=n)
        tokens = torch.empty((batch, seq), dtype=torch.int64, device=meta)
        return dataclasses.replace(cell, fn=fsdp_step(), args=(
            cell.args[0], {"tokens": tokens, "labels": tokens}))

    world = math.prod(mesh_shape.values())
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        env = AxisEnv(DeviceMesh(DEVICE, torch.arange(world).reshape(
            tuple(mesh_shape.values())), mesh_dim_names=tuple(mesh_shape)))
        return sharded_cost(make, env, n_layers)
    finally:
        dist.destroy_process_group()


def gloo_on_card(pred: dict) -> tuple[dict, dict]:
    """A prediction's bytes and calls by kind as the card's gloo ranks run
    them: a gather on a gloo group of CUDA ranks is an all-to-all."""
    p, calls = dict(pred["collectives"]), dict(pred["collective_calls"])
    if DEVICE == "cuda":
        for d in (p, calls):
            d["all-to-all"] += d.pop("all-gather")
            d["all-gather"] = 0
    return p, calls


def ulp_errs(got, want, floor: float) -> tuple[float, float, float]:
    """Of a leaf's elements: the share farther from the reference's value
    than FSDP_ULPS of its ulps and than ``floor``, the largest distance in
    those ulps, and the largest absolute distance (float32 on the card)."""
    import torch

    bits = {torch.bfloat16: 8, torch.float32: 24}[want.dtype]
    d = (got.float() - want.float()).abs()
    ulp = torch.ldexp(torch.ones_like(d), torch.frexp(want.float()).exponent - bits)
    ulps = d / ulp.clamp(min=2.0 ** -126)
    odd = (ulps > FSDP_ULPS) & (d > floor)
    return float(odd.float().mean()), float(ulps.max()), float(d.max())


def fsdp_leaves(want: dict, shards: list) -> dict:
    """:func:`ulp_errs` of each parameter against ``want`` (the unsharded
    run's, on the host), the leaf put together from the ranks' ``shards``
    (:func:`fsdp_shards`)."""
    import torch

    per_leaf = {}
    for n, w in want.items():
        w = w.to(DEVICE)
        got = torch.empty_like(w)
        for rank in shards:
            arr, spans = rank[n]
            sl = tuple(slice(a, a + k) for a, k in spans)
            t = torch.from_numpy(arr)
            got[sl] = (t.view(torch.bfloat16) if w.dtype == torch.bfloat16 else t).to(DEVICE)
        per_leaf[n] = ulp_errs(got, w, TRAIN_STEP_TOL * TRAIN_LM_ADAM["lr"])
        del w, got
    return per_leaf


FSDP_BATCH_PATH = ROOT / "build" / "phase18" / "batch.npz"


def fsdp_ranks(seed: int, smoke: bool) -> RanksAhead:
    """18b's two ranks, started ahead (they read FSDP_BATCH_PATH at go)."""
    return RanksAhead(fsdp_rank, 2, backend="gloo", device=DEVICE,
                      args=(str(FSDP_BATCH_PATH), seed, DEVICE, smoke, FSDP_LAYERS),
                      timeout=FSDP_TIMEOUT, mesh_shape={"data": 2, "model": 1})


def fsdp_world2(seed: int, smoke: bool = False, ahead: RanksAhead | None = None) -> dict:
    """18b: two ``gloo`` ranks on the one card on a (data 2, model 1) mesh,
    FSDP: the unsharded port's FSDP_STEPS steps first (kept on the host,
    then freed), then each rank's steps on its row of the batch.  Held to
    the unsharded steps: loss and grad_norm at FSDP_LOSS_RTOL and
    FSDP_NORM_RTOL, every updated parameter within FSDP_ULPS ulps (or 1 %
    of a step) but for FSDP_ODD of a leaf's elements; the state halved;
    each rank's collectives in step 1 equal to the dry run's prediction
    (gloo's gathers on the card as all-to-alls).  The ranks are
    ``ahead``'s (:func:`fsdp_ranks`), or started here."""
    import torch

    n_layers = FSDP_LAYERS
    ahead = ahead or fsdp_ranks(seed, smoke)
    cfg = fsdp_cfg(n_layers, smoke)
    B, S = FSDP_BATCH, (TRAIN_LM_SEQ if not smoke else 64)
    batch = fsdp_batch(cfg, B, S, seed + 1)
    t0 = time.perf_counter()
    plain, state = fsdp_train(fsdp_state(cfg, seed), batch, FSDP_STEPS)
    want = {n: p.detach().to("cpu", copy=True) for n, p in state.params.named_parameters()}
    del state
    plain_s = time.perf_counter() - t0
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    path = FSDP_BATCH_PATH
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **{k: v.cpu().numpy() for k, v in batch.items()})
    t0 = time.perf_counter()
    pred = beside(train_predicted, LM_ARCH, {"data": 2, "model": 1}, cfg.n_layers, B, S, smoke)
    ranks = ahead.join()
    spawn_s = time.perf_counter() - t0
    path.unlink()
    k3 = fsdp_k3_check([got.pop("k3") for got in ranks])
    log(f"18b metrics: " + "; ".join(f"rank {r}: {g['metrics']!r}" for r, g in enumerate(ranks))
        + f"; unsharded {plain['metrics']!r}")
    worst = {"loss": 0.0, "grad_norm": 0.0}
    for r, got in enumerate(ranks):
        for i, (g, w) in enumerate(zip(got["metrics"], plain["metrics"], strict=True)):
            check(g["lr"] == w["lr"], f"18b rank {r} step {i + 1}: lr {g['lr']!r}, {w['lr']!r}")
            for k, tol in (("loss", FSDP_LOSS_RTOL), ("grad_norm", FSDP_NORM_RTOL)):
                rel = abs(g[k] - w[k]) / abs(w[k])
                worst[k] = max(worst[k], rel)
                check(math.isfinite(g[k]) and rel <= tol,
                      f"18b rank {r} step {i + 1} {k}: {g[k]!r} against {w[k]!r} unsharded "
                      f"(relative {rel!r}, beyond {tol})")
    log(f"18b ranks' steps: " + "; ".join(
        f"rank {r}: {g['metrics']!r}, {g['step_s']!r} s, draw {g['draw_s']!r} s, peak "
        f"{g['peak_gb']!r} GB" for r, g in enumerate(ranks))
        + f"; unsharded {plain['metrics']!r}, {plain['step_s']!r} s; spawn {spawn_s!r} s")
    per_leaf = fsdp_leaves(want, [g["shards"] for g in ranks])
    leaf = {"odd_share_max": max(e[0] for e in per_leaf.values()),
            "ulps_max": max(e[1] for e in per_leaf.values()),
            "abs_max": max(e[2] for e in per_leaf.values())}
    log("18b parameters, the leaves with the most elements beyond tolerance (share, largest "
        "distance in ulps, largest distance): " + ", ".join(
            f"{n} {e!r}" for n, e in sorted(per_leaf.items(), key=lambda kv: -kv[1][0])[:8]))
    for n, (odd, _, dmax) in per_leaf.items():
        check(odd <= FSDP_ODD, f"18b {n}: {odd!r} of its elements beyond {FSDP_ULPS} ulps "
              f"and 1 % of a step (tolerance {FSDP_ODD}); largest distance {dmax!r}")
    for r, got in enumerate(ranks):
        got.pop("shards")
        # halved: each rank holds half of every leaf but the replicated norms
        half = (plain["state_gb"] + got["whole_gb"]) / 2
        check(abs(got["state_gb"] - half) <= 1e-9,
              f"18b rank {r}: state {got['state_gb']!r} GB ({got['whole_gb']!r} GB of it "
              f"whole), the unsharded {plain['state_gb']!r} GB")
        check(DEVICE != "cuda" or (got["k3_launches"] == 2 * n_layers * FSDP_STEPS
                                   and got["k3_simt_launches"] == 0),
              f"18b rank {r}: K3 launched {got['k3_launches']} times (SIMT "
              f"{got['k3_simt_launches']}), expected {2 * n_layers * FSDP_STEPS}")
    if DEVICE == "cuda":
        peak = sum(g["peak_gb"] for g in ranks)
        check(peak <= FSDP_MEM_GB, f"18b: the ranks' peaks {peak!r} GB, over {FSDP_MEM_GB} GB")
    p, calls = gloo_on_card(pred())
    for r, got in enumerate(ranks):
        check(got["cost"]["bytes"] == p, f"18b rank {r}: collectives {got['cost']['bytes']!r} "
              f"in step 1, the dry run's {p!r}")
    out = {"k3": k3, "n_layers": n_layers, "batch": B, "seq": S, "steps": FSDP_STEPS,
           "plain": {k: plain[k] for k in ("metrics", "step_s", "state_gb", "peak_gb")},
           "plain_s": plain_s, "spawn_s": spawn_s, "metrics_rel_err": worst, "leaves": leaf,
           "collectives": {"rank0": ranks[0]["cost"], "predicted": {"bytes": p, "calls": calls}},
           "ranks": [{k: g[k] for k in ("metrics", "step_s", "state_gb", "whole_gb", "peak_gb", "draw_s",
                                        "k3_launches")} for g in ranks]}
    log(f"18b world 2 (gloo, data 2 x model 1, one card), qwen3-14b at {n_layers} layers, "
        f"B {B} x {S}: loss and grad_norm within {worst!r} relative of the unsharded steps "
        f"(tolerances {FSDP_LOSS_RTOL}, {FSDP_NORM_RTOL}); parameters: {leaf!r} (at most "
        f"{FSDP_ODD} of a leaf beyond {FSDP_ULPS} ulps)")
    log(f"18b state and memory: unsharded {plain['state_gb']!r} GB of state, "
        f"{plain['peak_gb']!r} GB peak; " + "; ".join(
            f"rank {r}: {g['state_gb']!r} GB of state, {g['peak_gb']!r} GB peak, steps "
            f"{g['step_s']!r} s, draw {g['draw_s']!r} s" for r, g in enumerate(ranks))
        + f"; unsharded steps {plain['step_s']!r} s; spawn {spawn_s!r} s")
    log(f"18b collectives a rank in step 1: bytes {ranks[0]['cost']['bytes']!r}, calls "
        f"{ranks[0]['cost']['calls']!r}; the dry run's prediction for (data 2, model 1): bytes "
        f"{p!r}, calls {calls!r}")
    return out


def rs_control(name: str, rank: int):
    """A context that alters this rank's reduce-scatters (in 18b the
    gradients' only ones) for a control of 18b's leaf rule: ``"drop"``,
    rank 1 sends zeros, so that every gradient holds rank 0's partial
    alone (its half of the batch); ``"f32"``, a bf16 reduce-scatter runs
    in float32 and its sum is rounded to bf16 once; ``"none"`` alters
    nothing."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    if name == "none":
        return contextlib.nullcontext()
    c10d = torch.ops._c10d_functional

    class Control(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func.overloadpacket is c10d.reduce_scatter_tensor:
                x = args[0]
                if name == "drop" and rank == 1:
                    args = (torch.zeros_like(x), *args[1:])
                elif name == "f32" and x.dtype == torch.bfloat16:
                    out = c10d.wait_tensor(func(x.float(), *args[1:], **kwargs))
                    return out.to(torch.bfloat16)
            return func(*args, **kwargs)

    return Control()


def fsdp_control_rank(mesh, path: str, seed: int, device: str, smoke: bool,
                      n_layers: int, name: str) -> dict:
    """A rank of :func:`fsdp_controls`: 18b's state and FSDP_STEPS steps
    under control ``name`` (:func:`rs_control`): the metrics and the
    updated shards."""
    import torch.distributed as dist

    from repro_torch.dist.sharding import AxisEnv

    cfg, batch = fsdp_rank_setup(device, smoke, n_layers, path)
    env = AxisEnv(mesh)
    state = fsdp_draw(cfg, seed, env)
    with rs_control(name, dist.get_rank()):
        got, state = fsdp_train(state, batch, FSDP_STEPS, env)
    return {"metrics": got["metrics"], "step_s": got["step_s"], "shards": fsdp_shards(state)}


def fsdp_controls(seed: int, smoke: bool = False) -> dict:
    """Controls of 18b's rules (``--fsdp-controls``, a run of its own, not
    part of the run with no arguments), at FSDP_CONTROL_LAYERS layers and
    18b's batch and weights.  For each comparison: the largest share of a leaf's elements
    beyond FSDP_ULPS ulps and 1 % of a step (18b holds it to FSDP_ODD),
    the leaf, and the loss's and grad_norm's largest relative errors:

    - ``none``, ``drop``, ``f32``: the sharded steps as 18b runs them, with
      rank 1's gradient partials zeroed before the reduce-scatter (a
      wrong gradient, which the rules must refuse), and with the
      reduce-scatter in float32 (:func:`rs_control`), each against the
      unsharded steps;
    - ``micro2``: the unsharded steps on the batch as two microbatches of
      one row (each row's gradient rounded to bf16 before a float32 sum,
      as the ranks' partials are rounded before their sum), against the
      unsharded steps; ``none_vs_micro2``: the sharded steps against it."""
    import torch

    from repro_torch.dist import spawn

    n_layers = FSDP_CONTROL_LAYERS
    cfg = fsdp_cfg(n_layers, smoke)
    B, S = FSDP_BATCH, (TRAIN_LM_SEQ if not smoke else 64)
    batch = fsdp_batch(cfg, B, S, seed + 1)
    t0 = time.perf_counter()
    metrics, want = {}, {}
    for name, micro in (("plain", 1), ("micro2", 2)):
        got, state = fsdp_train(fsdp_state(cfg, seed), batch, FSDP_STEPS, microbatches=micro)
        metrics[name] = got["metrics"]
        want[name] = {n: p.detach().to("cpu", copy=True)
                      for n, p in state.params.named_parameters()}
        del state
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    out = {"n_layers": n_layers, "batch": B, "seq": S, "steps": FSDP_STEPS}

    def compare(name: str, ref: str, shards: list, got: list) -> None:
        per_leaf = fsdp_leaves(want[ref], shards)
        worst = max(per_leaf, key=lambda n: per_leaf[n][0])
        rel = {k: max(abs(g[k] - x[k]) / abs(x[k]) for g, x in zip(got, metrics[ref], strict=True))
               for k in ("loss", "grad_norm")}
        out[name] = {"odd_share_max": per_leaf[worst][0], "leaf": worst, "rel": rel,
                     "passes": (per_leaf[worst][0] <= FSDP_ODD and rel["loss"] <= FSDP_LOSS_RTOL
                                and rel["grad_norm"] <= FSDP_NORM_RTOL), "metrics": got}
        log(f"18b control {name}: largest share of a leaf beyond {FSDP_ULPS} ulps and 1 % of "
            f"a step {per_leaf[worst][0]!r} ({worst}; tolerance {FSDP_ODD}), loss and "
            f"grad_norm relative errors {rel!r}, within 18b's rules: {out[name]['passes']}")
        if DEVICE == "cuda":  # free for the ranks
            torch.cuda.empty_cache()

    compare("micro2", "plain", [{n: (t.view(torch.int16).numpy() if t.dtype == torch.bfloat16
                                     else t.numpy(), [(0, k) for k in t.shape])
                                 for n, t in want["micro2"].items()}], metrics["micro2"])
    path = ROOT / "build" / "phase18" / "batch.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **{k: v.cpu().numpy() for k, v in batch.items()})
    for name in FSDP_CONTROLS:  # one spawn each: one control's shards on the host at a time
        ranks = spawn(fsdp_control_rank, 2, backend="gloo", device=DEVICE,
                      args=(str(path), seed, DEVICE, smoke, n_layers, name),
                      timeout=FSDP_TIMEOUT, mesh_shape={"data": 2, "model": 1})
        shards = [r.pop("shards") for r in ranks]
        compare(name, "plain", shards, ranks[0]["metrics"])
        if name == "none":
            compare("none_vs_micro2", "micro2", shards, ranks[0]["metrics"])
        out[name]["step_s"] = ranks[0]["step_s"]
        del ranks, shards
    path.unlink()
    out["plain_metrics"] = metrics["plain"]
    out["seconds"] = time.perf_counter() - t0
    return out


def fsdp_k3_rank(mesh, device: str) -> dict:
    """A rank of 18k: K3's Function under ``local_map``, q [B, S, Hq, D]
    bf16 with its heads sharded on ``model``, k and v whole; dq, dk, dv
    gathered (a named redistribute) and held normwise against autograd of
    ``attention_ref`` in float32 on the same inputs."""
    import torch
    from torch.distributed.tensor import Replicate

    from repro_torch.dist.sharding import AxisEnv, place, redistribute, use_axis_env
    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.kernels.flash_attention import ops as k3_ops
    from repro_torch.models.attention import flash_attention

    B, S, Hq, Hkv, D = FSDP_K3_SHAPE
    dt = torch.bfloat16 if device == "cuda" else torch.float32
    gen = torch.Generator(device=device).manual_seed(LM_SEED)
    mk = lambda *s: torch.randn(s, device=device, generator=gen).to(dt)
    q, k, v, do = mk(B, S, Hq, D), mk(B, S, Hkv, D), mk(B, S, Hkv, D), mk(B, S, Hq, D)
    k3_ops.launches = 0
    with torch.enable_grad(), use_axis_env(AxisEnv(mesh)):
        qs = place(q, "batch", None, "model", None).requires_grad_(True)
        ks, vs = (place(t, "batch", None, None, None).requires_grad_(True) for t in (k, v))
        o = flash_attention(qs, ks, vs)
        got = torch.autograd.grad(o, (qs, ks, vs), place(do, "batch", None, "model", None))
        placements = [str(t.placements) for t in got]
        got = [redistribute(t, [Replicate()] * mesh.ndim).to_local() for t in got]
    with torch.enable_grad():
        ref = [t.float().permute(0, 2, 1, 3).clone().requires_grad_(True) for t in (q, k, v)]
        want = torch.autograd.grad(attention_ref(*ref), ref, do.float().permute(0, 2, 1, 3))
    errs = {n: float((g.float().permute(0, 2, 1, 3) - w).norm() / w.norm())
            for n, g, w in zip(("dq", "dk", "dv"), got, want)}
    return {"errs": errs, "placements": placements, "k3_launches": k3_ops.launches}


def fsdp_k3_check(ranks: list[dict]) -> dict:
    """18k, run by 18b's ranks before they train: K3's Function under
    ``local_map`` with the q heads sharded on two gloo ranks on the card
    (data 1, model 2): dq, dk and dv within TRAIN_ATTN_TOL (normwise) of
    plain autograd; one K3 launch a rank (off the main path)."""
    for r, got in enumerate(ranks):
        check(got["placements"][0] == "(Replicate(), Shard(dim=2))",
              f"18k rank {r}: dq placed {got['placements'][0]}")
        worst = max(got["errs"].values())
        check(worst <= TRAIN_ATTN_TOL, f"18k rank {r}: {got['errs']!r} beyond {TRAIN_ATTN_TOL}")
        check(DEVICE != "cuda" or got["k3_launches"] == 1,
              f"18k rank {r}: K3 launched {got['k3_launches']} times")
    out = {"shape": FSDP_K3_SHAPE, "ranks": ranks, "tolerance": TRAIN_ATTN_TOL}
    log(f"18k K3's Function under local_map, heads sharded on two gloo ranks (B, S, Hq, Hkv, D "
        f"= {FSDP_K3_SHAPE}): " + "; ".join(f"rank {r}: {g['errs']!r} {g['placements']!r}"
                                            for r, g in enumerate(ranks))
        + f" (tolerance {TRAIN_ATTN_TOL}, normwise)")
    return out


def phase_fsdp(step1: dict, seed: int, ahead: RanksAhead | None = None) -> dict:
    """Phase 18, run last: 18a on 15c's step, then 18b (whose ranks run
    18k first; ``ahead``'s, or started here)."""
    import torch

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    ahead = ahead or fsdp_ranks(seed, False)  # they start while 18a runs
    out = {"world1": fsdp_world1(step1, seed)}
    torch.cuda.empty_cache()
    out["world2"] = fsdp_world2(seed, ahead=ahead)
    out["k3"] = out["world2"].pop("k3")
    out["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# phase 19: the MoE LM serving path sharded on a DeviceMesh
# ---------------------------------------------------------------------------

# 19a and 19b serve olmoe-1b-7b at full depth (14c's seeded weights), 14c's
# prompts with its first MOE_TP_DECODE greedy tokens fed, then forward and
# lm_loss over the prompts; 19c serves mixtral-8x7b cut to MIXTRAL_TP_LAYERS
# of its 32 layers (23.7 GB: all 32, 93.4 GB, need four cards) on two ranks,
# held to the same model run unsharded just before.
MOE_TP_ARCH = "olmoe-1b-7b"
MOE_TP_DECODE = 8
MOE_TP_MESH = {"data": 2, "model": 2}
MIXTRAL_TP_ARCH = "mixtral-8x7b"
MIXTRAL_TP_LAYERS = 8
MIXTRAL_TP_MESH = {"data": 1, "model": 2}
MOE_TP_TIMEOUT = 600  # seconds for each of 19b's and 19c's spawns
# ranks that draw their whole model at once on the one card: two olmoe
# copies (13.8 GB each) and the shards fit, two of mixtral's 8 layers
# (23.7 GB each) beside the shards leave too little room
MOE_TP_DRAWS = {"olmoe-1b-7b": 2, "mixtral-8x7b": 1}
# 19b and 19c hold every logits row (prefill and decode) to the unsharded
# run within MOE_TP_TOL[arch] of the row's largest |logit|, a row whose token
# was routed alike (the same experts, the same kept) in every layer within
# MOE_TP_ALIKE_TOL, lm_loss and the aux loss within MOE_TP_LOSS_RTOL.  Each
# rank's bf16 products run over its own shapes (half the tokens, half the
# columns) and round each row-parallel product's partial sums to bf16 before
# adding them, so the hidden states differ from one device's by bf16 ulps,
# which move tokens to other experts layer after layer and, through the
# capacity positions, drop others; a rerouted token's own logits move by its
# gate times the difference of two experts' outputs.  Measured on an H100
# 80GB HBM3 at 700 W (ROADMAP C.12, `--c12 settle`): every row within 0.0476
# (olmoe) and 0.2597 (mixtral, a rerouted decode token), rows routed alike
# within 0.0320 and 0.0212, 12.1 % and 16.4 % of olmoe's token-layers
# rerouted; with no partial sum at all, (data 2, model 1), still 5.5 % and
# 6.3 %.  Two swapped-shard controls must fall beyond
# MOE_TP_CONTROL_FACTOR[control][arch] times the tolerance: each rank's
# experts replaced by its partner's (measured 0.4041 and 0.7707), then its
# rows of wo too (1.534 and 1.792).  Mixtral's experts-only swap reaches
# 2.2x its tolerance, not 3x: its sound run reads 0.2597, so no tolerance
# that passes it leaves 3x room under 0.7707
MOE_TP_TOL = {"olmoe-1b-7b": 0.12, "mixtral-8x7b": 0.35}
MOE_TP_ALIKE_TOL = 0.045
MOE_TP_CONTROL_FACTOR = {"experts": {"olmoe-1b-7b": 3, "mixtral-8x7b": 2},
                         "experts_wo": {"olmoe-1b-7b": 3, "mixtral-8x7b": 3}}
MOE_TP_LOSS_RTOL = 1e-3


def moe_tp_cfg(arch: str, n_layers: int | None, smoke: bool):
    from repro_torch.configs import get_config, get_smoke_config

    cfg = (get_smoke_config if smoke else get_config)(arch)
    return dataclasses.replace(cfg, n_layers=n_layers) if n_layers else cfg


def moe_tp_model(cfg, seed: int):
    """``cfg``'s seeded weights on DEVICE (14c's draw for its config)."""
    import torch

    from repro_torch.models import TransformerLM

    return TransformerLM(cfg, device=DEVICE,
                         generator=torch.Generator(device=DEVICE).manual_seed(seed))


def host_routing(r) -> dict:
    """A recorded routing on the host: this rank's part of ``topi`` and
    ``keep``, the global index of its first token and block, and its
    near-ties (:func:`near_ties`)."""
    from repro_torch.dist.sharding import local, shard_span

    return {"t0": shard_span(r.topi, 0)[0], "b0": shard_span(r.slot, 0)[0],
            "topi": local(r.topi).cpu(), "keep": local(r.keep).cpu(),
            "ties": near_ties(local(r.logits), r.topi.shape[1]).cpu()}


def moe_serve(env, cell, ref: dict, rec: list) -> dict:
    """Phase 19's traffic through a sharded MoE prefill cell on ``env``'s
    mesh: the prefill (K3's counters set to 0 just before and read just
    after; its collectives on this rank by ``LocalCost``), a decode step on
    each of ``ref``'s fed tokens (the first one's collectives), then,
    where ``ref`` has labels, ``forward`` and ``lm_loss`` over the prompts;
    the routing of the decode steps and ``forward`` appended to
    ``rec`` (:func:`host_routing`).
    Logits on the host; seconds; digests of the bits of ``forward``'s
    logits (this rank's shard) and of the aux and the loss."""
    import torch

    from repro_torch.dist.sharding import LocalCost, local, place, use_axis_env
    from repro_torch.kernels.flash_attention import ops as k3_ops
    from repro_torch.models import decode_step, forward, lm_loss

    model, tokens = cell.args
    prompt = tokens.shape[1]
    scoring = "labels" in ref
    out = {"decode": [], "decode_s": []}
    with use_axis_env(env):
        fed = [place(t.to(DEVICE), "batch") for t in ref["fed"]]
        pos = [place(torch.full((t.shape[0],), prompt + i, dtype=torch.int64, device=DEVICE),
                     "batch") for i, t in enumerate(ref["fed"])]
        k3_ops.launches = k3_ops.simt_launches = 0
        sync()
        t0 = time.perf_counter()
        with LocalCost() as cost:
            logits, cache = cell.fn(*cell.args)
        sync()
        out["prefill_s"] = time.perf_counter() - t0
        out["k3_launches"], out["k3_simt_launches"] = k3_ops.launches, k3_ops.simt_launches
        out["prefill"] = tp_gather(logits)
        out["prefill_cost"] = {"bytes": cost.collectives, "calls": cost.calls}
        routes = []
        with routing_recorded(routes):
            for i in range(len(fed)):
                t0 = time.perf_counter()
                with LocalCost() if i == 0 else contextlib.nullcontext() as cost:
                    logits, cache = decode_step(model, cache, fed[i], pos[i])
                sync()
                out["decode_s"].append(time.perf_counter() - t0)
                out["decode"].append(tp_gather(logits))
                if i == 0:
                    out["decode_cost"] = {"bytes": cost.collectives, "calls": cost.calls}
            del cache, logits
            if scoring:
                t0 = time.perf_counter()
                flogits, faux = forward(model, tokens)
                sync()
                out["forward_s"] = time.perf_counter() - t0
                out["forward_digest"] = bits_digest(local(flogits))
                out["aux_digest"], out["aux"] = bits_digest(local(faux)), float(local(faux))
                del flogits
        rec.extend(host_routing(r) for r in routes)
        del routes
        if not scoring:
            return out
        labels = place(ref["labels"].to(DEVICE), "batch", None)
        t0 = time.perf_counter()
        loss, _ = lm_loss(model, tokens, labels)
        sync()
        out["lm_loss_s"] = time.perf_counter() - t0
        out["loss_digest"], out["loss"] = bits_digest(local(loss)), float(local(loss))
    return out


def moe_tp_world1(ref: dict, seed: int) -> dict:
    """19a: one ``nccl`` rank on a (data 1, model 1) mesh.  olmoe-1b-7b at
    14c's depth drawn again from its seed, through ``shard_cell`` (every
    parameter a DTensor whose one shard is the whole tensor), 14c's
    prompts, its fed tokens, ``forward`` and ``lm_loss``: the prefill's
    and every decode step's logits 14c's bits, and the digests of
    ``forward``'s logits and aux and of ``lm_loss``'s value 14c's.  Its
    routing (decode steps and ``forward``, recorded) is what 19b's is
    counted against."""
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.dist.sharding import AxisEnv
    from repro_torch.launch.cells import shard_cell

    smoke = ref.get("smoke", False)
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ROOT / "build")
    dist.init_process_group("nccl" if DEVICE == "cuda" else "gloo",
                            store=dist.FileStore(f"{tmp}/store", 1), rank=0, world_size=1)
    try:
        env = AxisEnv(DeviceMesh(DEVICE, [[0]], mesh_dim_names=("data", "model")))
        model = moe_tp_model(moe_tp_cfg(MOE_TP_ARCH, ref["n_layers"], smoke), seed)
        cell = shard_cell(prefill_cell(MOE_TP_ARCH, model, ref["tokens"].to(DEVICE), smoke),
                          env)
        del model
        rec = []
        got = moe_serve(env, cell, ref, rec)
        del cell
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    check(torch.equal(got.pop("prefill"), ref["prefill_logits"]),
          "19a: the prefill's logits differ from 14c's")
    for i, (a, b) in enumerate(zip(got.pop("decode"), ref["decode_logits"])):
        check(torch.equal(a, b), f"19a: decode step {i}'s logits differ from 14c's")
    for key in ("forward_digest", "aux_digest", "loss_digest"):
        check(got[key] == ref[key], f"19a: {key} {got[key]!r} differs from 14c's {ref[key]!r}")
    check(DEVICE != "cuda" or (got["k3_launches"] == ref["n_layers"]
                               and got["k3_simt_launches"] == 0),
          f"19a: K3 launched {got['k3_launches']} (SIMT {got['k3_simt_launches']}) times, "
          f"expected {ref['n_layers']} per prefill on the tensor-core body")
    got["routing"] = rec
    got["decode_ms_median"] = 1e3 * statistics.median(got.pop("decode_s"))
    log("19a world 1 (nccl, data 1 x model 1): the prefill's and all "
        f"{len(ref['fed'])} decode steps' logits and the digests of forward's logits and aux "
        "and of lm_loss equal 14c's bit for bit; " + " ".join(
            f"{k}={v!r}" for k, v in got.items() if k != "routing"))
    return got


def partner_wo_shards(model, mesh) -> list[dict]:
    """On the host, the rows of the attention output projection ``wo``
    that shard_cell will give this rank's partner on the ``model`` dim:
    what the swapped-shard control loads besides the experts (its heads
    then meet another rank's rows of ``wo``; swapping ``wq``, ``wk`` and
    ``wv`` too would only renumber the heads, the same function)."""
    i = mesh.mesh_dim_names.index("model")
    partner = 1 - mesh.get_coordinate()[i]
    return [{"wo": lp.wo.detach().chunk(2, dim=0)[partner].to("cpu", copy=True)}
            for lp in model.layers]


def moe_ffn_sharded(env, seed: int, smoke: bool) -> dict:
    """19b: one layer's ``moe_ffn`` at olmoe-1b-7b's width on 14b's inputs
    (MOE_FFN_TOKENS tokens) sharded on ``env``'s mesh (the tokens on
    ``batch``, the experts on ``expert``) against the same call unsharded
    on this rank: the routing of this rank's blocks against the
    unsharded one's, the output normwise over the tokens routed alike, the
    aux loss."""
    from repro_torch.dist.sharding import local, place, use_axis_env
    from repro_torch.launch.cells import lm_param_logical
    from repro_torch.models import moe_ffn
    from repro_torch.models.moe import moe_route

    cfg = moe_tp_cfg(MOE_TP_ARCH, None, smoke)
    spec, T = cfg.moe, MOE_FFN_TOKENS
    x, w = moe_ffn_inputs(cfg, seed)
    want, aux_w = moe_ffn(x, *w, spec)
    r = moe_route(x, w[0], spec)
    names = lm_param_logical(cfg, fsdp=False)["layers"]["moe"]
    rec = []
    with use_axis_env(env):
        xs = place(x, "batch", None)
        ws = [place(t, *names[n][1:]) for t, n in zip(w, ("router", "w_gate", "w_up", "w_down"))]
        with routing_recorded(rec):
            got, aux_g = moe_ffn(xs, *ws, spec)
        got = tp_gather(got)
    g = host_routing(rec[0])
    n_tok, n_blk = g["topi"].shape[0], g["keep"].shape[0]
    topi_w = r.topi[g["t0"]:g["t0"] + n_tok].cpu()
    keep_w = r.keep[g["b0"]:g["b0"] + n_blk].cpu()
    alike = ((g["topi"] == topi_w).all(dim=-1)
             & (g["keep"] == keep_w).reshape(n_tok, spec.top_k).all(dim=-1))
    rows = slice(g["t0"], g["t0"] + n_tok)
    diff = got[rows].float()[alike] - want.cpu()[rows].float()[alike]
    rel = float(diff.norm() / want.cpu()[rows].float()[alike].norm())
    return {"tokens": n_tok, "routed_alike": int(alike.sum()),
            "routing_equal": bool(alike.all()), "normwise_err": rel,
            "max_abs_err": float(diff.abs().max()),
            "aux_rel_err": abs(float(local(aux_g)) - float(aux_w)) / abs(float(aux_w))}


def moe_tp_rank(mesh, path: str, arch: str, n_layers: int | None, seed: int, device: str,
                smoke: bool) -> dict:
    """A rank of 19b or 19c: ``arch`` drawn whole from the seed (at
    ``n_layers``), MOE_TP_DRAWS[arch] ranks at a time behind a barrier
    (so many whole copies at once), sharded by ``shard_cell`` (each rank keeps its
    shards; its partner's expert shards and rows of ``wo`` kept on the
    host), then :func:`moe_serve` on the traffic in ``path``; for
    olmoe-1b-7b :func:`moe_ffn_sharded`; last (on a model dim of two
    ranks), the swapped-shard controls: this rank's expert shards replaced
    by its partner's, the prefill again (``control_prefill``), then its
    rows of ``wo`` too, the prefill again (``control_wo_prefill``).
    ``smoke``: the smoke config on ``device``, for a rehearsal on the
    CPU."""
    import pickle

    import torch
    import torch.distributed as dist

    from repro_torch.dist.sharding import AxisEnv, use_axis_env
    from repro_torch.launch.cells import shard_cell

    global DEVICE
    DEVICE = device
    torch.set_grad_enabled(False)
    cuda = DEVICE == "cuda"
    if not cuda:
        torch.set_num_threads(1)  # the ranks share the host's cores
    env = AxisEnv(mesh)
    with open(path, "rb") as f:
        ref = pickle.load(f)
    cfg = moe_tp_cfg(arch, n_layers, smoke)
    rank = dist.get_rank()
    controls = mesh.size(mesh.mesh_dim_names.index("model")) == 2
    t0 = time.perf_counter()
    at_once = MOE_TP_DRAWS[arch]
    for r in range(0, dist.get_world_size(), at_once):
        if r <= rank < r + at_once:
            model = moe_tp_model(cfg, seed)
            if controls:
                partner = (partner_expert_shards(model, env, fsdp=False),
                           partner_wo_shards(model, mesh))
            cell = shard_cell(prefill_cell(arch, model, ref["tokens"].to(DEVICE), smoke),
                              env)
            del model
            if cuda:
                torch.cuda.empty_cache()
        dist.barrier()
    draw_s = time.perf_counter() - t0
    weights = sum(p.to_local().numel() * p.element_size() for p in cell.args[0].parameters())
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    rec = []
    out = moe_serve(env, cell, ref, rec)
    out.update(draw_s=draw_s, weights_gb=weights / 1e9, routing=rec,
               serve_peak_gb=torch.cuda.max_memory_allocated() / 1e9 if cuda else None)
    if arch == MOE_TP_ARCH:
        out["ffn512"] = moe_ffn_sharded(env, seed, smoke)
    if not controls:  # no partner on a model dim of one rank
        return out
    for key, swap in zip(("control_prefill", "control_wo_prefill"), partner):
        for lp, shards in zip(cell.args[0].layers, swap):
            for name, t in shards.items():
                getattr(lp, name).to_local().copy_(t)
        with use_axis_env(env):
            logits, _ = cell.fn(*cell.args)
            out[key] = tp_gather(logits)
    return out


def moe_tp_rank_f32(*args) -> dict:
    """:func:`moe_tp_rank` with the attention's row-parallel partial sums
    formed and all-reduced in float32 and rounded once to the activations'
    dtype (``transformer._out_proj`` replaced in this rank): ROADMAP
    C.12's diagnostic (``--c12 settle``)."""
    from repro_torch.dist.sharding import settle
    from repro_torch.models import transformer

    transformer._out_proj = lambda o, wo: settle(o.float() @ wo.float()).to(o.dtype)
    return moe_tp_rank(*args)


def routing_rows(ref_rec: list, got_rec: list, n_layers: int, K: int) -> dict:
    """Rule 1 counts of a rank's recorded routing against the reference's
    (the same calls, ``n_layers`` a step), by the set of a token's experts
    (their order only orders its gates' sum): tokens routed to other
    experts, how many of them are near-ties of the reference's logits,
    assignments kept by one and dropped by the other among the tokens
    routed alike, and, per step, the global indices of the tokens routed
    differently (experts or drops) in some layer."""
    check(len(ref_rec) == len(got_rec), f"{len(got_rec)} MoE calls recorded, the "
          f"reference {len(ref_rec)}")

    def by_expert(topi, keep):
        order = topi.argsort(dim=-1)
        return topi.gather(-1, order), keep.reshape(topi.shape).gather(-1, order)

    out = {"rerouted": 0, "rerouted_near_ties": 0, "near_ties": 0, "keep_differs": 0,
           "tokens": 0, "steps": [], "rerouted_by_layer": [0] * n_layers}
    for c, (w, g) in enumerate(zip(ref_rec, got_rec)):
        if c % n_layers == 0:
            out["steps"].append(set())
        n_tok, n_blk = g["topi"].shape[0], g["keep"].shape[0]
        ties = w["ties"][g["t0"]:g["t0"] + n_tok]
        e_w, k_w = by_expert(w["topi"][g["t0"]:g["t0"] + n_tok],
                             w["keep"][g["b0"]:g["b0"] + n_blk])
        e_g, k_g = by_expert(g["topi"], g["keep"])
        differ = (e_g != e_w).any(dim=-1)
        kdiff = (k_g != k_w).any(dim=-1) & ~differ
        out["rerouted"] += int(differ.sum())
        out["rerouted_by_layer"][c % n_layers] += int(differ.sum())
        out["rerouted_near_ties"] += int((differ & ties).sum())
        out["near_ties"] += int(ties.sum())
        out["keep_differs"] += int(((k_g != k_w) & ~differ[:, None]).sum())
        out["tokens"] += n_tok
        out["steps"][-1] |= {g["t0"] + int(t) for t in (differ | kdiff).nonzero().flatten()}
    return out


def moe_tp_check(tag: str, ref: dict, ranks: list, n_layers: int, K: int, arch: str
                 ) -> dict:
    """The logits checks of 19b and 19c on every rank's host copies:
    every row within ``tol`` of the row scale of ``ref``'s, the greedy
    tokens equal on every row whose top-2 margin that error cannot close;
    a row whose token was routed alike in every layer (against ``ref``'s
    recorded routing: the decode steps' tokens, and, where ``forward``
    was recorded, each prompt's last token for the prefill's rows) within
    MOE_TP_ALIKE_TOL; the swapped-shard controls beyond their factors
    (MOE_TP_CONTROL_FACTOR) times ``tol`` on some row; the loss and aux
    loss, where run, within MOE_TP_LOSS_RTOL.  ``tol`` is
    MOE_TP_TOL[arch].  Returns the errors and counts."""
    tol = MOE_TP_TOL[arch]
    B = ref["prefill_logits"].shape[0]
    S = ref["tokens"].shape[1]
    n_dec = len(ref["decode_logits"])
    names = ["prefill"] + [f"decode step {i}" for i in range(n_dec)]
    wants = [ref["prefill_logits"]] + list(ref["decode_logits"])
    rel = lambda a, want: ((a.float() - want.float()).abs().amax(-1)
                           / want.float().abs().amax(-1))
    out = {"rel_err": {}, "alike_rel_err": 0.0, "rows_alike": 0, "rows": 0, "decided": 0,
           "tied": 0, "routing": []}
    for r, got in enumerate(ranks):
        bad_rows = None
        if "routing" in ref:
            rt = routing_rows(ref["routing"], got["routing"], n_layers, K)
            out["routing"].append({k: v for k, v in rt.items() if k != "steps"})
            steps = rt["steps"]  # the decode steps', then forward's if run
            # a decode step's row b is its token b; the prefill's row b the
            # last token of prompt b, which forward routes at b * S + S - 1
            # (with no forward, the prefill's rows count as rerouted)
            bad_rows = [{b for b in range(B) if len(steps) == n_dec
                         or b * S + S - 1 in steps[n_dec]}] + [
                {b for b in range(B) if b in steps[i]} for i in range(n_dec)]
        for j, (name, a, want) in enumerate(zip(names, [got["prefill"]] + got["decode"],
                                                 wants)):
            e = rel(a, want)
            out["rel_err"][f"rank {r} {name}"] = float(e.max())
            d, t = greedy_check(f"{tag} rank {r} {name}", a, want, tol)
            out["decided"] += d
            out["tied"] += t
            out["rows"] += B
            if bad_rows is not None:
                alike = [b for b in range(B) if b not in bad_rows[j]]
                out["rows_alike"] += len(alike)
                if alike:
                    worst = float(e[alike].max())
                    out["alike_rel_err"] = max(out["alike_rel_err"], worst)
                    check(worst <= MOE_TP_ALIKE_TOL, f"{tag} rank {r} {name}: rows routed "
                          f"alike {alike} off by {worst!r} of the row scale (tolerance "
                          f"{MOE_TP_ALIKE_TOL})")
        for key, what, name in (("control_prefill", "experts", "control_rel_err"),
                                ("control_wo_prefill", "experts_wo", "control_wo_rel_err")):
            if key not in got:
                continue
            ctrl = float(rel(got[key], ref["prefill_logits"]).max())
            out.setdefault(name, []).append(ctrl)
            factor = MOE_TP_CONTROL_FACTOR[what][arch]
            check(ctrl > factor * tol, f"{tag} rank {r}: the swapped-shard control "
                  f"({what.replace('_', ' and ')} swapped) is within {ctrl!r} of the row "
                  f"scale, not {factor} x the tolerance {tol}")
        for key in ("loss", "aux"):
            if key in ref and key in got:
                e = abs(got[key] - ref[key]) / abs(ref[key])
                out[f"{key}_rel_err"] = max(out.get(f"{key}_rel_err", 0.0), e)
                check(e <= MOE_TP_LOSS_RTOL, f"{tag} rank {r}: {key} {got[key]!r} against "
                      f"{ref[key]!r} (rtol {MOE_TP_LOSS_RTOL})")
    out["logit_rel_err_max"] = max(out["rel_err"].values())
    return out


def collectives_check(tag: str, ranks: list, pred: dict) -> dict:
    """Each rank's collectives in a prefill and a decode step against the
    dry run's prediction for its mesh (:func:`sharded_predicted`); on the
    card gloo's gathers are all-to-alls (the prediction's all-gathers)."""
    counts = {}
    for step in ("prefill", "decode"):
        p, _ = gloo_on_card(pred[step])
        for r, got in enumerate(ranks):
            c = got[f"{step}_cost"]["bytes"]
            check(c == p, f"{tag} rank {r} {step}: collectives {c!r} against the dry run's "
                  f"{p!r}")
        counts[step] = {"rank0": ranks[0][f"{step}_cost"],
                        "predicted": {"bytes": p, "calls": pred[step]["collective_calls"]}}
        log(f"{tag} {step}: collectives per rank {ranks[0][f'{step}_cost']!r}; the dry run's "
            f"prediction: bytes {p!r}, calls {pred[step]['collective_calls']!r}")
    return counts


def moe_tp_ranks(tag: str, seed: int, arch: str, n_layers: int | None, mesh_shape: dict,
                 smoke: bool, rank_fn=moe_tp_rank) -> RanksAhead:
    """19b's or 19c's ranks, started ahead (they read their traffic file,
    :func:`moe_tp_traffic`, at go)."""
    return RanksAhead(rank_fn, math.prod(mesh_shape.values()), backend="gloo", device=DEVICE,
                      args=(str(moe_tp_traffic(tag)), arch, n_layers, seed, DEVICE, smoke),
                      timeout=MOE_TP_TIMEOUT, mesh_shape=mesh_shape)


def moe_tp_traffic(tag: str) -> Path:
    return ROOT / "build" / "phase19" / f"{tag}.pkl"


def moe_tp_spawn(tag: str, ref: dict, seed: int, arch: str, n_layers: int | None,
                 mesh_shape: dict, rank_fn=moe_tp_rank, ahead: RanksAhead | None = None) -> dict:
    """19b / 19c: ``gloo`` ranks on the one card on a ``mesh_shape`` mesh,
    each with its shards of ``arch``'s seeded draw, serving ``ref``'s
    traffic (:func:`moe_tp_rank`), held to ``ref`` (its outputs and
    recorded routing) by :func:`moe_tp_check` at ``MOE_TP_TOL[arch]``,
    their collectives to the dry run's prediction, K3 one tensor-core
    launch a layer a prefill on every rank.  The ranks are ``ahead``'s
    (:func:`moe_tp_ranks`), or started here."""
    import pickle

    smoke = ref.get("smoke", False)
    t0 = time.perf_counter()
    ahead = ahead or moe_tp_ranks(tag, seed, arch, n_layers, mesh_shape, smoke, rank_fn)
    cfg = moe_tp_cfg(arch, n_layers, smoke)
    path = moe_tp_traffic(tag)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(pickle.dumps({k: ref[k] for k in ("tokens", "fed", "labels") if k in ref}))
    B, S = ref["tokens"].shape
    pred = beside(sharded_predicted, arch, mesh_shape, n_layers, B, S, smoke)
    ranks = ahead.join()
    spawn_s = time.perf_counter() - t0
    path.unlink()
    res = moe_tp_check(tag, ref, ranks, cfg.n_layers, cfg.moe.top_k, arch)
    res["collectives"] = collectives_check(tag, ranks, pred())
    for r, got in enumerate(ranks):
        check(DEVICE != "cuda" or (got["k3_launches"] == cfg.n_layers
                                   and got["k3_simt_launches"] == 0),
              f"{tag} rank {r}: K3 launched {got['k3_launches']} times (SIMT "
              f"{got['k3_simt_launches']}), expected {cfg.n_layers} a prefill")
        if "ffn512" in got:
            f = got["ffn512"]
            check(f["normwise_err"] <= MOE_FFN_TOL and f["aux_rel_err"] <= LOSS_RTOL,
                  f"{tag} rank {r}: moe_ffn at {MOE_FFN_TOKENS} tokens sharded against "
                  f"unsharded: {f!r} (tolerances {MOE_FFN_TOL}, {LOSS_RTOL})")
    keys = ("draw_s", "weights_gb", "serve_peak_gb", "prefill_s", "forward_s", "lm_loss_s",
            "k3_launches", "ffn512")
    res["ranks"] = [{k: got[k] for k in keys if k in got}
                    | {"decode_ms_median": 1e3 * statistics.median(got["decode_s"])}
                    for got in ranks]
    res.update(spawn_s=spawn_s, mesh=dict(mesh_shape), n_layers=cfg.n_layers,
               tolerance=MOE_TP_TOL[arch], alike_tolerance=MOE_TP_ALIKE_TOL)
    log(f"{tag} ranks: " + " ".join(f"rank {r}: " + " ".join(
        f"{k}={v!r}" for k, v in g.items()) + ";" for r, g in enumerate(res["ranks"])))
    log(f"{tag} ({mesh_shape}, gloo, one card, {cfg.n_layers} layers): logits within "
        f"{res['logit_rel_err_max']!r} of the row scale (tolerance {MOE_TP_TOL[arch]}); rows "
        f"routed alike {res['rows_alike']} of {res['rows']} within "
        f"{res['alike_rel_err']!r} ({MOE_TP_ALIKE_TOL}); greedy tokens equal on "
        f"{res['decided']} decided rows ({res['tied']} near-ties); swapped-shard controls "
        f"{res.get('control_rel_err')!r} (experts), {res.get('control_wo_rel_err')!r} "
        f"(experts and wo); routing against the reference's "
        f"{res['routing']!r}; "
        + " ".join(f"{k}={res[k]!r}" for k in ("loss_rel_err", "aux_rel_err", "spawn_s")
                   if k in res))
    return res


def mixtral_tp_ref(seed: int, smoke: bool = False, prompt: int = LM_PROMPT,
                   n_dec: int = MOE_TP_DECODE) -> dict:
    """19c's reference: mixtral-8x7b at MIXTRAL_TP_LAYERS layers (the
    smoke config when ``smoke``) unsharded on DEVICE, phase 8's prompts
    (``LM_BATCH`` x ``prompt``), the prefill and ``n_dec`` greedy decode
    steps (their routing recorded); the model freed, its logits, fed
    tokens and routing kept on the host."""
    import torch

    from repro_torch.models import decode_step, prefill

    cfg = moe_tp_cfg(MIXTRAL_TP_ARCH, None if smoke else MIXTRAL_TP_LAYERS, smoke)
    model = moe_tp_model(cfg, seed)
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (LM_BATCH, prompt))).to(DEVICE)
    t0 = time.perf_counter()
    logits, cache = prefill(model, tokens)
    sync()
    ref = {"tokens": tokens.cpu(), "prefill_logits": logits.to("cpu", copy=True), "fed": [],
           "decode_logits": [], "smoke": smoke, "prefill_s": time.perf_counter() - t0,
           "routing": []}
    with routing_recorded(ref["routing"]):
        for i in range(n_dec):
            tok = logits.argmax(-1)
            ref["fed"].append(tok.cpu())
            logits, cache = decode_step(model, cache, tok, torch.full(
                (LM_BATCH,), prompt + i, dtype=torch.int64, device=DEVICE))
            ref["decode_logits"].append(logits.to("cpu", copy=True))
    ref["routing"] = [host_routing(r) for r in ref["routing"]]
    ref["weights_gb"] = sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9
    del model, cache, logits
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return ref


def phase_moe_tp(ref: dict, seed: int, beside_19c=None, ahead_b: RanksAhead | None = None,
                 ahead_c: RanksAhead | None = None) -> dict:
    """Phase 19, run last: 19a on one ``nccl`` rank, 19b on four ``gloo``
    ranks on (data 2, model 2), held to 14c's run (``ref``, kept on the
    host) and to 19a's routing; 19c, mixtral-8x7b at MIXTRAL_TP_LAYERS
    layers on two ``gloo`` ranks on (data 1, model 2), held to the same
    model unsharded.  ``beside_19c``, a function of no argument, runs in a
    thread (:func:`beside`) from 19c's start to its end, its result under
    ``"beside_19c"``: 19c's two ranks leave the card's memory and the
    host's cores room for another phase's.  19b's and 19c's ranks are
    ``ahead_b``'s and ``ahead_c``'s (:func:`moe_tp_ranks`), or started
    here."""
    import torch

    t0 = time.perf_counter()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    smoke = ref.get("smoke", False)
    # 19b's ranks start while 19a runs, 19c's while 19b's run
    ahead_b = ahead_b or moe_tp_ranks("19b", seed, MOE_TP_ARCH, ref["n_layers"], MOE_TP_MESH,
                                      smoke)
    ahead_c = ahead_c or moe_tp_ranks("19c", seed, MIXTRAL_TP_ARCH,
                                      None if smoke else MIXTRAL_TP_LAYERS, MIXTRAL_TP_MESH, smoke)
    out = {"world1": moe_tp_world1(ref, seed)}
    # 19b's routing is counted against 19a's
    out["world4"] = moe_tp_spawn("19b", dict(ref, routing=out["world1"].pop("routing")), seed,
                                 MOE_TP_ARCH, ref["n_layers"], MOE_TP_MESH, ahead=ahead_b)
    t1 = time.perf_counter()
    other = beside(beside_19c) if beside_19c is not None else None
    mref = mixtral_tp_ref(seed, smoke=smoke,
                          prompt=int(ref["tokens"].shape[1]), n_dec=len(ref["fed"]))
    out["mixtral_unsharded"] = {k: mref[k] for k in ("prefill_s", "weights_gb")}
    out["world2_mixtral"] = moe_tp_spawn(
        "19c", mref, seed, MIXTRAL_TP_ARCH, None if mref["smoke"] else MIXTRAL_TP_LAYERS,
        MIXTRAL_TP_MESH, ahead=ahead_c)
    out["mixtral_s"] = time.perf_counter() - t1
    if other is not None:
        out["beside_19c"] = other()
        out["beside_19c_wait_s"] = time.perf_counter() - t1 - out["mixtral_s"]
    out["seconds"] = time.perf_counter() - t0
    log(f"19: {out['seconds']!r} s (19c {out['mixtral_s']!r} s)")
    return out


# ---------------------------------------------------------------------------
# phase 20: the Spade cells and gcn-cora's train step through shard_cell
# ---------------------------------------------------------------------------

SPADE_ARCH = "spade-grab"
SPADE_CELL_FIELDS = {"grab4_static": ("level", "best_level", "best_g", "n_rounds", "delta"),
                     "grab4_stream": ("level", "best_g", "community", "edge_count", "w0")}
CELLS_TP_MESH = {"data": 2, "model": 2}  # 20b's and 20c's, one spawn of four ranks
GCN_TP_SHAPE = "ogb_products"
GCN_TP_STEPS = 3
# 20c holds each step's loss and grad_norm to the unsharded step's at
# GCN_TP_RTOL: the ranks add the aggregate's partial sums over the two edge
# blocks, the loss's numerator over the vertex shards and the gradients'
# partial sums in another order than one device (float32 roundings of sums
# over 2.45M rows); the parameters at 16c's rule (cell_params_check)
GCN_TP_RTOL = 1e-5
SHARDED_CELLS_TIMEOUT = 600  # seconds for 20b's, 20c's and 20d's spawn
# 20d trains GAT, MeshGraphNet and DimeNet at their published widths (GAT 8
# heads of 8, MeshGraphNet 15 steps of H 128, DimeNet 6 blocks of H 128) on
# minibatch_lg (Reddit's sampled block: 169,984 nodes, 168,960 edges, 602
# features; DimeNet's 675,840 triplets), in 20c's spawn, against their
# unsharded steps; ogb_products needs four cards (PERF.md).  One step: a
# second took 13.5 s of the ranks' time (MeshGraphNet 5.5, DimeNet 7.7) in
# a run that must end within 1,200 s on a slow host (PERF.md §6)
GNN_TP_ARCHS = ("gat-cora", "meshgraphnet", "dimenet")
GNN_TP_SHAPE = "minibatch_lg"
GNN_TP_STEPS = 1
# 20d holds each step's loss and grad_norm to the unsharded step's at
# GNN_TP_RTOL (index_add_'s float atomics on the card sum in no fixed
# order, unsharded too; the ranks add the row sums, the softmax
# denominators and the triplets' sums over the edge group), and the
# parameters at 16c's rule (cell_params_check) but for GNN_TP_ODD of a
# leaf's elements (set for a second step, which GNN_TP_STEPS 2 runs):
# Adam's second step on gradients near 0 moves them by
# up to lr, and two unsharded MeshGraphNet steps 2 on the card already
# differ in 0.69 % of enc_node's w0, DimeNet's in 0.055 % of embed_node
# (PERF.md §6); each run logs the largest share a step, sharded
# (odd_share) and between the unsharded runs (unsharded_odd_share,
# gnn_tp_unsharded).  GAT's control (rank 1's softmax
# denominators left unsummed) must miss the loss by at least
# GNN_TP_CONTROL_MARGIN times its tolerance
GNN_TP_RTOL = {"gat-cora": 1e-5, "meshgraphnet": 1e-5, "dimenet": 1e-5}
GNN_TP_ODD = {"gat-cora": 1e-3, "meshgraphnet": 3e-2, "dimenet": 5e-3}
GNN_TP_CONTROL_MARGIN = 3


def spade_step(cell) -> tuple:
    """One step of a (sharded) Spade cell, K1's, K2's and ``suffix_init``'s
    counters and the engine's ``STATS`` set to 0 just before and read just
    after: (result, seconds, launches, K2's split, all-reduces, bytes)."""
    from repro_torch.dist import graph as dg

    zero_kernel_counts()
    sync()
    t0 = time.perf_counter()
    res = cell.fn(*cell.args)
    sync()
    return res, {"step_s": time.perf_counter() - t0, "launches": kernel_counts(),
                 "split": k2_split(), "all_reduces": dg.STATS["all_reduces"],
                 "reduced_bytes": dg.STATS["reduced_bytes"]}


def spade_predicted(shape: str, mesh, smoke: bool = False) -> dict:
    """The dry run's count of a Spade cell's collectives a rank a step on
    ``mesh`` (``launch.dryrun.spade_cost``)."""
    from repro_torch.dist.sharding import AxisEnv
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.dryrun import spade_cost

    c = spade_cost(build_cell(SPADE_ARCH, shape, smoke=smoke), AxisEnv(mesh))
    return {"all_reduces": c["collective_calls"]["all-reduce"],
            "reduced_bytes": c["collectives"]["all-reduce"]}


def spade_host(res, shape: str) -> dict:
    """A cell's output fields on the host (the stream cell's graph too)."""
    out = {f: getattr(res, f).to("cpu", copy=True) for f in SPADE_CELL_FIELDS[shape]}
    if shape == "grab4_stream":
        out["graph"] = {f: getattr(res.graph, f).to("cpu", copy=True) for f in SHARD_EDGES}
    return out


def best_g_bound(want: dict, shape: str, edges: int, max_rounds: int) -> float:
    """How far a sharded ``best_g`` may lie from one device's on unit
    weights (``dist/graph.py``'s docstring): f0 (``edges``) and each
    round's dropped mass past 2^24 round apart by up to a float32 ulp of
    f0 each, so the best suffix's f by (1 + 2 max_rounds) of them, over
    its vertices."""
    if shape == "grab4_static":
        lv = want["level"]
        n = int(((lv >= want["best_level"]) | (lv < 0)).sum())
    else:
        n = int(want["community"].sum())
    return (1 + 2 * max_rounds) * float(np.spacing(np.float32(edges))) / max(n, 1)


def spade_world1(bits: dict, seed: int, smoke: bool = False) -> dict:
    """20a: one ``nccl`` rank on a (data 1, model 1) mesh: both Spade cells
    at the spade-grab capacities through ``shard_cell``, each step 16c's
    bits (``bits``: every field, the stream cell's graph joined by
    ``unshard_graph``), K1, K2 and ``suffix_init`` launched as in 16c, and
    the dry run's 21 all-reduces a step."""
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.dist import graph as dg
    from repro_torch.dist.sharding import AxisEnv
    from repro_torch.launch.cells import build_cell, shard_cell

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ROOT / "build")
    dist.init_process_group("nccl" if DEVICE == "cuda" else "gloo",
                            store=dist.FileStore(f"{tmp}/store", 1), rank=0, world_size=1)
    out = {}
    try:
        mesh = DeviceMesh(DEVICE, [[0]], mesh_dim_names=("data", "model"))
        for shape, want in bits.items():
            cell = shard_cell(build_cell(SPADE_ARCH, shape, concrete=True, seed=seed,
                                         smoke=smoke, device=DEVICE), AxisEnv(mesh))
            res, row = spade_step(cell)
            rounds = cell.fn.keywords["max_rounds"]
            if shape == "grab4_stream":
                res = dataclasses.replace(res, graph=dg.unshard_graph(
                    res.graph, mesh, cell.fn.keywords["axis"]))
            got = spade_host(res, shape)
            for f in SPADE_CELL_FIELDS[shape]:
                check(torch.equal(got[f], want[f]), f"20a {shape}: {f} differs from 16c's")
            for f in want.get("graph", ()):
                check(torch.equal(got["graph"][f], want["graph"][f]),
                      f"20a {shape}: the joined graph's {f} differs from 16c's")
            pred = spade_predicted(shape, mesh, smoke)
            check(row["launches"] == want["launches"],
                  f"20a {shape}: launches {row['launches']!r}, 16c's {want['launches']!r}")
            check({k: row[k] for k in pred} == pred and pred["all_reduces"] == 1 + rounds,
                  f"20a {shape}: {row['all_reduces']} all-reduces of {row['reduced_bytes']} B, "
                  f"the dry run's {pred!r}")
            out[shape] = {k: v for k, v in row.items() if k != "split"} | {"predicted": pred}
            log(f"20a {shape} world 1 ({dist.get_backend()}, data 1 x model 1) through "
                f"shard_cell: 16c's bits"
                + (", the joined graph included" if "graph" in want else "") + "; "
                + " ".join(f"{k}={v!r}" for k, v in out[shape].items()))
            del cell, res
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return out


@contextlib.contextmanager
def dropped_round_partials(rank: int):
    """The control of 20b's ``best_g`` rule: rank ``rank``'s ``dw`` and
    dropped mass left out of the first round's all-reduce of each peel."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist import graph as dg

    round_reduce = dg._round_reduce

    def patched(buf, group):
        reduce, first = round_reduce(buf, group), [True]

        def dropped(dw, drop_mass):
            if first[0] and dist.get_rank() == rank:
                dw.zero_()
                drop_mass = torch.zeros_like(drop_mass)
            first[0] = False
            return reduce(dw, drop_mass)

        return dropped

    dg._round_reduce = patched
    try:
        yield
    finally:
        dg._round_reduce = round_reduce


def spade_cells_rank(mesh, seed: int, device: str, cfg: dict, smoke: bool = False) -> dict:
    """A rank of 20b: both Spade cells at the spade-grab capacities through
    ``shard_cell`` on ``mesh``, each drawn from the seed, one step each
    (counters, the engine's ``STATS`` and the dry run's count); the stream
    cell's graph joined by ``unshard_graph`` (rank 0 keeps it, the others
    its digests); the static cell again with rank 0's first-round partials
    dropped (:func:`dropped_round_partials`: rank 0's edge group, the
    ranks at model 0, goes wrong)."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist import graph as dg
    from repro_torch.dist.sharding import AxisEnv
    from repro_torch.launch.cells import build_cell, shard_cell

    global DEVICE
    DEVICE = device
    set_grab_config(cfg)
    torch.set_grad_enabled(False)
    rank = dist.get_rank()
    out = {}
    for shape in SPADE_CELL_FIELDS:
        t0 = time.perf_counter()
        cell = shard_cell(build_cell(SPADE_ARCH, shape, concrete=True, seed=seed,
                                     smoke=smoke, device=DEVICE), AxisEnv(mesh))
        build_s = time.perf_counter() - t0
        res, row = spade_step(cell)
        row.update(build_s=build_s, predicted=spade_predicted(shape, mesh, smoke),
                   max_rounds=cell.fn.keywords["max_rounds"],
                   world=cell.args[0].world if shape == "grab4_static"
                   else cell.args[0].graph.world)
        if shape == "grab4_stream":
            res = dataclasses.replace(res, graph=dg.unshard_graph(
                res.graph, mesh, cell.fn.keywords["axis"]))
        row["host"] = spade_host(res, shape)
        if shape == "grab4_stream":
            row["graph_digest"] = {f: bits_digest(t.to(torch.int16) if t.dtype == torch.bool
                                                  else t)
                                   for f, t in row["host"]["graph"].items()}
            if rank:
                del row["host"]["graph"]
        else:
            with dropped_round_partials(0):
                row["control_best_g"] = float(cell.fn(*cell.args).best_g)
        out[shape] = row
        del cell, res
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    return out


def spade_sharded_world4(bits: dict, ranks: list) -> dict:
    """20b: the four ``gloo`` ranks' Spade cells (:func:`spade_cells_rank`)
    on (data 2, model 2), the edges split two ways and replicated over
    ``model``, against 16c's bits (``level``, ``community``,
    ``edge_count``, ``w0``, ``best_level``, ``n_rounds``, ``delta`` and
    the joined edge blocks bit for bit; ``best_g`` bit for bit or within
    :func:`best_g_bound`, whose control must fall outside it); every
    rank's all-reduces and bytes the dry run's; K2 on the vector path on
    every rank; launches as 16c's."""
    import torch

    out = {}
    for shape, want in bits.items():
        rows = [r[shape] for r in ranks]
        exact = [f for f in SPADE_CELL_FIELDS[shape] if f != "best_g"]
        for i, row in enumerate(rows):
            got = row["host"]
            for f in exact:
                check(torch.equal(got[f], want[f]), f"20b {shape} rank {i}: {f} differs")
            check(torch.equal(got["best_g"], rows[0]["host"]["best_g"]),
                  f"20b {shape} rank {i}: best_g differs from rank 0's")
            check(vector_split_ok(row["split"]),
                  f"20b {shape} rank {i}: K2 left the vector path: {row['split']!r}")
            check(row["launches"] == want["launches"],
                  f"20b {shape} rank {i}: launches {row['launches']!r}, 16c's "
                  f"{want['launches']!r}")
            pred = row["predicted"]
            check({k: row[k] for k in pred} == pred
                  and pred["all_reduces"] == 1 + row["max_rounds"],
                  f"20b {shape} rank {i}: {row['all_reduces']} all-reduces of "
                  f"{row['reduced_bytes']} B, the dry run's {pred!r}")
            check(row["world"] == CELLS_TP_MESH["data"],
                  f"20b {shape} rank {i}: an edge group of {row['world']}")
        bound = best_g_bound(want, shape, want["edges"], rows[0]["max_rounds"])
        g1, gs = float(want["best_g"]), float(rows[0]["host"]["best_g"])
        res = {"best_g": gs, "best_g_16c": g1, "best_g_diff": gs - g1, "best_g_bound": bound,
               "bits_equal_best_g": gs == g1,
               "step_s": [r["step_s"] for r in rows], "build_s": [r["build_s"] for r in rows],
               "all_reduces": rows[0]["all_reduces"], "reduced_bytes": rows[0]["reduced_bytes"],
               "launches": [r["launches"] for r in rows]}
        check(abs(gs - g1) <= bound, f"20b {shape}: best_g {gs!r} against 16c's {g1!r}: "
              f"{gs - g1!r} beyond the predicted {bound!r}")
        if shape == "grab4_stream":
            for f, t in want["graph"].items():
                check(torch.equal(rows[0]["host"]["graph"][f], t),
                      f"20b {shape}: the joined graph's {f} differs from 16c's")
            for i, row in enumerate(rows):
                check(row["graph_digest"] == rows[0]["graph_digest"],
                      f"20b {shape} rank {i}: its joined graph differs from rank 0's")
        else:
            ctrl = [r["control_best_g"] for r in rows]
            res["control_best_g_diff"] = [c - g1 for c in ctrl]
            check(abs(ctrl[0] - g1) > bound,
                  f"20b {shape}: the dropped-partials control's best_g {ctrl[0]!r} on rank 0 "
                  f"lies within {bound!r} of 16c's {g1!r}")
        out[shape] = res
        log(f"20b {shape} world 4 (gloo, one card, data 2 x model 2) through shard_cell: "
            f"{', '.join(exact)}" + (" and the joined edge blocks" if "graph" in want else "")
            + " bit for bit with 16c's; " + " ".join(f"{k}={v!r}" for k, v in res.items()))
    return out


@contextlib.contextmanager
def dropped_aggregate(rank: int):
    """The control of 20c: rank ``rank``'s partial sums of the first
    layer's aggregate (its first two K4 launches) replaced by zeros."""
    import torch.distributed as dist

    from repro_torch.models import gnn

    k4, calls = gnn._k4, [0]

    def dropped(rows, x, n_out):
        calls[0] += 1
        out = k4(rows, x, n_out)
        return out.zero_() if dist.get_rank() == rank and calls[0] <= 2 else out

    gnn._k4 = dropped
    try:
        yield
    finally:
        gnn._k4 = k4


def gcn_metrics(state, m, **extra) -> dict:
    """A train step's loss, grad_norm, lr and parameters on the host."""
    from repro_torch.dist.sharding import local

    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "lr": float(m["lr"]),
            "params": {k: local(v).detach().to("cpu", copy=True)
                       for k, v in named_params(state.params).items()}} | extra


def gcn_unsharded(seed: int, smoke: bool = False) -> list:
    """20c's reference: gcn-cora's train cell at GCN_TP_SHAPE on DEVICE,
    GCN_TP_STEPS steps, each step's metrics and parameters on the host."""
    import torch

    from repro_torch.launch.cells import build_cell

    cell = build_cell("gcn-cora", GCN_TP_SHAPE, concrete=True, seed=seed, smoke=smoke,
                      device=DEVICE)
    steps = []
    for _ in range(GCN_TP_STEPS):
        sync()
        t0 = time.perf_counter()
        state, m = cell.fn(*cell.args)
        sync()
        steps.append(gcn_metrics(state, m, step_s=time.perf_counter() - t0))
    del cell, state
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return steps


def gcn_predicted(mesh_shape: dict, smoke: bool = False, arch: str = "gcn-cora",
                  shape: str = GCN_TP_SHAPE) -> dict:
    """The dry run's prediction for 20c's mesh: one rank's collectives in
    one train step of the cell, traced on meta under a fake process group
    of the mesh's ranks (``launch.dryrun.sharded_cost``); 20d's: another
    GNN's cell at its shape."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.dist.sharding import AxisEnv
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.dryrun import sharded_cost

    world = math.prod(mesh_shape.values())
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        env = AxisEnv(DeviceMesh(DEVICE, torch.arange(world).reshape(
            tuple(mesh_shape.values())), mesh_dim_names=tuple(mesh_shape)))
        return sharded_cost(lambda n: build_cell(arch, shape, smoke=smoke), env, None)
    finally:
        dist.destroy_process_group()


def gcn_sharded_rank(mesh, seed: int, device: str, smoke: bool = False) -> dict:
    """A rank of 20c: gcn-cora's train cell drawn from the seed, through
    ``shard_cell`` (each rank keeps its vertex rows and edge block); the
    control step (:func:`dropped_aggregate` on rank 1), the state put back,
    then GCN_TP_STEPS steps under ``use_axis_env``, K4's counter set to 0
    before each, the first one's collectives counted by ``LocalCost``."""
    import torch

    from repro_torch import pytree
    from repro_torch.dist.sharding import AxisEnv, LocalCost, local, use_axis_env
    from repro_torch.kernels.gather_segsum import ops as k4_ops
    from repro_torch.launch.cells import build_cell, shard_cell

    global DEVICE
    DEVICE = device
    cuda = DEVICE == "cuda"
    env = AxisEnv(mesh)
    t0 = time.perf_counter()
    if not cuda:
        torch.set_num_threads(1)  # the ranks share the host's cores
    cell = shard_cell(build_cell("gcn-cora", GCN_TP_SHAPE, concrete=True, seed=seed,
                                 smoke=smoke, device=DEVICE), env)
    out = {"build_s": time.perf_counter() - t0, "steps": []}
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    state = cell.args[0]
    leaves = [local(t) for t in pytree.leaves((state.params, state.m, state.v))] + [state.step]
    kept = [t.clone() for t in leaves]
    with use_axis_env(env), dropped_aggregate(1):
        out["control"] = gcn_metrics(*cell.fn(*cell.args))
    for t, k in zip(leaves, kept):
        t.copy_(k)
    for i in range(GCN_TP_STEPS):
        k4_ops.launches = 0
        sync()
        t1 = time.perf_counter()
        with use_axis_env(env), LocalCost() if i == 0 else contextlib.nullcontext() as cost:
            state, m = cell.fn(*cell.args)
        sync()
        row = gcn_metrics(state, m, step_s=time.perf_counter() - t1,
                          k4_launches=k4_ops.launches)
        if i == 0:
            row["cost"] = {"bytes": cost.collectives, "calls": cost.calls}
        out["steps"].append(row)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    return out


def gcn_step_errs(got: dict, want: dict, rtol: float = GCN_TP_RTOL,
                  odd_share: float = TRAIN_ODD[False]) -> tuple[bool, dict]:
    """Whether a step is within 20c's rules of the unsharded step (loss and
    grad_norm at ``rtol``, lr equal, the parameters at 16c's rule, which
    lets ``odd_share`` of a leaf's elements stray), and the errors."""
    import torch

    errs = {k: abs(got[k] - want[k]) / abs(want[k]) for k in ("loss", "grad_norm")}
    ok = all(e <= rtol for e in errs.values()) and got["lr"] == want["lr"]
    lr = want["lr"]
    for k, w in want["params"].items():
        d = (got["params"][k] - w).abs()
        ulp = torch.nextafter(w.abs(), torch.tensor(float("inf"))) - w.abs()
        odd = int((d > TRAIN_STEP_TOL * lr + 2 * ulp).sum())
        ok = ok and odd <= max(2, odd_share * d.numel()) and float(d.max()) <= 2 * lr
        errs[f"odd {k}"] = odd
    return ok, errs


def gcn_sharded_world4(want: list, pred: dict, ranks: list) -> dict:
    """20c: the four ``gloo`` ranks' gcn-cora train steps on ogbn-products
    (GCN_TP_SHAPE, full width; :func:`gcn_sharded_rank`) on (data 2,
    model 2) against the unsharded steps on the same seed and batch
    (``want``, :func:`gcn_unsharded`): each step within
    :func:`gcn_step_errs`' rules on every rank, the control outside them,
    K4 launched 8 times a step on each rank, each rank's collectives in
    step 1 the dry run's (``pred``, :func:`gcn_predicted`; gloo's gathers
    are all-to-alls on the card)."""
    p = dict(pred["collectives"])
    if DEVICE == "cuda":
        p["all-to-all"] += p.pop("all-gather")
        p["all-gather"] = 0
    out = {"errs": [], "control_errs": [], "unsharded_step_s": [s["step_s"] for s in want]}
    for r, got in enumerate(ranks):
        for i, (g, w) in enumerate(zip(got["steps"], want)):
            ok, errs = gcn_step_errs(g, w)
            check(ok, f"20c rank {r} step {i + 1}: {errs!r} (rtol {GCN_TP_RTOL})")
            check(DEVICE != "cuda" or g["k4_launches"] == 8,
                  f"20c rank {r} step {i + 1}: K4 launched {g['k4_launches']} times, not 8")
            out["errs"].append(errs)
        ok, errs = gcn_step_errs(got["control"], want[0])
        check(not ok, f"20c rank {r}: the dropped-aggregate control passes: {errs!r}")
        out["control_errs"].append({k: errs[k] for k in ("loss", "grad_norm")})
        c = got["steps"][0]["cost"]["bytes"]
        check(c == p, f"20c rank {r}: collectives {c!r}, the dry run's {p!r}")
    out.update(collectives=ranks[0]["steps"][0]["cost"], predicted={
        "bytes": p, "calls": pred["collective_calls"]},
        step_s=[[s["step_s"] for s in g["steps"]] for g in ranks],
        peak_gb=[g["peak_gb"] for g in ranks], build_s=[g["build_s"] for g in ranks],
        k4_launches=sum(s["k4_launches"] for g in ranks for s in g["steps"]),
        loss=[s["loss"] for s in want])
    out["max_rel_err"] = max(max(e["loss"], e["grad_norm"]) for e in out["errs"])
    log(f"20c gcn-cora {GCN_TP_SHAPE} world 4 (gloo, one card, data 2 x model 2) through "
        f"shard_cell, {GCN_TP_STEPS} steps: loss and grad_norm within "
        f"{out['max_rel_err']!r} of the unsharded steps (rtol {GCN_TP_RTOL}), the parameters "
        f"at 16c's rule, K4 8 launches a step on each rank, collectives the dry run's; "
        + " ".join(f"{k}={out[k]!r}" for k in ("collectives", "step_s", "unsharded_step_s",
                                                "peak_gb", "build_s", "control_errs")))
    return out


def gnn_tp_unsharded(seed: int, smoke: bool = False) -> dict:
    """20d's references: each of GNN_TP_ARCHS' train cells at GNN_TP_SHAPE
    on DEVICE, GNN_TP_STEPS steps (each step's metrics and parameters on
    the host), then the same steps again from the same state: the card's
    own spread (``index_add_``'s float atomics), which GNN_TP_ODD reads."""
    import torch

    from repro_torch import pytree
    from repro_torch.launch.cells import build_cell

    out = {}
    for arch in GNN_TP_ARCHS:
        cell = build_cell(arch, GNN_TP_SHAPE, concrete=True, seed=seed, smoke=smoke,
                          device=DEVICE)
        state = cell.args[0]
        leaves = pytree.leaves((state.params, state.m, state.v)) + [state.step]
        kept = [t.clone() for t in leaves]
        runs = []
        for _ in range(2):
            with torch.no_grad():
                for t, k in zip(leaves, kept):
                    t.copy_(k)
            steps = []
            for _ in range(GNN_TP_STEPS):
                sync()
                t0 = time.perf_counter()
                res, m = cell.fn(*cell.args)
                sync()
                steps.append(gcn_metrics(res, m, step_s=time.perf_counter() - t0))
            runs.append(steps)
        out[arch] = {"steps": runs[0], "spread": [
            gcn_step_errs(a, b, 1.0, 1.0)[1] for a, b in zip(runs[1], runs[0])]}
        del cell, state, res, leaves, kept
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    return out


def gnn_remat(seed: int, smoke: bool = False, steps: int = 3) -> dict:
    """The reference's remat on the card (``--gnn-remat``): MeshGraphNet's
    and DimeNet's unsharded train steps at GNN_TP_SHAPE with the
    processor step and the interaction block rematerialised, as shipped,
    and without (``models.gnn._remat`` a plain call), in turns (remat,
    plain, plain, remat; ``steps`` steps each): step seconds and the peak
    memory above the state; and one DimeNet step's device time by kernel
    (the profiler's ten largest)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.cells import build_cell
    from repro_torch.models import gnn

    cuda = DEVICE == "cuda"
    remat, plain = gnn._remat, lambda fn, *args: fn(*args)
    out = {}
    with torch.enable_grad():
        for arch in ("meshgraphnet", "dimenet"):
            cell = build_cell(arch, GNN_TP_SHAPE, concrete=True, seed=seed, smoke=smoke,
                              device=DEVICE)
            rows = {"remat": [], "plain": []}
            try:
                for tag in ("remat", "plain", "plain", "remat"):
                    gnn._remat = remat if tag == "remat" else plain
                    for _ in range(steps):
                        sync()
                        if cuda:
                            torch.cuda.reset_peak_memory_stats()
                        base = torch.cuda.memory_allocated() if cuda else 0
                        t0 = time.perf_counter()
                        cell.fn(*cell.args)
                        sync()
                        rows[tag].append({"step_s": time.perf_counter() - t0, "peak_above_gb": (
                            torch.cuda.max_memory_allocated() - base) / 1e9 if cuda else None})
            finally:
                gnn._remat = remat
            out[arch] = rows
            if arch == "dimenet":
                acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
                with profile(activities=acts) as prof:
                    cell.fn(*cell.args)
                    sync()
                top = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)[:10]
                out["dimenet_kernels_ms"] = [(e.key, e.count, e.self_device_time_total / 1e3)
                                             for e in top]
            del cell
            if cuda:
                torch.cuda.empty_cache()
    log(f"gnn remat at {GNN_TP_SHAPE}: " + json.dumps(out))
    return out


@contextlib.contextmanager
def unsummed_denominators(rank: int):
    """The control of 20d: rank ``rank``'s GAT softmax denominators left
    unsummed over the edge group (it still joins the all-reduce, forward
    and backward, so that no rank waits)."""
    import torch.distributed as dist

    from repro_torch.models import gnn

    edge_sum = gnn._edge_sum

    def unsummed(x, sh):
        out = edge_sum(x, sh)
        return x + (out - out.detach()) if dist.get_rank() == rank else out

    gnn._edge_sum = unsummed
    try:
        yield
    finally:
        gnn._edge_sum = edge_sum


def gnn_tp_rank(mesh, seed: int, device: str, smoke: bool = False) -> dict:
    """A rank of 20d: each of GNN_TP_ARCHS' train cells at GNN_TP_SHAPE
    drawn from the seed, through ``shard_cell``; GAT's control step first
    (:func:`unsummed_denominators` on rank 1), the state put back; then
    GNN_TP_STEPS steps under ``use_axis_env``, K4's counter set to 0 before
    each (these models launch no hand kernel), the first one's
    collectives counted by ``LocalCost``; the peak memory a cell."""
    import torch

    from repro_torch import pytree
    from repro_torch.dist.sharding import AxisEnv, LocalCost, local, use_axis_env
    from repro_torch.kernels.gather_segsum import ops as k4_ops
    from repro_torch.launch.cells import build_cell, shard_cell

    cuda = DEVICE == "cuda"
    env = AxisEnv(mesh)
    out = {}
    for arch in GNN_TP_ARCHS:
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cell = shard_cell(build_cell(arch, GNN_TP_SHAPE, concrete=True, seed=seed, smoke=smoke,
                                     device=DEVICE), env)
        row = {"build_s": time.perf_counter() - t0, "steps": []}
        if arch == "gat-cora":
            state = cell.args[0]
            leaves = [local(t) for t in pytree.leaves((state.params, state.m, state.v))]
            leaves.append(state.step)
            kept = [t.clone() for t in leaves]
            with use_axis_env(env), unsummed_denominators(1):
                row["control"] = gcn_metrics(*cell.fn(*cell.args))
            for t, k in zip(leaves, kept):
                t.copy_(k)
        for i in range(GNN_TP_STEPS):
            k4_ops.launches = 0
            sync()
            t1 = time.perf_counter()
            with use_axis_env(env), LocalCost() if i == 0 else contextlib.nullcontext() as cost:
                state, m = cell.fn(*cell.args)
            sync()
            step = gcn_metrics(state, m, step_s=time.perf_counter() - t1,
                               k4_launches=k4_ops.launches)
            if i == 0:
                step["cost"] = {"bytes": cost.collectives, "calls": cost.calls}
            row["steps"].append(step)
        row["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
        out[arch] = row
        del cell, state
    return out


def gnn_tp_world4(want: dict, pred: dict, ranks: list) -> dict:
    """20d: the four ``gloo`` ranks' GAT, MeshGraphNet and DimeNet train
    steps at GNN_TP_SHAPE (:func:`gnn_tp_rank`) on (data 2, model 2)
    against the unsharded steps on the same seed and batch (``want``: by
    architecture, :func:`gnn_tp_unsharded`): each step within
    :func:`gcn_step_errs`' rules at GNN_TP_RTOL and GNN_TP_ODD on every
    rank (the largest share of a leaf's elements off the rule logged a
    step, beside the unsharded runs' own), GAT's control off the loss by
    GNN_TP_CONTROL_MARGIN times its tolerance, no hand kernel launched,
    each rank's collectives in step 1 the dry run's (``pred``: by
    architecture, :func:`gcn_predicted`; gloo's gathers are all-to-alls
    on the card)."""
    def odd_share(errs: dict, params: dict) -> float:
        return max(errs[f"odd {k}"] / v.numel() for k, v in params.items())

    out = {}
    for arch in GNN_TP_ARCHS:
        rtol, w = GNN_TP_RTOL[arch], want[arch]["steps"]
        p = dict(pred[arch]["collectives"])
        if DEVICE == "cuda":
            p["all-to-all"] += p.pop("all-gather")
            p["all-gather"] = 0
        res = {"errs": [], "unsharded_step_s": [s["step_s"] for s in w],
               "unsharded_spread": [{k: e[k] for k in ("loss", "grad_norm")}
                                    for e in want[arch]["spread"]],
               "odd_share": [0.0] * len(w), "unsharded_odd_share": [
                   odd_share(e, u["params"]) for e, u in zip(want[arch]["spread"], w)]}
        for r, got in enumerate(r[arch] for r in ranks):
            for i, (g, u) in enumerate(zip(got["steps"], w)):
                ok, errs = gcn_step_errs(g, u, rtol, GNN_TP_ODD[arch])
                check(ok, f"20d {arch} rank {r} step {i + 1}: {errs!r} (rtol {rtol}, odd "
                          f"share {GNN_TP_ODD[arch]})")
                check(g["k4_launches"] == 0,
                      f"20d {arch} rank {r} step {i + 1}: K4 launched {g['k4_launches']} times")
                res["errs"].append(errs)
                res["odd_share"][i] = max(res["odd_share"][i], odd_share(errs, u["params"]))
            c = got["steps"][0]["cost"]["bytes"]
            check(c == p, f"20d {arch} rank {r}: collectives {c!r}, the dry run's {p!r}")
            if "control" in got:
                _, errs = gcn_step_errs(got["control"], w[0], rtol)
                res.setdefault("control_errs", []).append(
                    {k: errs[k] for k in ("loss", "grad_norm")})
                check(errs["loss"] >= GNN_TP_CONTROL_MARGIN * rtol,
                      f"20d {arch} rank {r}: the unsummed-denominators control misses the loss "
                      f"by {errs['loss']!r}, under {GNN_TP_CONTROL_MARGIN} x {rtol}")
        res.update(collectives=ranks[0][arch]["steps"][0]["cost"], predicted={
            "bytes": p, "calls": pred[arch]["collective_calls"]},
            step_s=[[s["step_s"] for s in r[arch]["steps"]] for r in ranks],
            peak_gb=[r[arch]["peak_gb"] for r in ranks],
            build_s=[r[arch]["build_s"] for r in ranks], loss=[s["loss"] for s in w],
            max_rel_err=max(max(e["loss"], e["grad_norm"]) for e in res["errs"]))
        out[arch] = res
        log(f"20d {arch} {GNN_TP_SHAPE} world 4 (gloo, one card, data 2 x model 2) through "
            f"shard_cell, {GNN_TP_STEPS} steps: loss and grad_norm within "
            f"{res['max_rel_err']!r} of the unsharded steps (rtol {rtol}), the parameters at "
            f"16c's rule (odd share {GNN_TP_ODD[arch]}), no hand kernel, collectives the dry "
            f"run's; "
            + " ".join(f"{k}={res[k]!r}" for k in ("collectives", "step_s", "unsharded_step_s",
                                                    "peak_gb", "build_s", "odd_share",
                                                    "unsharded_odd_share", "unsharded_spread")
                       + (("control_errs",) if "control_errs" in res else ())))
    return out


def sharded_cells_ranks(seed: int, smoke: bool) -> RanksAhead:
    """20b's, 20c's and 20d's four ranks, started ahead."""
    return RanksAhead(sharded_cells_rank, math.prod(CELLS_TP_MESH.values()), backend="gloo",
                      device=DEVICE, args=(seed, DEVICE, grab_config(), smoke),
                      timeout=SHARDED_CELLS_TIMEOUT, mesh_shape=CELLS_TP_MESH)


def phase_sharded_cells(bits: dict, seed: int, smoke: bool = False,
                        ahead: RanksAhead | None = None) -> dict:
    """Phase 20, run last: 20a the Spade cells on one ``nccl`` rank, 20b on
    four ``gloo`` ranks, both held to 16c's bits (``bits``, kept on the
    host); 20c gcn-cora's train step and 20d GAT's, MeshGraphNet's and
    DimeNet's on the same four ``gloo`` ranks against their unsharded
    steps.  Launches of K1, K2, ``suffix_init`` and K4 here are off the
    main path; 20d launches no hand kernel.  The ranks are ``ahead``'s
    (:func:`sharded_cells_ranks`), or started here.  ``smoke``: the smoke
    configs, for a rehearsal on the CPU."""
    import torch

    t0 = time.perf_counter()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    ahead = ahead or sharded_cells_ranks(seed, smoke)
    out = {"world1": spade_world1(bits, seed, smoke)}

    def references():  # 20c's and 20d's, here while the ranks do 20b
        with torch.enable_grad():
            want, want_d = gcn_unsharded(seed, smoke), gnn_tp_unsharded(seed, smoke)
        return want, gcn_predicted(CELLS_TP_MESH, smoke), want_d, {
            a: gcn_predicted(CELLS_TP_MESH, smoke, a, GNN_TP_SHAPE) for a in GNN_TP_ARCHS}

    t1 = time.perf_counter()
    ahead.go()
    refs = beside(references)
    ranks = ahead.join()
    want, pred, want_d, pred_d = refs()
    out["spawn_s"] = time.perf_counter() - t1
    out["world4"] = spade_sharded_world4(bits, [r["spade"] for r in ranks])
    out["gcn"] = gcn_sharded_world4(want, pred, [r["gcn"] for r in ranks])
    out["gnn"] = gnn_tp_world4(want_d, pred_d, [r["gnn"] for r in ranks])
    out["launches"] = {
        k: sum(r["launches"][k] for r in out["world1"].values())
        + sum(sum(x[k] for x in r["launches"]) for r in out["world4"].values()
              if isinstance(r, dict) and "launches" in r)
        for k in ("peel_round", "frontier_spmv", "suffix_init")}
    out["launches"]["gather_segsum"] = out["gcn"]["k4_launches"]
    out["launches_20d"] = sum(s["k4_launches"] for r in ranks for a in GNN_TP_ARCHS
                              for s in r["gnn"][a]["steps"])
    out["seconds"] = time.perf_counter() - t0
    log(f"20: {out['seconds']!r} s (20b, 20c and 20d's ranks after the gate "
        f"{out['spawn_s']!r} s); launches off the main path {out['launches']!r}; 20d: "
        f"{out['launches_20d']!r} hand-kernel launches (GAT, MeshGraphNet and DimeNet "
        f"aggregate in plain PyTorch)")
    return out


def sharded_cells_rank(mesh, seed: int, device: str, cfg: dict, smoke: bool = False) -> dict:
    """A rank of 20b, 20c and 20d, one spawn: :func:`spade_cells_rank`,
    then :func:`gcn_sharded_rank` and :func:`gnn_tp_rank` with gradients
    on."""
    import torch

    out = {"spade": spade_cells_rank(mesh, seed, device, cfg, smoke)}
    with torch.enable_grad():
        out["gcn"] = gcn_sharded_rank(mesh, seed, device, smoke)
        out["gnn"] = gnn_tp_rank(mesh, seed, device, smoke)
    return out


# ---------------------------------------------------------------------------
# phase 21: the MoE LM train step sharded on a DeviceMesh with FSDP
# ---------------------------------------------------------------------------

# 21a and 21b train olmoe-1b-7b at its published widths cut to
# MOE_FSDP_LAYERS of its 16 layers, the most at which the unsharded step
# and 21b's four ranks on the one card each peak under MOE_FSDP_MEM_GB, on
# MOE_FSDP_BATCH x 4,096 tokens; 21c trains mixtral-8x7b cut to
# MIXTRAL_FSDP_LAYERS of its 32 (its 16 virtual experts split 8 a rank
# over model 2).  21b and 21c share one spawn of four gloo ranks on
# MOE_FSDP_MESH.
MOE_FSDP_ARCH = "olmoe-1b-7b"
MOE_FSDP_LAYERS = 10
MOE_FSDP_STEPS = 2
MOE_FSDP_BATCH = 2
MOE_FSDP_MESH = {"data": 2, "model": 2}
MIXTRAL_FSDP_LAYERS = 2
MIXTRAL_FSDP_STEPS = 1
MOE_FSDP_TIMEOUT = 600  # seconds for 21b's and 21c's spawn
MOE_FSDP_DRAWS = 2  # ranks that draw their whole model at once
MOE_FSDP_MEM_GB = 0.9 * 80  # the unsharded step's peak; the four ranks' peaks together
# 21b's and 21c's tolerances against the unsharded steps, set from the H100
# runs at 4, 8 and 10 layers (PERF.md).  A rank's bf16 products over
# its own rows round apart from one device's and move tokens to other
# experts (ROADMAP C.12; 12-14 % of olmoe's token-layers in step 1, 1 % of
# mixtral's).  Step 1 runs on the same weights: loss, aux and grad_norm
# moved by at most 4.1e-5, 3.4e-4 and 1.5e-3 relative, the per-token NLL by
# 0.0287 nats on average.  A later step runs on weights that Adam moved by
# lr * sign(g) wherever a gradient near 0 changed its sign (two unsharded
# runs differ there too: 3.7e-3 in a metric, 0.28 of a leaf's elements):
# step 2's loss, aux and grad_norm moved by at most 2.0e-3, 2.9e-2 and
# 4.1e-2; after olmoe's two steps at most 0.73 of a leaf's elements (its
# routers) lie beyond FSDP_ULPS ulps and 1 % of a step (ulp_errs), after
# mixtral's one 0.093.  The swapped-shard control moved the per-token NLL
# by 0.283 (olmoe, 5.7x MOE_FSDP_NLL_TOL) and 0.98 nats (mixtral)
MOE_FSDP_STEP1_RTOL = {"loss": 1e-4, "aux": 1e-3, "grad_norm": 5e-3}
MOE_FSDP_LATER_RTOL = {"loss": 5e-3, "aux": 6e-2, "grad_norm": 1e-1}
MOE_FSDP_ODD = {"olmoe-1b-7b": 0.85, "mixtral-8x7b": 0.15}
MOE_FSDP_NLL_TOL = 0.05
# 21a where the unsharded step does not repeat its bits (its gathers'
# backward adds with float atomics): its distances from the first unsharded
# run within these multiples of the second run's (the largest relative
# error of loss, aux and grad_norm over the steps, taken as at least
# MOE_FSDP_SPREAD_FLOOR; the largest share of a leaf's elements beyond
# FSDP_ULPS ulps and 1 % of a step), the forward of step 1 (its loss and
# aux) bit for bit.  One reading of the metrics' spread is noisy: over six
# H100 runs at 10 layers it ranged from 5.8e-4 to 5.5e-3, 21a's distance
# from 2.3e-3 to 4.7e-3; the leaves' spread 0.250-0.277, 21a's 0.252-0.276
MOE_FSDP_SPREAD = {"metrics": 10, "leaves": 2}
MOE_FSDP_SPREAD_FLOOR = 1e-3


def moe_fsdp_cfg(arch: str, smoke: bool):
    """Phase 21's config of ``arch``: cut to its depth (the smoke config's
    own two layers when ``smoke``)."""
    n = {MOE_FSDP_ARCH: MOE_FSDP_LAYERS, MIXTRAL_TP_ARCH: MIXTRAL_FSDP_LAYERS}[arch]
    return moe_tp_cfg(arch, None if smoke else n, smoke)


def moe_fsdp_state(arch: str, cfg, seed: int, env=None, partner: bool = False):
    """``cfg``'s seeded weights drawn whole on DEVICE and their train state;
    on ``env``'s mesh through ``shard_cell`` (``arch``'s train cell's
    logical axes: experts on ``expert``, their ``D`` on ``fsdp``, virtual
    experts unfolded), the module sharded before ``m`` and ``v`` are made.
    Returns the state and, with ``partner``, the partner's expert shards
    (:func:`partner_expert_shards`), else None."""
    from repro_torch.launch.cells import build_cell, shard_cell
    from repro_torch.train import TrainState, init_train_state

    model = moe_tp_model(cfg, seed)
    shards = partner_expert_shards(model, env, fsdp=True) if partner else None
    if env is None:
        return init_train_state(model), shards
    cell = build_cell(arch, "train_4k", override_layers=cfg.n_layers)
    bare = TrainState(params=model, m=None, v=None, step=None)
    cell = shard_cell(dataclasses.replace(cell, args=(bare, None), fn=None), env)
    del model
    return init_train_state(cell.args[0].params), shards


def partner_expert_shards(model, env, fsdp: bool) -> list[dict]:
    """On the host, the expert shards that ``shard_cell`` gives this rank's
    partner on the ``model`` dim (two ranks; the same coordinate on the
    other dims) in the serving layout or, with ``fsdp``, the train cells'
    FSDP layout, unfolded where the config splits its experts: what the
    swapped-shard control loads in place of this rank's own."""
    from torch.distributed.tensor import Shard

    from repro_torch.convert import unfold_experts
    from repro_torch.launch.cells import lm_param_logical

    mesh = env.mesh
    coord = list(mesh.get_coordinate())
    i = mesh.mesh_dim_names.index("model")
    check(mesh.size(i) == 2, f"the swapped-shard control pairs two model ranks, not "
          f"{mesh.size(i)}")
    coord[i] = 1 - coord[i]
    names = lm_param_logical(model.cfg, fsdp=fsdp)["layers"]["moe"]
    vs = model.cfg.moe.virtual_split
    out = []
    for lp in model.layers:
        shards = {}
        for name in ("w_gate", "w_up", "w_down"):
            w = getattr(lp, name).detach()
            w = unfold_experts(name, w, vs) if vs > 1 else w
            for d, pl in enumerate(env.placements(*names[name][1:], shape=tuple(w.shape))):
                if isinstance(pl, Shard):
                    w = w.chunk(mesh.size(d), dim=pl.dim)[coord[d]]
            shards[name] = w.to("cpu", copy=True)
        out.append(shards)
    return out


def swapped_loss(state, partner: list, batch: dict, env) -> dict:
    """The swapped-shard control: this rank's expert shards replaced by its
    partner's, the batch's loss and aux (the forward alone, no gradient),
    then its own shards put back."""
    import torch

    from repro_torch.dist.sharding import local, shard_tree, use_axis_env
    from repro_torch.models import lm_loss

    layers = state.params.layers

    def load(shards_of):
        for lp, shards in zip(layers, shards_of):
            for n, t in shards.items():
                getattr(lp, n).to_local().copy_(t)

    with torch.no_grad():
        own = [{n: getattr(lp, n).to_local().to("cpu", copy=True) for n in shards}
               for lp, shards in zip(layers, partner)]
        load(partner)
        rec, nll = [], []
        with use_axis_env(env), routing_recorded(rec), nll_recorded(nll):
            b = shard_tree(batch, FSDP_BATCH_LOGICAL)
            loss, m = lm_loss(state.params, b["tokens"], b["labels"])
            out = {"loss": float(local(loss)), "aux": float(local(m["aux"])),
                   "routing": [host_routing(r) for r in rec], "nll": nll[0]}
        load(own)
    return out


def moe_fsdp_rank(mesh, paths: dict, seed: int, device: str, smoke: bool) -> dict:
    """A rank of 21b and then 21c (one spawn): for each MoE LM, the seeded
    model drawn whole MOE_FSDP_DRAWS ranks at a time behind a barrier and
    sharded by ``shard_cell`` (:func:`moe_fsdp_state`), the swapped-shard
    control's loss, then its steps on the batch read from ``paths[arch]``
    (step 1's collectives counted, the routing recorded), the updated
    parameter shards on the host."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist.sharding import AxisEnv

    global DEVICE
    DEVICE = device
    torch.set_grad_enabled(False)
    cuda = DEVICE == "cuda"
    if not cuda:
        torch.set_num_threads(1)  # the ranks share the host's cores
    env = AxisEnv(mesh)
    rank = dist.get_rank()
    out = {}
    for arch, steps in ((MOE_FSDP_ARCH, MOE_FSDP_STEPS), (MIXTRAL_TP_ARCH, MIXTRAL_FSDP_STEPS)):
        cfg = moe_fsdp_cfg(arch, smoke)
        with np.load(paths[arch]) as z:
            batch = {k: torch.from_numpy(z[k]).to(DEVICE) for k in ("tokens", "labels")}
        t0 = time.perf_counter()
        for r in range(0, dist.get_world_size(), MOE_FSDP_DRAWS):
            if r <= rank < r + MOE_FSDP_DRAWS:
                state, partner = moe_fsdp_state(arch, cfg, seed, env, partner=True)
                if cuda:
                    torch.cuda.empty_cache()
            dist.barrier()
        draw_s = time.perf_counter() - t0
        control = swapped_loss(state, partner, batch, env)
        del partner
        if rank == 0:
            log(f"21 rank 0: {arch} drawn in {draw_s!r} s, the control's forward run")
        routing, nll = [], []
        got, state = fsdp_train(state, batch, steps, env, cost_step=0, routing=routing, nll=nll)
        got["nll"] = nll
        if rank == 0:
            log(f"21 rank 0: {arch} trained, steps {got['step_s']!r} s")
        got.update(draw_s=draw_s, control=control, routing=routing, shards=fsdp_shards(state))
        del state
        if cuda:
            torch.cuda.empty_cache()
        out[arch] = got
    return out


def moe_fsdp_plain(arch: str, cfg, batch: dict, seed: int, steps: int, keep: bool
                   ) -> dict:
    """``arch``'s unsharded steps on the card from the seeded weights, each
    step's metrics and digests, the routing of each step's forward; with
    ``keep``, the updated parameters on the host, in the sharded layout
    (virtual experts unfolded)."""
    import torch

    from repro_torch.convert import unfold_experts

    routing, nll = [], []
    got, state = fsdp_train(moe_fsdp_state(arch, cfg, seed)[0], batch, steps, digests=True,
                            routing=routing, nll=nll)
    got.update(routing=routing, nll=nll)
    if keep:
        vs = cfg.moe.virtual_split
        got["want"] = {}
        for n, p in state.params.named_parameters():
            leaf = n.rpartition(".")[2]
            if vs > 1 and leaf in ("w_gate", "w_up", "w_down"):
                p = unfold_experts(leaf, p.detach(), vs)
            got["want"][n] = p.detach().to("cpu", copy=True)
    else:
        got["state"] = state
    del state
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return got


def leaf_distances(params, want: dict) -> dict:
    """:func:`ulp_errs` of each parameter of ``params`` (a module on the
    card, plain or a one-rank mesh's) against ``want`` (on the host),
    a leaf at a time on the card."""
    from repro_torch.dist.sharding import local

    out = {}
    for n, p in params.named_parameters():
        w = want[n].to(DEVICE)
        out[n] = ulp_errs(local(p).detach(), w, TRAIN_STEP_TOL * TRAIN_LM_ADAM["lr"])
        del w
    return out


def metric_rel(got: list, want: list, keys=("loss", "aux", "grad_norm")) -> float:
    """The largest relative difference of ``keys`` over the steps."""
    return max(abs(g[k] - w[k]) / abs(w[k]) for g, w in zip(got, want, strict=True)
               for k in keys)


def moe_fsdp_world1(runs: list, batch: dict, seed: int, smoke: bool) -> dict:
    """21a: one ``nccl`` rank on a (data 1, model 1) mesh: olmoe's state
    drawn again through ``shard_cell``, the same MOE_FSDP_STEPS steps on
    the same batch.  ``runs`` are the two unsharded runs (the first keeps
    its parameters on the host, the second its state on the card): where
    they repeat their bits, 21a is held to them bit for bit (metrics and
    digests of every parameter, ``m`` and ``v`` leaf after each step);
    else step 1's loss and aux bit for bit and the rest within
    MOE_FSDP_SPREAD times the two runs' distance (metrics each step, their
    distance taken as at least MOE_FSDP_SPREAD_FLOOR; parameters after the
    last)."""
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.dist.sharding import AxisEnv

    one, two = runs
    cfg = moe_fsdp_cfg(MOE_FSDP_ARCH, smoke)
    repeats = one["metrics"] == two["metrics"] and one["digests"] == two["digests"]
    spread = {"metrics": max(metric_rel(two["metrics"], one["metrics"]),
                             MOE_FSDP_SPREAD_FLOOR),
              "leaves": max(e[0] for e in leaf_distances(two.pop("state").params,
                                                         one["want"]).values())}
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ROOT / "build")
    dist.init_process_group("nccl" if DEVICE == "cuda" else "gloo",
                            store=dist.FileStore(f"{tmp}/store", 1), rank=0, world_size=1)
    try:
        env = AxisEnv(DeviceMesh(DEVICE, [[0]], mesh_dim_names=("data", "model")))
        state, _ = moe_fsdp_state(MOE_FSDP_ARCH, cfg, seed, env)
        got, state = fsdp_train(state, batch, MOE_FSDP_STEPS, env, cost_step=0, digests=True)
        dist_leaves = leaf_distances(state.params, one["want"])
        del state
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    got_spread = {"metrics": metric_rel(got["metrics"], one["metrics"]),
                  "leaves": max(e[0] for e in dist_leaves.values())}
    first = {k: got["metrics"][0][k] for k in ("loss", "aux")}
    check(first == {k: one["metrics"][0][k] for k in ("loss", "aux")},
          f"21a: step 1's loss and aux {first!r} differ from the unsharded step's "
          f"{one['metrics'][0]!r}")
    if repeats:
        check(got["metrics"] == one["metrics"], f"21a: metrics {got['metrics']!r}, the "
              f"unsharded {one['metrics']!r}")
        differ = [(i, k) for i, (g, w) in enumerate(zip(got["digests"], one["digests"]))
                  for k in w if g.get(k) != w[k]]
        check(not differ, f"21a: {len(differ)} leaves differ from the unsharded steps' bits: "
              f"{differ[:4]!r}")
        rule = "bit for bit (the unsharded step repeats its bits)"
    else:
        for key, factor in MOE_FSDP_SPREAD.items():
            check(got_spread[key] <= factor * spread[key],
                  f"21a: {key} {got_spread[key]!r} from the first unsharded run, beyond "
                  f"{factor} x the second's {spread[key]!r}")
        rule = (f"within {MOE_FSDP_SPREAD} x the unsharded runs' spread (the unsharded step "
                f"does not repeat its bits)")
    check(not any(got["cost"]["bytes"].values()), f"21a: one rank ran collectives "
          f"{got['cost']['bytes']!r}")
    n = cfg.n_layers
    check(DEVICE != "cuda" or (got["k3_launches"] == 2 * n * MOE_FSDP_STEPS
                               and got["k3_simt_launches"] == 0),
          f"21a: K3 launched {got['k3_launches']} times (SIMT {got['k3_simt_launches']}), "
          f"expected {2 * n * MOE_FSDP_STEPS} on the tensor-core body")
    out = {k: got[k] for k in ("n_layers", "metrics", "step_s", "state_gb", "peak_gb",
                               "k3_launches")}
    out.update(rule=rule, unsharded_repeats=repeats, unsharded_spread=spread,
               distance=got_spread, leaves=len(one["digests"][0]))
    log(f"21a world 1 (nccl, data 1 x model 1), {MOE_FSDP_ARCH} at {n} layers: held {rule}; "
        f"the unsharded runs' distance {spread!r}, 21a's from the first {got_spread!r}; "
        + " ".join(f"{k}={v!r}" for k, v in out.items() if k not in ("rule",)))
    return out


def alike_tokens_nll(plain: dict, routing: list, nll: dict, n: int, K: int) -> dict:
    """One forward's per-token NLL (``nll``: this rank's rows) against the
    unsharded step 1's: the share of this rank's token-layers that
    ``routing`` (the forward's ``n`` MoE calls) sends to other experts than
    the unsharded forward, how many of its tokens are routed alike (the
    same experts, the same kept) in every layer, the largest NLL
    difference over those tokens and over all of them."""
    import torch

    rt = routing_rows(plain["routing"][:n], routing, n, K)
    b0, got = nll["b0"], nll["nll"]
    rows, S = got.shape
    d = (got - plain["nll"][0]["nll"][b0:b0 + rows]).abs().flatten()
    alike = torch.ones_like(d, dtype=torch.bool)
    alike[torch.tensor(sorted(t - b0 * S for t in rt["steps"][0]), dtype=torch.long)] = False
    return {"rerouted": rt["rerouted"] / rt["tokens"], "alike": int(alike.sum()),
            "tokens": d.numel(), "nll_mean": float(d.mean()), "nll_max": float(d.max()),
            "nll_alike_max": float(d[alike].max()) if alike.any() else None}


def moe_fsdp_check(tag: str, arch: str, plain: dict, ranks: list, pred: dict, smoke: bool
                   ) -> dict:
    """21b or 21c on every rank's record, against the unsharded steps
    (``plain``): lr equal; loss, aux and grad_norm within
    MOE_FSDP_STEP1_RTOL in step 1 and MOE_FSDP_LATER_RTOL after it; step
    1's per-token NLL within MOE_FSDP_NLL_TOL (mean absolute difference);
    every updated parameter within FSDP_ULPS ulps (or 1 % of a step) but
    for MOE_FSDP_ODD[arch] of a leaf's elements; the swapped-shard
    control's per-token NLL beyond MOE_TP_CONTROL_FACTOR times
    MOE_FSDP_NLL_TOL; step 1's collectives the dry run's (``pred``); K3 two
    launches a layer a step; the ranks' peaks together under
    MOE_FSDP_MEM_GB.  The share of token-layers routed to other experts
    than the unsharded step's is counted, step by step."""
    cfg = moe_fsdp_cfg(arch, smoke)
    n, K = cfg.n_layers, cfg.moe.top_k
    steps = len(plain["metrics"])
    worst = {k: [0.0] * steps for k in MOE_FSDP_STEP1_RTOL}
    factor = MOE_TP_CONTROL_FACTOR["experts"][arch]
    control, sound, rerouted = [], [], []
    p, calls = gloo_on_card(pred)
    for r, got in enumerate(ranks):
        for i, (g, w) in enumerate(zip(got["metrics"], plain["metrics"], strict=True)):
            check(g["lr"] == w["lr"], f"{tag} rank {r} step {i + 1}: lr {g['lr']!r}, {w['lr']!r}")
            for k, tol in (MOE_FSDP_LATER_RTOL if i else MOE_FSDP_STEP1_RTOL).items():
                rel = abs(g[k] - w[k]) / abs(w[k])
                worst[k][i] = max(worst[k][i], rel)
                check(math.isfinite(g[k]) and rel <= tol,
                      f"{tag} rank {r} step {i + 1} {k}: {g[k]!r} against {w[k]!r} unsharded "
                      f"(relative {rel!r}, beyond {tol})")
        ctrl = got["control"]
        sound.append(alike_tokens_nll(plain, got["routing"][:n], got["nll"][0], n, K))
        control.append(alike_tokens_nll(plain, ctrl.pop("routing"), ctrl.pop("nll"), n, K)
                       | {"loss": ctrl["loss"], "aux": ctrl["aux"]})
        check(sound[-1]["nll_mean"] <= MOE_FSDP_NLL_TOL,
              f"{tag} rank {r}: step 1's per-token NLL off by {sound[-1]['nll_mean']!r} on "
              f"average (tolerance {MOE_FSDP_NLL_TOL})")
        check(control[-1]["nll_mean"] > factor * MOE_FSDP_NLL_TOL,
              f"{tag} rank {r}: the swapped-shard control's per-token NLL off by "
              f"{control[-1]['nll_mean']!r} on average, not {factor} x the tolerance "
              f"{MOE_FSDP_NLL_TOL}")
        per_step = [routing_rows(plain["routing"][i * n:(i + 1) * n],
                                 got["routing"][i * n:(i + 1) * n], n, K) for i in range(steps)]
        rerouted.append([rt["rerouted"] / rt["tokens"] for rt in per_step])
        check(got["cost"]["bytes"] == p, f"{tag} rank {r}: collectives {got['cost']['bytes']!r} "
              f"in step 1, the dry run's {p!r}")
        check(DEVICE != "cuda" or (got["k3_launches"] == 2 * n * steps
                                   and got["k3_simt_launches"] == 0),
              f"{tag} rank {r}: K3 launched {got['k3_launches']} times (SIMT "
              f"{got['k3_simt_launches']}), expected {2 * n * steps}")
    per_leaf = fsdp_leaves(plain["want"], [g.pop("shards") for g in ranks])
    leaf = {"odd_share_max": max(e[0] for e in per_leaf.values()),
            "ulps_max": max(e[1] for e in per_leaf.values()),
            "abs_max": max(e[2] for e in per_leaf.values()),
            "leaf": max(per_leaf, key=lambda k: per_leaf[k][0])}
    for name, (odd, _, dmax) in per_leaf.items():
        check(odd <= MOE_FSDP_ODD[arch], f"{tag} {name}: {odd!r} of its elements beyond "
              f"{FSDP_ULPS} ulps and 1 % of a step (tolerance {MOE_FSDP_ODD[arch]}); largest "
              f"distance {dmax!r}")
    peak = sum(g["peak_gb"] for g in ranks) if DEVICE == "cuda" else None
    check(peak is None or peak <= MOE_FSDP_MEM_GB,
          f"{tag}: the ranks' peaks {peak!r} GB, over {MOE_FSDP_MEM_GB} GB")
    out = {"n_layers": n, "steps": steps, "metrics_rel_err": worst, "leaves": leaf,
           "rerouted_share": rerouted, "sound": sound, "control": control,
           "control_factor": factor, "peak_gb_sum": peak,
           "collectives": {"rank0": ranks[0]["cost"], "predicted": {"bytes": p, "calls": calls}},
           "plain": {k: plain[k] for k in ("metrics", "step_s", "state_gb", "peak_gb")},
           "ranks": [{k: g[k] for k in ("metrics", "step_s", "state_gb", "whole_gb", "peak_gb",
                                        "draw_s", "k3_launches")} for g in ranks]}
    log(f"{tag} world 4 (gloo, {MOE_FSDP_MESH}, one card), {arch} at {n} layers, {steps} "
        f"step(s): loss, aux and grad_norm within {worst!r} relative of the unsharded steps, "
        f"step by step (tolerances {MOE_FSDP_STEP1_RTOL!r}, then {MOE_FSDP_LATER_RTOL!r}); "
        f"parameters {leaf!r} (at most {MOE_FSDP_ODD[arch]} of a leaf beyond {FSDP_ULPS} ulps); "
        f"token-layers routed to other experts than the unsharded step's, a rank a step: "
        f"{rerouted!r}")
    log(f"{tag} step 1's per-token NLL against the unsharded step's, a rank: {sound!r} "
        f"(mean within {MOE_FSDP_NLL_TOL}); the swapped-shard control's: {control!r} (mean "
        f"beyond {factor} x {MOE_FSDP_NLL_TOL})")
    log(f"{tag} state and memory: unsharded {plain['state_gb']!r} GB of state, "
        f"{plain['peak_gb']!r} GB peak, steps {plain['step_s']!r} s; " + "; ".join(
            f"rank {r}: {g['state_gb']!r} GB of state ({g['whole_gb']!r} GB whole), "
            f"{g['peak_gb']!r} GB peak, steps {g['step_s']!r} s, draw {g['draw_s']!r} s"
            for r, g in enumerate(ranks)) + f"; the ranks' peaks together {peak!r} GB")
    log(f"{tag} collectives a rank in step 1: bytes {ranks[0]['cost']['bytes']!r}, calls "
        f"{ranks[0]['cost']['calls']!r}; the dry run's for {MOE_FSDP_MESH} at {n} layers: "
        f"bytes {p!r}, calls {calls!r}")
    return out


def moe_fsdp_paths() -> dict:
    """21b's and 21c's batches, written for the ranks before they go."""
    return {arch: str(ROOT / "build" / "phase21" / f"{arch}.npz")
            for arch in (MOE_FSDP_ARCH, MIXTRAL_TP_ARCH)}


def moe_fsdp_ranks(seed: int, smoke: bool) -> RanksAhead:
    """21b's and 21c's four ranks, started ahead."""
    return RanksAhead(moe_fsdp_rank, math.prod(MOE_FSDP_MESH.values()), backend="gloo",
                      device=DEVICE, args=(moe_fsdp_paths(), seed, DEVICE, smoke),
                      timeout=MOE_FSDP_TIMEOUT, mesh_shape=MOE_FSDP_MESH)


def phase_moe_fsdp(seed: int, smoke: bool = False, ahead: RanksAhead | None = None) -> dict:
    """Phase 21, run last: olmoe-1b-7b's unsharded step twice (does it
    repeat its bits?), 21a on one ``nccl`` rank, mixtral-8x7b's unsharded
    step, then 21b and 21c on four ``gloo`` ranks (one spawn), each held
    to its unsharded steps; the ranks are ``ahead``'s
    (:func:`moe_fsdp_ranks`), or started here.  ``smoke``: the smoke
    configs, for a rehearsal on the CPU."""
    import torch

    t0 = time.perf_counter()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    paths = moe_fsdp_paths()
    ahead = ahead or moe_fsdp_ranks(seed, smoke)  # they start while 21a runs
    B, S = MOE_FSDP_BATCH, (TRAIN_LM_SEQ if not smoke else 64)
    cfgs = {a: moe_fsdp_cfg(a, smoke) for a in (MOE_FSDP_ARCH, MIXTRAL_TP_ARCH)}
    batches = {a: fsdp_batch(c, B, S, seed + 2) for a, c in cfgs.items()}
    runs = [moe_fsdp_plain(MOE_FSDP_ARCH, cfgs[MOE_FSDP_ARCH], batches[MOE_FSDP_ARCH], seed,
                           MOE_FSDP_STEPS, keep=i == 0) for i in range(2)]
    for run in runs:
        check(DEVICE != "cuda" or run["peak_gb"] <= MOE_FSDP_MEM_GB,
              f"21: the unsharded step peaked at {run['peak_gb']!r} GB, over {MOE_FSDP_MEM_GB}")
    out = {"world1": moe_fsdp_world1(runs, batches[MOE_FSDP_ARCH], seed, smoke)}
    plain = {MOE_FSDP_ARCH: runs[0],
             MIXTRAL_TP_ARCH: moe_fsdp_plain(MIXTRAL_TP_ARCH, cfgs[MIXTRAL_TP_ARCH],
                                             batches[MIXTRAL_TP_ARCH], seed,
                                             MIXTRAL_FSDP_STEPS, keep=True)}
    del runs
    for arch, batch in batches.items():
        Path(paths[arch]).parent.mkdir(parents=True, exist_ok=True)
        np.savez(paths[arch], **{k: v.cpu().numpy() for k, v in batch.items()})
    del batches
    # the dry run's predictions are traced on meta while this process only
    # waits for the ranks
    predicted = beside(lambda: {arch: train_predicted(arch, MOE_FSDP_MESH, cfg.n_layers, B, S,
                                                      smoke) for arch, cfg in cfgs.items()})
    t1 = time.perf_counter()
    ranks = ahead.join()
    preds = predicted()
    out["spawn_s"] = time.perf_counter() - t1
    for p in paths.values():
        Path(p).unlink()
    for tag, arch in (("21b", MOE_FSDP_ARCH), ("21c", MIXTRAL_TP_ARCH)):
        out["world4" if tag == "21b" else "world4_mixtral"] = moe_fsdp_check(
            tag, arch, plain[arch], [r[arch] for r in ranks], preds[arch], smoke)
    out["seconds"] = time.perf_counter() - t0
    log(f"21: {out['seconds']!r} s (21b and 21c's ranks after the gate {out['spawn_s']!r} s)")
    return out


# ---------------------------------------------------------------------------
# phase 22: two-tower on 'rows' through shard_cell; a sharded state's checkpoints
# ---------------------------------------------------------------------------

# 22b, 22c and 22d share one spawn of four gloo ranks on TT_TP_MESH: the
# tables on ("rows", None) split four ways, the batch on data
TT_TP_MESH = {"data": 2, "model": 2}
TT_TP_TIMEOUT = 600  # seconds for 22b-22d's spawn
TT_TP_STEPS = 2
# 22c against 16b's unsharded steps on the same weights and batch: the
# ranks add the bags' partial sums, the loss's terms and the gradients'
# partial sums in another order than one card (float32 roundings), so
# loss and grad_norm within these relative distances.  Each leaf after
# step 1 is held by its float64 sum and sum of squares to 16c's rule for a
# parameter summed over the leaf: Adam's first step moves an element by
# about lr times the sign of its gradient, and a last-bit difference flips
# the sign of a gradient near 0, so at most TT_TP_ODD of the elements the
# step moved (all of an MLP leaf's; a table's rows in the batch) may each
# be 2 lr off: the sum within 2 lr K, the sum of squares within K (4 lr
# max|x| + 4 lr^2), K = max(2, TT_TP_ODD x those elements).  The control
# (one rank's user-table rows drawn one block off) must move step 1's loss
# by TT_TP_CONTROL_FACTOR times its tolerance
TT_TP_RTOL = {"loss": 1e-5, "grad_norm": 1e-4}
TT_TP_ODD = 1e-3
TT_TP_CONTROL_FACTOR = 10
TT_TP_SMOKE = {"p99": 8, "bulk": 64, "cand": 512, "train": 16}  # the rehearsal's sizes
TT_TP_CKPT = ROOT / "build" / "phase22" / "ck"


def tt_meta_cell(shape: str, cfg, B: int, fn=None):
    """``shape``'s two-tower cell on meta for ``cfg`` (its vocabularies) at
    batch ``B`` (retrieval: ``B`` candidates), its logical axes those of
    ``build_cell``'s: what ``shard_cell`` and the dry run take."""
    import torch

    from repro_torch.launch.cells import build_cell
    from repro_torch.models.two_tower import RecsysBatch, init_two_tower_params
    from repro_torch.train import init_train_state

    cell = build_cell(TT_ARCH, shape, smoke=cfg.name.endswith("-smoke"))
    meta = torch.device("meta")
    params = init_two_tower_params(cfg, device=meta, init=False)
    e = lambda *shape, dt=torch.float32: torch.empty(shape, dtype=dt, device=meta)
    if shape == "retrieval_cand":
        F, M = cfg.n_user_fields, cfg.multi_hot
        args = (params, e(1, F, M, dt=torch.int32), e(1, F, M), e(B, cfg.tower_mlp[-1]))
    else:
        Fu, Fi, M = cfg.n_user_fields, cfg.n_item_fields, cfg.multi_hot
        batch = RecsysBatch(e(B, Fu, M, dt=torch.int32), e(B, Fu, M),
                            e(B, Fi, M, dt=torch.int32), e(B, Fi, M), e(B))
        args = (init_train_state(params) if shape == "train_batch" else params, batch)
    return dataclasses.replace(cell, args=args, fn=fn or cell.fn)


def tt_train_cfg(smoke: bool):
    """16b's config: the full widths at a TT_TRAIN_VOCAB_DIV-th of each
    vocabulary (rounded up to 128 rows); the smoke config."""
    from repro_torch.configs import get_config, get_smoke_config

    if smoke:
        return get_smoke_config(TT_ARCH)
    full = get_config(TT_ARCH)
    cut = lambda V: -(-V // TT_TRAIN_VOCAB_DIV // 128) * 128
    return dataclasses.replace(full, user_vocab=cut(full.user_vocab),
                               item_vocab=cut(full.item_vocab))


def tt_step(cfg):
    from repro_torch.models.two_tower import two_tower_loss
    from repro_torch.train import AdamConfig, make_train_step

    return make_train_step(lambda p, b: two_tower_loss(p, b, cfg), AdamConfig(**TT_TRAIN_ADAM))


def tt_sizes(smoke: bool) -> dict:
    from repro_torch.configs import RECSYS_SHAPES

    if smoke:
        return TT_TP_SMOKE
    return {"p99": RECSYS_SHAPES["serve_p99"].batch, "bulk": RECSYS_SHAPES["serve_bulk"].batch,
            "cand": -(-RECSYS_SHAPES["retrieval_cand"].n_candidates // 512) * 512,
            "train": TT_TRAIN_BATCH}


def tt_predicted(mesh_shape: dict, smoke: bool = False) -> dict:
    """The dry run's prediction for 22b's and 22c's mesh: one rank's
    collectives in a call of each serving cell at 16a's traffic and in a
    train step at 16b's cut and batch (``launch.dryrun.sharded_cost``,
    traced on meta under a fake process group of the mesh's ranks)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.dist.sharding import AxisEnv
    from repro_torch.launch.dryrun import sharded_cost

    cfg = get_smoke_config(TT_ARCH) if smoke else get_config(TT_ARCH)
    n = tt_sizes(smoke)
    world = math.prod(mesh_shape.values())
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        env = AxisEnv(DeviceMesh(DEVICE, torch.arange(world).reshape(
            tuple(mesh_shape.values())), mesh_dim_names=tuple(mesh_shape)))
        out = {s: sharded_cost(lambda _: tt_meta_cell(s, cfg, n[k]), env, None)
               for s, k in (("serve_p99", "p99"), ("serve_bulk", "bulk"),
                            ("retrieval_cand", "cand"))}
        cut = tt_train_cfg(smoke)
        out["train_batch"] = sharded_cost(
            lambda _: tt_meta_cell("train_batch", cut, n["train"], fn=tt_step(cut)), env, None)
        return out
    finally:
        dist.destroy_process_group()


def tt_shard_serving(env, cfg, seed: int, smoke: bool):
    """16a's weights (each rank drawing only its table rows) and traffic
    (drawn whole, each rank keeping its part) through ``shard_cell`` on
    ``env``'s mesh: the serve_p99, retrieval_cand and serve_bulk cells."""
    from repro_torch.launch.cells import shard_cell
    from repro_torch.models.two_tower import init_two_tower_params

    params = init_two_tower_params(cfg, device=DEVICE, seed=seed, env=env)
    p99, bulk, _, q, cand = tt_traffic(cfg, seed, DEVICE, tt_sizes(smoke) if smoke else None)
    args = {"serve_p99": (params, p99), "retrieval_cand": (params, q.user_idx, q.user_wt, cand),
            "serve_bulk": (params, bulk)}
    return {k: shard_cell(dataclasses.replace(tt_meta_cell(k, cfg, 0), args=a), env)
            for k, a in args.items()}


def tt_serve(env, cells: dict, timed: bool) -> dict:
    """Each serving cell called once on ``env``'s mesh, its collectives
    counted (``LocalCost``), its output on the host (scores: the rank's
    rows and their span), seconds; with ``timed``, serve_p99 and
    retrieval_cand also over TT_TIMED calls."""
    from repro_torch.dist.sharding import LocalCost, local, shard_span, use_axis_env

    out = {}
    with use_axis_env(env):
        for name, cell in cells.items():
            t0 = time.perf_counter()
            with LocalCost() as cost:
                res = cell.fn(*cell.args)
            sync()
            row = {"counted_call_s": time.perf_counter() - t0,
                   "cost": {"bytes": dict(cost.collectives), "calls": dict(cost.calls)}}
            if name == "retrieval_cand":
                row.update(top_v=res[0].cpu(), top_i=res[1].cpu())
            else:
                row.update(scores=local(res).cpu(), span=shard_span(res, 0))
            if timed and name != "serve_bulk":
                row["ms"] = timed_calls(lambda: cell.fn(*cell.args)) * 1e3
            out[name] = row
            del res
    return out


def tt_world1(ref: dict, seed: int, smoke: bool = False) -> dict:
    """22a: one ``nccl`` rank on (data 1, model 1): 16a's weights and
    traffic through ``shard_cell`` (every table a DTensor whose one shard
    is the whole table), serve_p99, retrieval_cand and one serve_bulk
    call: 16a's bits, no collective."""
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.dist.sharding import AxisEnv

    cfg = get_smoke_config(TT_ARCH) if smoke else get_config(TT_ARCH)
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ROOT / "build")
    dist.init_process_group("nccl" if DEVICE == "cuda" else "gloo",
                            store=dist.FileStore(f"{tmp}/store", 1), rank=0, world_size=1)
    t0 = time.perf_counter()
    try:
        env = AxisEnv(DeviceMesh(DEVICE, [[0]], mesh_dim_names=("data", "model")))
        if DEVICE == "cuda":
            torch.cuda.reset_peak_memory_stats()
        got = tt_serve(env, tt_shard_serving(env, cfg, seed, smoke), timed=False)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    for name in ("serve_p99", "serve_bulk"):
        check(torch.equal(got[name]["scores"], ref[name]), f"22a {name}: not 16a's bits")
    r = got["retrieval_cand"]
    check(torch.equal(r["top_v"], ref["top_v"]) and torch.equal(r["top_i"], ref["top_i"]),
          "22a retrieval_cand: not 16a's top 100")
    for name, row in got.items():
        check(not any(row["cost"]["calls"].values()),
              f"22a {name}: collectives on one rank {row['cost']!r}")
    out = {"seconds": time.perf_counter() - t0,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if DEVICE == "cuda" else None,
           "call_s": {k: v["counted_call_s"] for k, v in got.items()}}
    log(f"22a {TT_ARCH} world 1 ({'nccl' if DEVICE == 'cuda' else 'gloo'}, data 1 x model 1) "
        f"through shard_cell: serve_p99, serve_bulk and retrieval_cand 16a's bits; peak "
        f"{out['peak_gb']!r} GB; {out['seconds']!r} s")
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    return out


def tt_offset_loss(state, batch, cfg, env, seed: int, rank_off: int = 1) -> float:
    """22c's control: step 1's loss with rank ``rank_off``'s ``n``
    user-table rows drawn one block off (``min(TABLE_BLOCK, n)`` rows
    later, or earlier where that runs past the table), the rows drawn
    again after."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist.sharding import shard_span, use_axis_env
    from repro_torch.models.two_tower import TABLE_BLOCK, table_rows, two_tower_loss

    t = state.params["user_table"]
    lo, n = shard_span(t, 0)
    mine = dist.get_rank() == rank_off
    if mine:
        shift = min(TABLE_BLOCK, n)
        start = lo + shift if lo + shift + n <= cfg.user_vocab else lo - shift
        t.to_local().copy_(table_rows(cfg, "user_table", start, n, seed=seed, device=DEVICE))
    with torch.no_grad(), use_axis_env(env):
        loss = float(two_tower_loss(state.params, batch, cfg)[0])
    if mine:
        t.to_local().copy_(table_rows(cfg, "user_table", lo, n, seed=seed, device=DEVICE))
    return loss


def tt_train_rank(env, seed: int, smoke: bool) -> dict:
    """22c on a rank: 16b's cut config (each rank drawing its rows), its
    batch and steps through ``shard_cell``: the control's loss, then
    TT_TP_STEPS steps (step 1's collectives counted), each step's loss,
    grad_norm and seconds, every leaf's local sums after step 1, the
    state's and the peak's GB on the rank."""
    import torch

    from repro_torch.dist.sharding import LocalCost, local, use_axis_env
    from repro_torch.launch.cells import shard_cell
    from repro_torch.models.two_tower import init_two_tower_params
    from repro_torch.train import init_train_state

    cfg = tt_train_cfg(smoke)
    cuda = DEVICE == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    state = init_train_state(init_two_tower_params(cfg, device=DEVICE, seed=seed, env=env))
    batch = recsys_batch(cfg, tt_sizes(smoke)["train"], np.random.default_rng(seed), DEVICE)
    cell = shard_cell(dataclasses.replace(
        tt_meta_cell("train_batch", cfg, 0, fn=tt_step(cfg)), args=(state, batch)), env)
    state, batch = cell.args
    state_gb = 4 * sum(local(x).numel() * local(x).element_size()  # as 16b's: with the grads
                       for x in named_params(state.params).values()) / 1e9
    out = {"control_loss": tt_offset_loss(state, batch, cfg, env, seed), "state_gb": state_gb,
           "metrics": [], "step_s": []}
    with torch.enable_grad(), use_axis_env(env):
        for i in range(TT_TP_STEPS):
            t0 = time.perf_counter()
            with LocalCost() if i == 0 else contextlib.nullcontext() as cost:
                state, m = cell.fn(state, batch)
            sync()
            out["step_s"].append(time.perf_counter() - t0)
            out["metrics"].append({k: float(local(m[k])) for k in ("loss", "grad_norm")})
            if i == 0:
                out["cost"] = {"bytes": dict(cost.collectives), "calls": dict(cost.calls)}
                out["sums"] = leaf_sums(state.params)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    del state, batch, cell
    if cuda:
        torch.cuda.empty_cache()
    return out


def tt_parts(state) -> dict:
    """Each leaf of a state as this rank holds it: ``(region, array)``, a
    DTensor's local shard and its place in the whole leaf, a plain
    tensor whole."""
    from torch.distributed.tensor import DTensor

    from repro_torch.dist.sharding import shard_span

    out = {}
    for k, x in named_params(state).items():
        if isinstance(x, DTensor):
            region = tuple(shard_span(x, d) for d in range(x.dim()))
            out[k] = (region, tuple(x.shape), x.to_local().detach().cpu().clone())
        else:
            out[k] = (None, tuple(x.shape), x.detach().cpu().clone())
    return out


def tt_ckpt_rank(env, mesh) -> dict:
    """22d on a rank: the smoke train cell stepped once on the four ranks,
    saved by a ``CheckpointManager`` (every rank its own shards), the
    state updated in place at once, then restored onto (data 1, model 2)
    (ranks 0 and 1) and onto the rank's device alone (rank 0)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.dist.sharding import AxisEnv, barrier, use_axis_env
    from repro_torch.ft import CheckpointManager, load_pytree
    from repro_torch.launch.cells import build_cell, shard_cell

    rank = dist.get_rank()
    d = str(TT_TP_CKPT)
    if rank == 0:
        shutil.rmtree(d, ignore_errors=True)
    barrier(mesh)
    t0 = time.perf_counter()
    cell = shard_cell(build_cell(TT_ARCH, "train_batch", concrete=True, smoke=True,
                                 device=DEVICE), env)
    with torch.enable_grad(), use_axis_env(env):
        state, _ = cell.fn(*cell.args)
    mgr = CheckpointManager(d, keep=2, every_steps=1)
    mgr.maybe_save(state, 1)
    out = {"saved": tt_parts(state)}
    with torch.no_grad():  # the next step's update, in place, at once
        for x in named_params(state).values():
            (x.to_local() if hasattr(x, "to_local") else x).add_(1)
    mgr.wait()
    mgr.check()
    mgr.close()
    two = DeviceMesh(DEVICE, [[0, 1]], mesh_dim_names=("data", "model"))
    like = build_cell(TT_ARCH, "train_batch", smoke=True)
    if rank < 2:
        out["restored"] = tt_parts(load_pytree(like.args[0], d, env=AxisEnv(two),
                                               logical=like.in_logical[0]))
    if rank == 0:
        out["one"] = tt_parts(load_pytree(like.args[0], d, device=DEVICE))
    barrier(mesh)
    out["seconds"] = time.perf_counter() - t0
    return out


def tt_tp_rank(mesh, seed: int, device: str, smoke: bool = False) -> dict:
    """A rank of 22b, 22c and 22d (one spawn of four gloo ranks)."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.dist.sharding import AxisEnv

    global DEVICE
    DEVICE = device
    torch.set_grad_enabled(False)
    cuda = DEVICE == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False  # float32 products, as 16a's
    else:
        torch.set_num_threads(1)  # the ranks share the host's cores
    env = AxisEnv(mesh)
    rank = dist.get_rank()
    cfg = get_smoke_config(TT_ARCH) if smoke else get_config(TT_ARCH)
    t0 = time.perf_counter()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    cells = tt_shard_serving(env, cfg, seed, smoke)
    sync()
    draw_s = time.perf_counter() - t0
    out = {"serve": tt_serve(env, cells, timed=True)}
    out["serve"].update(draw_s=draw_s,
                        peak_gb=torch.cuda.max_memory_allocated() / 1e9 if cuda else None,
                        table_gb=sum(cells["serve_p99"].args[0][k].to_local().numel() * 4
                                     for k in ("user_table", "item_table")) / 1e9)
    del cells
    if rank == 0:
        log(f"22b rank 0: served, {time.perf_counter() - t0!r} s")
    out["train"] = tt_train_rank(env, seed, smoke)
    if rank == 0:
        log(f"22c rank 0: trained, steps {out['train']['step_s']!r} s")
    out["ckpt"] = tt_ckpt_rank(env, mesh)
    out["launches"] = hand_kernel_launches()
    return out


def tt_tp_ranks(seed: int, smoke: bool) -> RanksAhead:
    """22b's, 22c's and 22d's four ranks, started ahead (they draw their
    own weights and traffic at go)."""
    return RanksAhead(tt_tp_rank, math.prod(TT_TP_MESH.values()), backend="gloo",
                      device=DEVICE, args=(seed, DEVICE, smoke), timeout=TT_TP_TIMEOUT,
                      mesh_shape=TT_TP_MESH)


def tt_rows(ranks: list, name: str, n: int):
    """A serving cell's scores whole from the ranks' rows (each row from
    every rank that holds it: the same bits)."""
    import torch

    out = torch.full((n,), float("nan"))
    for r in ranks:
        lo, k = r["serve"][name]["span"]
        got = r["serve"][name]["scores"]
        prev = out[lo:lo + k]
        check(bool(prev.isnan().all()) or torch.equal(prev, got),
              f"22b {name}: ranks holding rows {lo}-{lo + k} differ")
        out[lo:lo + k] = got
    check(not bool(out.isnan().any()), f"22b {name}: rows no rank holds")
    return out


def tt_top_check(tag: str, v, i, ref: dict, tol: float) -> int:
    """The top 100 against 16a's: scores within ``tol`` of temp position by
    position; the indices 16a's but where two of 16a's scores tie within
    ``tol`` of temp (their order) or at the cut (which of them is in);
    returns the positions that differ."""
    import torch

    v16, i16, temp = ref["top_v"], ref["top_i"], ref["temp"]
    err = float((v.double() - v16.double()).abs().max()) / temp
    check(err <= tol, f"{tag}: top-100 scores {err!r} of temp from 16a's, beyond {tol}")
    gap = (v16[:-1] - v16[1:]).double() / temp
    tied = set()
    for k in torch.nonzero(gap <= tol).flatten().tolist():
        tied |= {k, k + 1}
    diff = torch.nonzero(i != i16).flatten().tolist()
    last = len(v16) - 1
    for k in diff:
        check(k in tied or (k == last and float(abs(v[k] - v16[k])) / temp <= tol),
              f"{tag}: index at position {k} {int(i[k])}, 16a's {int(i16[k])}, no tie")
    missed = set(i16.tolist()) - set(i.tolist())
    check(len(missed) <= 1 and all(i16.tolist().index(x) in tied | {last} for x in missed),
          f"{tag}: 16a's indices {missed!r} missing, not at a tie")
    return len(diff)


def tt_tp_world4(ref: dict, ref_train: dict, pred: dict, ranks: list, seed: int,
                 smoke: bool) -> dict:
    """22b's, 22c's and 22d's checks on the four ranks' results."""
    import torch

    temp = ref["temp"]
    out = {"serve": {}, "train": {}}
    for name in ("serve_p99", "serve_bulk"):
        got = tt_rows(ranks, name, ref[name].shape[0])
        err = tt_close(f"22b {name} vs 16a", got, ref[name], temp)
        out["serve"][name] = {"err_of_temp": err}
    r0 = ranks[0]["serve"]["retrieval_cand"]
    for r in ranks:
        got = r["serve"]["retrieval_cand"]
        check(torch.equal(got["top_v"], r0["top_v"]) and torch.equal(got["top_i"], r0["top_i"]),
              "22b retrieval_cand: the ranks' top 100 differ")
    out["serve"]["retrieval_cand"] = {"positions_differing": tt_top_check(
        "22b retrieval_cand", r0["top_v"], r0["top_i"], ref, TT_TOL)}
    for name in ("serve_p99", "serve_bulk", "retrieval_cand"):
        p, calls = gloo_on_card(pred[name])
        for k, r in enumerate(ranks):
            c = r["serve"][name]["cost"]
            check(c["bytes"] == p and c["calls"] == calls,
                  f"22b {name} rank {k}: collectives {c!r}, the dry run's bytes {p!r} calls "
                  f"{calls!r}")
        row = out["serve"][name]
        row.update(cost=ranks[0]["serve"][name]["cost"], predicted={"bytes": p, "calls": calls},
                   ms=[r["serve"][name].get("ms") for r in ranks],
                   counted_call_s=[r["serve"][name]["counted_call_s"] for r in ranks])
        log(f"22b {name}: within {row.get('err_of_temp', 0.0)!r} of temp of 16a's"
            + (f", {row['positions_differing']} positions of the top 100 at ties"
               if name == "retrieval_cand" else "")
            + f"; ms a call by rank {row['ms']!r}; counted call s {row['counted_call_s']!r}; "
            f"collectives a rank {row['cost']!r} as the dry run's")
    out["serve"].update(peak_gb=[r["serve"]["peak_gb"] for r in ranks],
                        table_gb=[r["serve"]["table_gb"] for r in ranks],
                        draw_s=[r["serve"]["draw_s"] for r in ranks])
    # 22c
    tr = [r["train"] for r in ranks]
    for k, r in enumerate(tr):
        check(r["metrics"] == tr[0]["metrics"], f"22c rank {k}: metrics differ from rank 0's")
    worst = {}
    for i in range(TT_TP_STEPS):
        for key, tol in TT_TP_RTOL.items():
            want = ref_train[{"loss": "losses", "grad_norm": "grad_norms"}[key]][i]
            rel = abs(tr[0]["metrics"][i][key] - want) / abs(want)
            check(rel <= tol, f"22c step {i + 1} {key}: {tr[0]['metrics'][i][key]!r}, 16b's "
                  f"{want!r} ({rel!r} relative, beyond {tol})")
            worst[key] = max(worst.get(key, 0.0), rel)
    control = abs(tr[0]["control_loss"] - ref_train["losses"][0]) / abs(ref_train["losses"][0])
    check(control > TT_TP_CONTROL_FACTOR * TT_TP_RTOL["loss"],
          f"22c control: one rank's rows a block off moved the loss by {control!r} only")
    cfg = tt_train_cfg(smoke)
    batch = recsys_batch(cfg, tt_sizes(smoke)["train"], np.random.default_rng(seed), "cpu")
    moved = {"['user_table']": torch.unique(batch.user_idx).numel() * cfg.embed_dim,
             "['item_table']": torch.unique(batch.item_idx).numel() * cfg.embed_dim}
    lr, sig_err = TT_TRAIN_ADAM["lr"], 0.0
    for leaf, (a1, a2, top, n) in ref_train["after"].items():
        table = leaf.endswith("_table']")
        g1, g2 = ((sum(r["sums"][leaf][j] for r in tr) for j in (0, 1)) if table
                  else tr[0]["sums"][leaf][:2])
        K = max(2.0, TT_TP_ODD * moved.get(leaf, n))
        for got, want, bound in ((g1, a1, 2 * lr * K), (g2, a2, K * (4 * lr * top + 4 * lr * lr))):
            e = abs(got - want) / bound
            sig_err = max(sig_err, e)
            check(e <= 1.0, f"22c {leaf}: sums after step 1 {got!r}, 16b's {want!r}: {e!r} of "
                  f"the bound {bound!r} ({K} elements {2 * lr} off)")
    p, calls = gloo_on_card(pred["train_batch"])
    for k, r in enumerate(tr):
        check(r["cost"]["bytes"] == p and r["cost"]["calls"] == calls,
              f"22c rank {k}: step 1's collectives {r['cost']!r}, the dry run's {p!r} {calls!r}")
    out["train"] = {"metrics": tr[0]["metrics"], "rel_err": worst, "control_rel": control,
                    "sums_err_of_bound": sig_err, "step_s": [r["step_s"] for r in tr],
                    "state_gb": [r["state_gb"] for r in tr],
                    "peak_gb": [r["peak_gb"] for r in tr],
                    "cost": tr[0]["cost"], "predicted": {"bytes": p, "calls": calls}}
    log(f"22c: {TT_TP_STEPS} steps within {worst!r} relative of 16b's, leaf sums within "
        f"{sig_err!r} of their bound, the control off by {control!r}; steps by rank "
        f"{out['train']['step_s']!r} s; state {out['train']['state_gb']!r} GB and peak "
        f"{out['train']['peak_gb']!r} GB a rank; step 1's collectives {tr[0]['cost']!r} as "
        f"the dry run's")
    # 22d
    whole = lambda parts_of: tt_assemble([r["ckpt"][parts_of] for r in ranks
                                          if parts_of in r["ckpt"]])
    saved = whole("saved")
    for what in ("restored", "one"):
        got = whole(what)
        check(got.keys() == saved.keys() and all(torch.equal(got[k], saved[k]) for k in saved),
              f"22d: the state restored ({what}) is not the state saved")
    out["ckpt"] = {"leaves": len(saved), "seconds": [r["ckpt"]["seconds"] for r in ranks]}
    log(f"22d: a CheckpointManager on the four ranks saved the smoke state ({len(saved)} "
        f"leaves, every rank its own shards), restored onto (data 1, model 2) and onto one "
        f"device bit for bit after an in-place update; {out['ckpt']['seconds']!r} s")
    return out


def tt_assemble(ranks: list) -> dict:
    """Whole leaves from the ranks' ``tt_parts``."""
    import torch

    out = {}
    for parts in ranks:
        for k, (region, shape, x) in parts.items():
            if region is None:
                out[k] = x
                continue
            if k not in out:
                out[k] = torch.full(shape, float("nan"), dtype=x.dtype)
            out[k][tuple(slice(a, a + n) for a, n in region)] = x
    return out


def tt_smoke_reference(seed: int) -> tuple[dict, dict]:
    """16a's and 16b's outputs that phase 22 is held to, at the rehearsal's
    smoke config and sizes (the port unsharded on DEVICE)."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.models.two_tower import (init_two_tower_params, retrieval_scores,
                                              score_pairs)
    from repro_torch.train import init_train_state

    cfg = get_smoke_config(TT_ARCH)
    params = init_two_tower_params(cfg, device=DEVICE, seed=seed)
    p99, bulk, _, q, cand = tt_traffic(cfg, seed, DEVICE, TT_TP_SMOKE)
    v, i = retrieval_scores(params, q.user_idx, q.user_wt, cand, cfg, top_k=TT_TOP_K)
    ref = {"serve_p99": score_pairs(params, p99, cfg).cpu(),
           "serve_bulk": score_pairs(params, bulk, cfg).cpu(), "top_v": v.cpu(),
           "top_i": i.cpu(), "temp": float(params["temp"])}
    state = init_train_state(init_two_tower_params(cfg, device=DEVICE, seed=seed))
    batch = recsys_batch(cfg, TT_TP_SMOKE["train"], np.random.default_rng(seed), DEVICE)
    step = tt_step(cfg)
    train = {"losses": [], "grad_norms": [], "before": leaf_sums(state.params)}
    with torch.enable_grad():
        for i in range(TT_TP_STEPS):
            state, m = step(state, batch)
            train["losses"].append(float(m["loss"]))
            train["grad_norms"].append(float(m["grad_norm"]))
            if i == 0:
                train["after"] = leaf_sums(state.params)
    return ref, train


def phase_two_tower_sharded(ref: dict, ref_train: dict, seed: int, smoke: bool = False,
                            ahead: RanksAhead | None = None) -> dict:
    """Phase 22, run last: 22a on one ``nccl`` rank in this process, then
    22b, 22c and 22d on four ``gloo`` ranks (``ahead``'s, started at 21's
    go, or started here), held to 16a's and 16b's outputs (``ref``,
    ``ref_train``); the dry run's predictions traced beside the ranks.
    ``smoke``: the smoke config, for a rehearsal on the CPU."""
    import torch

    t0 = time.perf_counter()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    ahead = ahead or tt_tp_ranks(seed, smoke)
    n0 = hand_kernel_launches()
    out = {"world1": tt_world1(ref, seed, smoke)}
    predicted = beside(tt_predicted, TT_TP_MESH, smoke)
    t1 = time.perf_counter()
    ranks = ahead.join()
    out["spawn_s"] = time.perf_counter() - t1
    out["world4"] = tt_tp_world4(ref, ref_train, predicted(), ranks, seed, smoke)
    n1 = hand_kernel_launches()
    out["launches"] = {k: n1[k] - n0[k] + sum(r["launches"][k] for r in ranks) for k in n0}
    check(not any(out["launches"].values()),
          f"22: a hand kernel launched in phase 22: {out['launches']!r}")
    out["seconds"] = time.perf_counter() - t0
    log(f"22: {out['seconds']!r} s (22b-22d's ranks after the gate {out['spawn_s']!r} s)")
    return out


def gemm_shape_bits(seed: int, T: int = 16_384, D: int = 2048) -> dict:
    """ROADMAP C.12's second diagnostic (``--c12 products``): the share of a
    bf16 product's elements whose bits change when the same rows run in a
    product of another shape, as a sharded rank runs them: ``x @ w`` (an
    olmoe attention projection's shape, T tokens) against the first half
    of its rows alone (data 2), against half its columns alone (a
    column-parallel shard), and against the sum of the two halves of its
    inner dim each rounded to bf16 (a row-parallel product's partial sums,
    and the same formed and added in float32); a float32 router product
    (64 experts) and a batched expert product on half their rows.
    Elements compared by value (no NaN arises)."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.randn((T, D), generator=gen, device=DEVICE).to(torch.bfloat16)
    w = (torch.randn((D, D), generator=gen, device=DEVICE) / D ** 0.5).to(torch.bfloat16)
    full = x @ w
    h = D // 2
    router = torch.randn((D, 64), generator=gen, device=DEVICE) / D ** 0.5
    logits = x.float() @ router
    xb = x.reshape(8, T // 8, D)
    wb = w[None].expand(8, D, D)[:, :, :h].contiguous()
    experts = torch.bmm(xb, wb)
    ways = {"rows_half": (x[:T // 2] @ w, full[:T // 2]),
            "router_f32_rows_half": (x[:T // 2].float() @ router, logits[:T // 2]),
            "experts_bmm_rows_half": (torch.bmm(xb[:, :T // 16], wb), experts[:, :T // 16]),
            "columns_half": (x @ w[:, :h], full[:, :h]),
            "partial_sums_bf16": (x[:, :h] @ w[:h] + x[:, h:] @ w[h:], full),
            "partial_sums_f32": ((x[:, :h].float() @ w[:h].float()
                                  + x[:, h:].float() @ w[h:].float()).to(torch.bfloat16), full)}
    out = {k: float((a != b).float().mean()) for k, (a, b) in ways.items()}
    log(f"C.12 bf16 products of {T} x {D} @ {D} x {D}: share of elements whose bits differ "
        f"from the whole product's: {out!r}")
    return out


@contextlib.contextmanager
def checks_logged(failed: list):
    """Inside, a failed :func:`check` of this process is logged and
    appended to ``failed`` instead of stopping the run: for the
    diagnostics that measure what the smoke run's checks hold."""
    global check

    strict = check

    def logged(cond: bool, msg: str) -> None:
        if not cond:
            failed.append(msg)
            log(f"check failed (logged): {msg}")

    check = logged
    try:
        yield failed
    finally:
        check = strict


def moe_batch_witness(seed: int, smoke: bool = False, prompt: int = LM_PROMPT) -> dict:
    """ROADMAP C.12's single-device witness (``--c12 batch``): 14c's
    olmoe-1b-7b (its seed and depth) on this card alone, no mesh and no
    collective, ``forward`` over 14c's two prompts together (B 2, twice:
    the second a control of the run's own determinism) and over each
    prompt alone (B 1: a data-2 rank's shapes), each alone routed in the
    B 2 run's blocks (its tokens a block and capacity): the tokens routed
    to other experts than the B 2 run's (:func:`routing_rows`), by layer,
    and how many of them are near-ties of the B 2 run's logits.
    ``smoke``: the smoke config, for a rehearsal on the CPU."""
    import torch

    from repro_torch.models import forward, moe

    t0 = time.perf_counter()
    cfg = moe_tp_cfg(MOE_TP_ARCH, None, smoke)
    model = moe_tp_model(cfg, seed)
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (LM_BATCH, prompt))).to(DEVICE)
    B, S = tokens.shape
    blocks = moe._blocks
    _, tp, Cb = blocks(B * S, cfg.moe)

    def routed(x) -> list:
        rec = []
        with routing_recorded(rec):
            forward(model, x)
        sync()
        return [host_routing(r) for r in rec]

    want = routed(tokens)
    out = {"tokens_a_block": tp, "capacity": Cb,
           "b2_again": routing_rows(want, routed(tokens), cfg.n_layers, cfg.moe.top_k)}
    moe._blocks = lambda T, spec: (T // tp, tp, Cb)
    try:
        for b in range(B):
            got = [r | {"t0": b * S, "b0": b * S // tp} for r in routed(tokens[b:b + 1])]
            out[f"prompt{b}_alone"] = routing_rows(want, got, cfg.n_layers, cfg.moe.top_k)
    finally:
        moe._blocks = blocks
    for k, v in out.items():
        if isinstance(v, dict):
            v.pop("steps")
            v["rerouted_share"] = v["rerouted"] / v["tokens"]
            log(f"C.12 witness {k}: " + " ".join(f"{a}={b!r}" for a, b in v.items()))
    out["seconds"] = time.perf_counter() - t0
    return out


def moe_settle_runs(seed: int) -> dict:
    """ROADMAP C.12's diagnostic (``--c12 settle``): 14c's olmoe-1b-7b run
    and 19a, then 19b as the smoke run makes it (bf16 partial sums), on
    (data 2, model 1) (no partial sum) and on (data 1, model 2) with the
    attention's row-parallel partial sums formed and all-reduced in
    float32 (:func:`moe_tp_rank_f32`), and 19b again with them in float32;
    then 19c (mixtral-8x7b at MIXTRAL_TP_LAYERS layers).  Failed checks
    are logged and returned (:func:`checks_logged`); so are each run's
    reroutes, logits errors and controls."""
    t0 = time.perf_counter()
    keys = ("logit_rel_err_max", "alike_rel_err", "rows_alike", "rows", "control_rel_err",
            "control_wo_rel_err", "routing", "loss_rel_err", "aux_rel_err")
    out = {}
    with checks_logged([]) as failed:
        ref = moe_lm_full(MOE_TP_ARCH, seed)["tp_ref"]
        w1 = moe_tp_world1(ref, seed)
        routing = w1.pop("routing")
        out["world1_prefill_s"] = w1["prefill_s"]
        # (data 2, model 1): no partial sum at all, each rank's products
        # over half the tokens; (data 1, model 2) in float32: the partial
        # sums settled in float32, the products over all the tokens, split
        # by columns
        for name, mesh, rank_fn in (("19b_bf16", MOE_TP_MESH, moe_tp_rank),
                                    ("19b_f32", MOE_TP_MESH, moe_tp_rank_f32),
                                    ("data2_model1_bf16", {"data": 2, "model": 1}, moe_tp_rank),
                                    ("data1_model2_f32", {"data": 1, "model": 2},
                                     moe_tp_rank_f32)):
            r = moe_tp_spawn(name, dict(ref, routing=routing), seed, MOE_TP_ARCH,
                             ref["n_layers"], mesh, rank_fn=rank_fn)
            out[name] = {k: r[k] for k in keys if k in r}
        del ref, routing
        mref = mixtral_tp_ref(seed)
        r = moe_tp_spawn("19c", mref, seed, MIXTRAL_TP_ARCH, MIXTRAL_TP_LAYERS, MIXTRAL_TP_MESH)
        out["19c_bf16"] = {k: r[k] for k in keys if k in r}
    for k, v in out.items():
        if isinstance(v, dict) and "routing" in v:
            v["rerouted_share"] = [x["rerouted"] / x["tokens"] for x in v["routing"]]
            log(f"C.12 {k}: " + " ".join(f"{a}={b!r}" for a, b in v.items()))
    out["checks_failed"] = failed
    out["seconds"] = time.perf_counter() - t0
    return out


C12_DIAGNOSTICS = {"products": gemm_shape_bits, "batch": moe_batch_witness,
                   "settle": moe_settle_runs}


def grab4_stream():
    """The Grab4 stream of phases 2-5 and 13: its 6,023,000 vertices and
    27.8M background edges, 90 % of which (with the two standing dense
    blocks, ~25.0M) form the base graph.  Module-level, so that another
    process can draw it."""
    from repro_torch.configs import SPADE_SHAPES
    from repro_torch.graphstore.generators import make_transaction_stream

    return make_transaction_stream(n=SPADE_SHAPES["grab4_stream"].n_nodes, m=27_800_000,
                                   seed=0)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=128,
                    help="Grab4 ticks per engine (>= 32; the first ticks of "
                         "the stream)")
    ap.add_argument("--out", default=None, help="write all results as JSON")
    ap.add_argument("--profile-ticks", type=int, default=8,
                    help="fused Grab4 ticks traced with torch.profiler in "
                         "phase 5 (0 skips it)")
    ap.add_argument("--fsdp-controls", action="store_true",
                    help="run only the controls of phase 18b's rules (fsdp_controls) and "
                         "print them as JSON; no smoke result")
    ap.add_argument("--gnn-remat", action="store_true",
                    help="run only the remat diagnostic of MeshGraphNet and DimeNet "
                         "(gnn_remat) and print it as JSON; no smoke result")
    ap.add_argument("--c12", choices=sorted(C12_DIAGNOSTICS),
                    help="run only one of ROADMAP C.12's diagnostics (products: "
                         "gemm_shape_bits; batch: moe_batch_witness; settle: moe_settle_runs) "
                         "and print it as JSON; no smoke result")
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

    # the Grab4 stream (phases 2-5 and 13) is drawn in another process
    # while phase 1 and phases 6-11 and 15, which do not read it, run
    pool = None
    if not (args.fsdp_controls or args.gnn_remat or args.c12):
        t_draw = time.perf_counter()
        pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
        drawn = pool.submit(grab4_stream)

    # phase 1: build every kernel (one nvcc per source, in parallel)
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    if args.fsdp_controls:
        with torch.enable_grad():
            controls = fsdp_controls(LM_SEED)
        print(smi)
        print(json.dumps(controls))
        return 0
    if args.gnn_remat:
        res = gnn_remat(GNN_SEED)
        print(smi)
        print(json.dumps(res, default=repr))
        return 0
    if args.c12:
        res = C12_DIAGNOSTICS[args.c12](LM_SEED)
        print(smi)
        print(json.dumps(res, default=repr))
        return 0
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

    t_lm = time.perf_counter()
    attn, attn_norm = phase_attention(LM_SEED)
    attn_simt = phase_attention_simt(LM_SEED)
    log("phase 6: K3's two bodies agree with their plain versions")
    lm_parity = phase_lm_parity(LM_SEED)
    log("phase 7: LM cuda==cpu within tolerance, the smoke configs through K3's SIMT body")
    lm, lm_ref = phase_lm_full(LM_SEED)  # phase 17 holds its sharded runs to lm_ref
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
    # graph and rows, which phase 14's memory could not share the card
    # with, and beside the stream's draw, which it does not read
    with torch.enable_grad():
        train = phase_train(LM_SEED, kept)
    t15 = train["qwen3_14b"]
    log(f"phase 15: trained on {smi}: the smoke LMs and GNN kinds cuda == cpu, gcn-cora on "
        f"ogbn-products ({train['gcn_cora']['k4_launches_per_step']!r} K4 launches a "
        f"step), {LM_ARCH} at {t15['n_layers']} layers ({t15['k3_launches_per_step']!r} K3 "
        f"launches a step, {t15['step_s_median_2_3']!r} s a step), a checkpoint round trip "
        f"bit for bit; {train['seconds']!r} s")
    t_wait = time.perf_counter()
    stream = drawn.result()
    pool.shutdown()
    log(f"grab4 stream drawn in another process beside phases 1, 6-11 and 15, ready "
        f"{time.perf_counter() - t_draw!r} s after its start; waited "
        f"{time.perf_counter() - t_wait!r} s for it")

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

    # phase 13 launches K1, K2 and suffix_init off the main path (13a in
    # this process, 13b in spawned ranks; 13c beside 19c): logged apart
    sharded = phase_sharded(stream)
    del stream
    log(f"phase 13 (13a, 13b): the edge-sharded engine on {smi}: world 1 (nccl) and world 2 "
        f"(gloo) held against the single-device engine at Grab4 width; "
        f"{sharded['seconds']!r} s")

    moe = phase_moe(LM_SEED)
    moe_ref = moe[MOE_TP_ARCH].pop("tp_ref")  # phase 19 holds its sharded runs to it
    log(f"phase 14: the MoE LMs at full width through K3 on {smi}: "
        + ", ".join(f"{a} {moe[a]['n_layers']} layers, {moe[a]['k3_launches']} K3 launches "
                    f"a prefill" for a in MOE_LAYERS) + f"; {moe['seconds']!r} s")

    kept.clear()  # phase 16 puts 61.44 GB of tables on the card
    # each sharded phase's gloo ranks start ahead (RanksAhead) while the
    # phase before runs: 17b's here (two CUDA contexts beside phase 16's
    # 68.4 GB peak), 18b's with phase 17, 19b's and 19c's once 18b's ranks
    # go (not beside 18a's 68.8 GB peak), 20's at 19c's go, 21's at 20's
    ahead = {"17b": tp_ranks(LM_SEED, False, TP_LAYERS)}
    cells = phase_cells(LM_SEED)
    spade_bits = {s: r.pop("bits") for s, r in cells["cells"]["spade_full"].items()}
    serve16, train16 = cells["serve"], cells["train"]
    tt_ref, tt_ref_train = serve16.pop("phase22"), train16.pop("phase22")  # held for 22
    log(f"phase 16 on {smi}: {TT_ARCH} served at full width ("
        f"{serve16['table_gb']!r} GB of tables; serve_p99 {serve16['serve_p99']['ms']!r} ms, "
        f"serve_bulk {serve16['serve_bulk']['rows_per_s']!r} rows/s, retrieval_cand "
        f"{serve16['retrieval_cand']['ms']!r} ms) and trained at a "
        f"{TT_TRAIN_VOCAB_DIV}th of its vocabularies ({train16['step_s_median_2_3']!r} s a "
        f"step of {TT_TRAIN_BATCH} rows); {len(cells['cells']['smoke'])} smoke cells cuda == "
        f"cpu, the Spade cells at full width, the launcher's resume bit for bit; "
        f"{cells['seconds']!r} s")

    # phase 12 runs beside phase 17, whose two ranks leave the card's
    # memory and most of the host's cores free, in processes of its own:
    # its launches of K1, K2 and suffix_init are off the main path, counted
    # apart from the main-path counts of the kernels line
    t_cross = time.perf_counter()
    cross_done = beside(phase_cross_plane, smi)
    ahead["18b"] = fsdp_ranks(LM_SEED, False)
    tp = phase_tensor_parallel(lm_ref, LM_SEED, ahead.pop("17b"))
    del lm_ref
    t_joined = time.perf_counter()
    cross = cross_done()
    check(all(cross["launches"].values()),
          f"phase 12: a kernel never launched: {cross['launches']!r}")
    log(f"phase 12 (beside phase 17): host plane == device plane tick by tick, exact_peel == "
        f"static_peel; {time.perf_counter() - t_cross!r} s on {smi} from its start, of which "
        f"{time.perf_counter() - t_joined!r} s after phase 17's end; launches off the main path "
        f"{cross['launches']!r}")
    log(f"phase 17: qwen3-14b sharded on a DeviceMesh on {smi}: world 1 (nccl) phase 8's "
        f"bits, world 2 (gloo, one card) at {tp['world2']['n_layers']} layers within "
        f"{tp['world2']['logit_rel_err_max']!r} of the unsharded run's row scale, K3 with "
        f"q_offset equal to its whole-sequence rows; {tp['seconds']!r} s")

    # phase 18 runs last, after 17: its ranks and sharded steps precede no
    # other phase's timing
    with torch.enable_grad():
        ahead["18b"].on_go.append(lambda: ahead.update({
            "19b": moe_tp_ranks("19b", LM_SEED, MOE_TP_ARCH, moe_ref["n_layers"], MOE_TP_MESH,
                                False),
            "19c": moe_tp_ranks("19c", LM_SEED, MIXTRAL_TP_ARCH, MIXTRAL_TP_LAYERS,
                                MIXTRAL_TP_MESH, False)}))
        fsdp = phase_fsdp(train["qwen3_14b"].pop("step1"), LM_SEED, ahead.pop("18b"))
    w2 = fsdp["world2"]
    log(f"phase 18: qwen3-14b trained with FSDP on a DeviceMesh on {smi}: world 1 (nccl) "
        f"15c's step 1 bit for bit at {fsdp['world1']['n_layers']} layers, world 2 (gloo, one "
        f"card, data 2) at {w2['n_layers']} layers within {w2['metrics_rel_err']!r} of the "
        f"unsharded steps, state {w2['ranks'][0]['state_gb']!r} GB a rank against "
        f"{w2['plain']['state_gb']!r} GB, collectives equal to the dry run's; K3's Function "
        f"under local_map with heads sharded within its tolerance; {fsdp['seconds']!r} s")

    # phase 19 runs last, after 18: its ranks precede no other phase's timing
    # 13c (four gloo ranks on cuda and the same four on cpu, a small
    # stream) runs beside 19c's two ranks
    ahead["19c"].on_go.append(lambda: ahead.update({"20": sharded_cells_ranks(CELL_SEED, False)}))
    moe_tp = phase_moe_tp(moe_ref, LM_SEED, beside_19c=phase_sharded_small,
                          ahead_b=ahead.pop("19b"), ahead_c=ahead.pop("19c"))
    del moe_ref
    sharded["small_world4"] = moe_tp.pop("beside_19c")
    log(f"phase 13c (beside 19c; 19c then waited {moe_tp['beside_19c_wait_s']!r} s for it): "
        f"world 4 (gloo) cuda == cpu; {sharded['small_world4']['seconds']!r} s")
    w4, wm = moe_tp["world4"], moe_tp["world2_mixtral"]
    log(f"phase 19: the MoE LMs sharded on a DeviceMesh on {smi}: {MOE_TP_ARCH} world 1 "
        f"(nccl) 14c's bits, world 4 (gloo, one card, data 2 x model 2) within "
        f"{w4['logit_rel_err_max']!r} of the row scale, collectives equal to the dry run's; "
        f"{MIXTRAL_TP_ARCH} at {wm['n_layers']} layers on world 2 (model 2) within "
        f"{wm['logit_rel_err_max']!r}; the swapped-shard controls rejected; "
        f"{moe_tp['seconds']!r} s")

    # phase 20 runs last, after 19: its ranks precede no other phase's timing;
    # 21's ranks start at 20's go, 22's at 21's (until 22's gate opens they
    # hold a CUDA context each and no table: 21's ranks hold the card)
    def start_21():
        ahead["21"] = moe_fsdp_ranks(LM_SEED, False)
        ahead["21"].on_go.append(lambda: ahead.update({"22": tt_tp_ranks(LM_SEED, False)}))

    ahead["20"].on_go.append(start_21)
    tp_cells = phase_sharded_cells(spade_bits, CELL_SEED, ahead=ahead.pop("20"))
    w4s, gcn20 = tp_cells["world4"], tp_cells["gcn"]
    log(f"phase 20: the Spade cells and gcn-cora's train step through shard_cell on {smi}: "
        f"world 1 (nccl) 16c's bits, world 4 (gloo, one card, data 2 x model 2) 16c's bits "
        f"but best_g (static {w4s['grab4_static']['best_g_diff']!r}, stream "
        f"{w4s['grab4_stream']['best_g_diff']!r} off, bounds "
        f"{w4s['grab4_static']['best_g_bound']!r} and {w4s['grab4_stream']['best_g_bound']!r}),"
        f" {w4s['grab4_static']['all_reduces']!r} all-reduces of "
        f"{w4s['grab4_static']['reduced_bytes']!r} B a step as the dry run's; gcn-cora on "
        f"{GCN_TP_SHAPE} within {gcn20['max_rel_err']!r} of the unsharded steps, its "
        f"collectives the dry run's, peak {gcn20['peak_gb']!r} GB a rank; "
        f"{tp_cells['seconds']!r} s")

    # phase 21 runs last, after 20: its ranks precede no other phase's timing
    moe_fsdp = phase_moe_fsdp(LM_SEED, ahead=ahead.pop("21"))
    w4o, w4x = moe_fsdp["world4"], moe_fsdp["world4_mixtral"]
    log(f"phase 21: the MoE LMs trained with FSDP on a DeviceMesh on {smi}: {MOE_FSDP_ARCH} "
        f"world 1 (nccl) at {moe_fsdp['world1']['n_layers']} layers held "
        f"{moe_fsdp['world1']['rule']}; world 4 (gloo, one card, data 2 x model 2) within "
        f"{w4o['metrics_rel_err']!r} of the unsharded steps, {w4o['rerouted_share']!r} of its "
        f"token-layers rerouted; {MIXTRAL_TP_ARCH} at {w4x['n_layers']} layers within "
        f"{w4x['metrics_rel_err']!r}; collectives equal to the dry run's, the swapped-shard "
        f"controls rejected; {moe_fsdp['seconds']!r} s")

    # phase 22 runs last, after 21: its ranks precede no other phase's timing
    tt_tp = phase_two_tower_sharded(tt_ref, tt_ref_train, LM_SEED, ahead=ahead.pop("22"))
    del tt_ref, tt_ref_train
    s22, t22 = tt_tp["world4"]["serve"], tt_tp["world4"]["train"]
    log(f"phase 22: {TT_ARCH} on 'rows' through shard_cell on {smi}: world 1 (nccl) 16a's "
        f"bits; world 4 (gloo, one card, data 2 x model 2) at full width within "
        f"{max(s22['serve_p99']['err_of_temp'], s22['serve_bulk']['err_of_temp'])!r} of temp "
        f"of 16a's, serve_p99 {s22['serve_p99']['ms']!r} ms a call by rank, peak "
        f"{s22['peak_gb']!r} GB a rank; trained at 16b's cut within {t22['rel_err']!r} of "
        f"16b's steps, {t22['step_s']!r} s a step by rank; collectives equal to the dry run's; "
        f"a sharded state checkpointed by the manager and restored bit for bit; "
        f"{tt_tp['seconds']!r} s")

    for mod in ("jax", "repro"):
        check(mod not in sys.modules, f"{mod} was imported")

    k3_paths = {"qwen3-14b": lm["k3_launches"],
                "qwen3-14b-sharded-world1": tp["world1"]["k3_launches"],
                "qwen3-14b-sharded-world2": sum(r["k3_launches"] for r in tp["world2"]["ranks"]),
                **{a: moe[a]["k3_launches"] for a in MOE_LAYERS},
                "qwen3-14b-train": train["qwen3_14b"]["k3_launches"],
                "qwen3-14b-fsdp-world1": fsdp["world1"]["k3_launches"],
                "qwen3-14b-fsdp-world2": sum(r["k3_launches"] for r in w2["ranks"]),
                "olmoe-1b-7b-sharded-world1": moe_tp["world1"]["k3_launches"],
                "olmoe-1b-7b-sharded-world4": sum(r["k3_launches"] for r in w4["ranks"]),
                "mixtral-8x7b-sharded-world2": sum(r["k3_launches"] for r in wm["ranks"]),
                "olmoe-1b-7b-fsdp-world1": moe_fsdp["world1"]["k3_launches"],
                "olmoe-1b-7b-fsdp-world4": sum(r["k3_launches"] for r in w4o["ranks"]),
                "mixtral-8x7b-fsdp-world4": sum(r["k3_launches"] for r in w4x["ranks"])}
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
         "launches_by_path": spade_paths["peel_round"],
         "launches_off_main_path": {"phase20": tp_cells["launches"]["peel_round"],
                                    "phase22": tt_tp["launches"]["peel_round"]},
         "bound_by": "bytes",
         "library_ms": None, **rec["peel_round"]},
        {"name": "frontier_spmv", "route": "cuda",
         "source": "src/repro_torch/csrc/frontier_spmv.cu",
         "replaces": "src/repro/core/peel.py:201",
         "launches": sum(spade_paths["frontier_spmv"].values()),
         "launches_by_path": spade_paths["frontier_spmv"],
         "launches_off_main_path": {"phase20": tp_cells["launches"]["frontier_spmv"],
                                    "phase22": tt_tp["launches"]["frontier_spmv"]},
         "bound_by": "bytes",
         "library_ms": None, **rec["frontier_spmv"]},
        {"name": "suffix_init", "route": "cuda",
         "source": "src/repro_torch/csrc/frontier_spmv.cu",
         "replaces": "src/repro/core/peel.py:324",
         "launches": sum(spade_paths["suffix_init"].values()),
         "launches_by_path": spade_paths["suffix_init"],
         "launches_off_main_path": {"phase20": tp_cells["launches"]["suffix_init"],
                                    "phase22": tt_tp["launches"]["suffix_init"]},
         "bound_by": "bytes",
         "library_ms": None, **tick["suffix_init"],
         **{f"f64_mode_{k}": v for k, v in rec["suffix_init_f64"].items()}},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:116",
         "launches": sum(k3_paths.values()), "launches_by_path": k3_paths,
         "launches_off_main_path": {"phase22": tt_tp["launches"]["flash_attention"]},
         "bound_by": "operations", **attn,
         "max_abs_err": max([attn["max_abs_err"]]
                            + [moe["attention"][a]["max_abs_err"] for a in MOE_LAYERS]),
         "moe_shapes": {a: {k: moe["attention"][a][k] for k in
                            ("shape", "ms", "library_ms", "bound_ms", "max_abs_err")}
                        for a in MOE_LAYERS},
         "q_offset_checks": tp["k3_offsets"],
         "local_map_gradient_checks": fsdp["k3"]},
        {"name": "flash_attention_simt", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:116",
         "launches": sum(simt_paths.values()), "launches_by_path": simt_paths,
         "launches_off_main_path": {"phase22": tt_tp["launches"]["flash_attention_simt"]},
         **attn_simt},
        {"name": "gather_segsum", "route": "cuda",
         "source": "src/repro_torch/csrc/gather_segsum.cu",
         "replaces": "src/repro/kernels/gather_segsum/kernel.py:72",
         "launches": sum(k4_paths.values()), "launches_by_path": k4_paths,
         "launches_off_main_path": {"phase20": tp_cells["launches"]["gather_segsum"],
                                    "phase22": tt_tp["launches"]["gather_segsum"]}, **k4},
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
             "qwen3_14b": lm, "tensor_parallel": tp, "gather_segsum": k4_cases,
             "gnn_parity": gnn_parity,
             "gcn_cora": gcn, "cross_plane": cross, "sharded": sharded, "moe": moe,
             "train": train, "cells": cells, "fsdp": fsdp, "moe_tp": moe_tp,
             "sharded_cells": tp_cells, "moe_fsdp": moe_fsdp, "two_tower_sharded": tt_tp},
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
