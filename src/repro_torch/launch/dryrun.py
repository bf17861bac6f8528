"""Multi-pod dry run of the port (port of ``repro/launch/dryrun.py``): every
(architecture x input shape x mesh) cell at full size, with no data.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gat-cora \\
        --shape molecule --mesh multi
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
        --out build/dryrun

For each mesh the process joins torch's fake process group (one process
plays every rank: 256 for ``single``, 512 for ``multi``; it is the mesh's
last rank) and builds the production ``DeviceMesh`` (device type
``cuda``, the card's, whose DTensor moves a shard between dims by an
all-to-all).  Each cell is built on ``meta`` (``build_cell(concrete=
False)``) and reports:

* **per-device argument bytes**, exact: each leaf of the cell's
  arguments (in the reference's layout, :func:`~repro_torch.launch.cells.
  reference_args`) placed by its logical axes (:class:`~repro_torch.dist.
  sharding.AxisEnv`), its largest shard counted;
* **FLOPs**, from ``torch.utils.flop_counter.FlopCounterMode`` over one
  step of the cell on ``meta`` (the plain blocked attention at the
  config's blocks, which is what a meta tensor runs).  A meta tensor runs
  its ops in Python, so an LM cell is traced at 1 and 2 layers and its
  FLOPs taken as ``f(1) + (L - 1) (f(2) - f(1))``: its layers are alike,
  so that is the full depth's count;
* for the LM cells (``prefill``, ``decode_step`` and ``train_step``;
  dense and MoE), the GNN train cells (GCN, GAT, MeshGraphNet and
  DimeNet) and the two-tower cells, the step **run sharded**: the cell's
  arguments as meta DTensors on the mesh (:func:`~repro_torch.launch.
  cells.shard_cell`), traced at 1 and 2 layers under :class:`~repro_torch.
  dist.sharding.LocalCost` and extrapolated as above (a GNN or a two-tower
  cell: traced once, K4's plain version giving GCN's shapes, every edge
  of a rank's block kept where the card keeps those ending in its rows,
  and every lookup of a rank's gathered batch counted as a hit of its
  table rows in the backward, where the card adds only the hits).  A MoE
  train step's count a layer and microbatch is held by hand in
  ``tests/test_torch_sharding.py`` (``test_dryrun_sharded_smoke_moe_train``;
  PERF.md gives it at the production meshes), and so are the GNNs'
  (``test_dryrun_sharded_smoke_gcn``, ``test_dryrun_sharded_smoke_gnn``).
  By hand, vertex rows on ``model``, edges on the edge dims (one
  collective over them, their flattened group), float32: GAT a layer,
  ``h`` [N, heads d] all-gathered and its gradient reduce-scattered,
  five all-reduces over the edge dims (the softmax's max and denominator
  [n, heads], the messages' row sums [n, heads, d]; in the backward the
  denominator's gradient and ``h``'s rows'); MeshGraphNet a processor
  step, ``h`` [N, H] all-gathered twice (the forward and the remat's
  recompute) and reduce-scattered once, three all-reduces of [n, H] (the
  aggregate settled in both passes, ``h``'s rows' gradient); DimeNet a
  block, ``m`` [E, H] all-gathered three times (the forward, the
  recompute, the triplet sums' backward) and [E_b, H] reduce-scattered
  three times, plus once a step ``x`` [N, H] gathered and reduce-
  scattered, ``edge_len`` [E] gathered, two all-reduces of [n, H]; every
  kind, one all-reduce a parameter leaf (its gradient settled) and the
  loss's two.  ``flops_per_chip`` is the traced rank's local
  FLOPs (the last rank: under sequence-sharded causal attention, the
  heaviest share), ``collectives`` the bytes of its collectives' outputs
  by the reference's five names (``collective_calls`` their number),
  ``collective_bytes_per_chip`` their sum, ``t_collective_s`` that at
  450 GB/s of NVLink a direction, and ``dominant`` the largest of the
  three times.  The Spade cells' collectives are counted from the
  edge-sharded engine's structure (:func:`spade_cost`: 1 + ``max_rounds``
  all-reduces of ``V + 1`` float64 a step), which ``chip_smoke.py``'s
  phase 20 holds to the card's count.  A two-tower cell's count by
  hand, a tower a chunk of a rank's batch rows (``tests/
  test_torch_sharding.py``, ``test_dryrun_sharded_smoke_two_tower``):
  the rows' lookups and weights all-gathered over the mesh dims that
  split both the batch and the table, the partial bags reduce-scattered
  over them and all-reduced over the table's other dims; a train step
  adds the bags' gradients gathered, the item embeddings gathered and
  their gradient reduce-scattered, the loss's and accuracy's sums, one
  all-reduce a replicated parameter leaf and AdamW's norm; retrieval,
  the query's bag all-reduced and the ranks' top-100 (score, index)
  pairs gathered;
* **roofline times** on one NVIDIA H100 SXM (published dense peaks):
  ``flops_per_chip`` at 989 TFLOP/s bf16, the argument bytes at 3.35 TB/s
  of HBM3 (each argument read once: a floor on the traffic), and which
  is larger.

A cell whose step cannot run on ``meta`` (the Spade peels: their kernels'
wrappers refuse it) reports its argument bytes and a ``meta_run`` reason
for its FLOPs, and counts as no failure.  gcn-cora's FLOPs are traced on
meta with K4's plain version, which no FLOP formula counts: its products
only.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_FAMILY, ARCHS, Skip, arch_shapes, get_config
from repro_torch.dist.graph import cell_step_collectives
from repro_torch.dist.sharding import (COLLECTIVES, AxisEnv, LocalCost, local_shape,
                                      logical_leaves, use_axis_env)
from repro_torch.launch.cells import Cell, build_cell, reference_args, shard_cell
from repro_torch.launch.mesh import MULTI_POD, SINGLE_POD, make_production_mesh

__all__ = ["CARD", "PEAK_FLOPS", "HBM_BW", "LINK_BW", "cell_flops", "argument_bytes",
           "sharded_cost", "spade_cost", "run_cell", "main"]

# one NVIDIA H100 SXM: published dense peaks (NVIDIA's data sheet, 700 W)
CARD = "NVIDIA H100 SXM (published peaks)"
PEAK_FLOPS = 989e12  # bf16 dense
HBM_BW = 3.35e12  # HBM3
LINK_BW = 450e9  # NVLink, each direction


def _fake_world(n: int) -> None:
    """Join torch's fake process group as the last rank of ``n`` (leaving
    any group of another size first)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=n - 1, world_size=n)


def argument_bytes(cell: Cell, env: AxisEnv) -> tuple[int, int]:
    """(bytes of the largest shard of every argument leaf, global bytes)."""
    sizes = list(env.mesh_shape.values())
    per_dev = total = 0
    for _, x, names in logical_leaves(reference_args(cell), cell.in_logical):
        shard = local_shape(x.shape, env.placements(*names), sizes)
        per_dev += math.prod(shard) * x.element_size()
        total += x.numel() * x.element_size()
    return per_dev, total


def _traced_flops(cell: Cell) -> float:
    with torch.enable_grad(), FlopCounterMode(display=False) as counter:
        cell.fn(*cell.args)
    return float(counter.get_total_flops())


def cell_flops(arch: str, shape: str, roofline: bool = False) -> tuple[float, str]:
    """(FLOPs of one step of the cell on meta, how they were counted)."""
    if ARCH_FAMILY[arch] != "lm":
        how = ("traced (K4's gather-sums have no FLOP formula: the products only)"
               if ARCH_FAMILY[arch] == "gnn" and get_config(arch).kind == "gcn" else "traced")
        return _traced_flops(build_cell(arch, shape, roofline=roofline)), how
    f1, f2 = (_traced_flops(build_cell(arch, shape, roofline=roofline, override_layers=n))
              for n in (1, 2))
    L = get_config(arch).n_layers
    return f1 + (L - 1) * (f2 - f1), f"traced at 1 and 2 layers, extrapolated to {L}"


def sharded_cost(make_cell, env: AxisEnv, n_layers: int | None) -> dict:
    """One step of a cell run sharded on ``env``'s mesh (a train step with
    its gradient: the forward, the rematerialised layers and the
    backward, the gathers' reduce-scatters and AdamW's norm):
    this rank's FLOPs and collective bytes and calls by kind, traced on
    ``make_cell(1)`` and ``make_cell(2)`` (an LM cell at 1 and 2 layers,
    normally on meta) and extrapolated to ``n_layers``; ``n_layers`` None:
    traced once on ``make_cell(None)``, the cell at its own depth (a
    GNN's)."""
    def trace(n: int | None) -> LocalCost:
        cell = shard_cell(make_cell(n), env)
        grad = torch.enable_grad() if cell.step_name == "train_step" else torch.no_grad()
        with grad, use_axis_env(env), LocalCost() as cost:
            cell.fn(*cell.args)
        return cost

    if n_layers is None:
        c = trace(None)
        return {"flops_per_chip": float(c.flops), "collectives": dict(c.collectives),
                "collective_calls": dict(c.calls),
                "collective_bytes_per_chip": sum(c.collectives.values()),
                "sharded_counted": "local FLOPs and collectives of the sharded step, "
                                   "traced on meta (K4's plain version for shapes)"}
    c1, c2 = trace(1), trace(2)
    ext = lambda a, b: a + (n_layers - 1) * (b - a)
    coll = {k: ext(c1.collectives[k], c2.collectives[k]) for k in COLLECTIVES}
    return {"flops_per_chip": float(ext(c1.flops, c2.flops)), "collectives": coll,
            "collective_calls": {k: ext(c1.calls[k], c2.calls[k]) for k in COLLECTIVES},
            "collective_bytes_per_chip": sum(coll.values()),
            "sharded_counted": f"local FLOPs and collectives of the sharded step, traced at "
                               f"1 and 2 layers, extrapolated to {n_layers}"}


def spade_cost(cell: Cell, env: AxisEnv) -> dict:
    """A Spade cell's collectives a rank a step on the edge-sharded engine,
    counted from the engine's structure
    (:func:`~repro_torch.dist.graph.cell_step_collectives`): its kernels
    and the peel's state refuse a meta tensor, so the step is not traced.
    Phase 20 of ``chip_smoke.py`` holds the card's ``STATS`` to it."""
    g = cell.args[0] if cell.step_name == "bulk_peel" else cell.args[0].graph
    c = cell_step_collectives(g.n_capacity, cell.fn.keywords["max_rounds"],
                              env.resolve("edges") is not None)
    coll = {k: 0 for k in COLLECTIVES} | {"all-reduce": c["bytes"]}
    return {"collectives": coll,
            "collective_calls": {k: 0 for k in COLLECTIVES} | {"all-reduce": c["calls"]},
            "collective_bytes_per_chip": c["bytes"], "t_collective_s": c["bytes"] / LINK_BW,
            "sharded_counted": "counted from the edge-sharded engine's structure "
                               "(repro_torch.dist.graph.cell_step_collectives): the peel's "
                               "prologue and each round all-reduce the float64 dw and "
                               "dropped mass, V + 1 elements"}


def run_cell(arch: str, shape: str, mesh_kind: str, flops: dict,
             roofline: bool = False) -> dict:
    """One (arch, shape, mesh) cell; ``flops`` caches each cell's meta
    count across meshes (the count does not depend on the mesh)."""
    spec = arch_shapes(arch)[shape]
    if isinstance(spec, Skip):
        return {"arch": arch, "shape": shape, "mesh": mesh_kind,
                "status": "SKIP", "reason": spec.reason}
    t0 = time.time()
    multi = mesh_kind == "multi"
    try:
        _fake_world(math.prod(MULTI_POD if multi else SINGLE_POD))
        env = AxisEnv(mesh=make_production_mesh(multi_pod=multi, device_type="cuda"))
        with use_axis_env(env):
            cell = build_cell(arch, shape, roofline=roofline)
            arg_bytes, total_bytes = argument_bytes(cell, env)
        n_chips = env.mesh.size()
        result = {
            "arch": arch, "shape": shape, "mesh": mesh_kind, "status": "OK",
            "variant": "roofline" if roofline else "production", "n_chips": n_chips,
            "card": CARD, "card_rates": {"flops": PEAK_FLOPS, "hbm_bytes": HBM_BW,
                                         "link_bytes": LINK_BW},
            "step_name": cell.step_name, "model_flops": cell.model_flops,
            "argument_bytes": arg_bytes, "argument_bytes_global": total_bytes,
            "collective_bytes_per_chip": None, "collectives": None, "t_collective_s": None,
        }
        t_memory = arg_bytes / HBM_BW
        key = (arch, shape, roofline)
        if key in flops:
            fl = flops[key]
        else:
            t1 = time.time()
            try:
                fl = dict(zip(("flops", "flops_counted"), cell_flops(arch, shape, roofline)))
            except (NotImplementedError, RuntimeError, ValueError) as e:
                if "meta" not in str(e).lower():  # a fault, not a step that needs data
                    raise
                fl = {"meta_run": f"{type(e).__name__}: {e}"}
            fl["trace_s"] = round(time.time() - t1, 1)
            flops[key] = fl
        result.update(fl)
        result["t_memory_s"] = t_memory
        times = {"memory": t_memory}
        if cell.family == "spade":
            result.update(spade_cost(cell, env))
            times["collective"] = result["t_collective_s"]
        else:
            t1 = time.time()
            result.update(sharded_cost(
                lambda n: build_cell(arch, shape, roofline=roofline, override_layers=n), env,
                get_config(arch).n_layers if cell.family == "lm" else None))
            result["sharded_trace_s"] = round(time.time() - t1, 1)
            result["t_collective_s"] = result["collective_bytes_per_chip"] / LINK_BW
            times["collective"] = result["t_collective_s"]
        if "flops" in fl:
            per_chip = result.setdefault("flops_per_chip", fl["flops"] / n_chips)
            times["compute"] = per_chip / PEAK_FLOPS
            result.update(
                t_compute_s=times["compute"],
                useful_flops_ratio=cell.model_flops / fl["flops"] if fl["flops"] else 0.0)
        if len(times) > 1:
            result["dominant"] = max(times, key=times.get)
        result["wall_s"] = round(time.time() - t0, 1)
        said = (f"compute={result['t_compute_s']:.3e}s " if "flops" in fl
                else f"meta_run: {fl['meta_run'][:80]} ")
        said += f"collective={result['t_collective_s']:.3e}s "
        print(f"[{arch} x {shape} x {mesh_kind}] OK {said}memory={t_memory:.3e}s "
              f"args/dev={arg_bytes} ({result['wall_s']}s)", flush=True)
        return result
    except Exception as e:
        traceback.print_exc()
        return {"arch": arch, "shape": shape, "mesh": mesh_kind,
                "status": "FAIL", "error": f"{type(e).__name__}: {e}"}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--family", choices=["lm", "gnn", "recsys", "spade"])
    ap.add_argument("--out", default=None, help="directory for per-cell JSON")
    ap.add_argument("--roofline", action="store_true",
                    help="the analysis variant (single-pod): one microbatch, coarse "
                         "attention blocks")
    args = ap.parse_args()
    if args.roofline:
        args.mesh = "single"

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells: list[tuple[str, str]] = []
    if args.all or args.family:
        for arch in ARCHS:
            if args.family and ARCH_FAMILY[arch] != args.family:
                continue
            for shape in arch_shapes(arch):
                cells.append((arch, shape))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all/--family required")
        cells.append((args.arch, args.shape))

    t0 = time.time()
    failures = 0
    flops: dict = {}
    try:
        for mk in meshes:
            for arch, shape in cells:
                res = run_cell(arch, shape, mk, flops, roofline=args.roofline)
                if res["status"] == "FAIL":
                    failures += 1
                    print(f"[{arch} x {shape} x {mk}] FAIL: {res['error']}")
                if args.out:
                    os.makedirs(args.out, exist_ok=True)
                    suffix = "roofline" if args.roofline else mk
                    fn = os.path.join(args.out, f"{arch}__{shape}__{suffix}.json")
                    with open(fn, "w") as f:
                        json.dump(res, f, indent=1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(f"dry-run done: {len(cells) * len(meshes)} cells, {failures} failures, "
          f"{time.time() - t0:.1f} s")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
