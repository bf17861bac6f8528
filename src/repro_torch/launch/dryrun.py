"""Multi-pod dry run of the port (port of ``repro/launch/dryrun.py``): every
(architecture x input shape x mesh) cell at full size, with no data.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gat-cora \\
        --shape molecule --mesh multi
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
        --out build/dryrun

For each mesh the process joins torch's fake process group (one process
plays every rank: 256 for ``single``, 512 for ``multi``) and builds the
production ``DeviceMesh``.  Each cell is built on ``meta``
(``build_cell(concrete=False)``) and reports:

* **per-device argument bytes**, exact: each leaf of the cell's
  arguments (in the reference's layout, :func:`~repro_torch.launch.cells.
  reference_args`) placed by its logical axes (:class:`~repro_torch.dist.
  sharding.AxisEnv`), its largest shard counted;
* **FLOPs**, from ``torch.utils.flop_counter.FlopCounterMode`` over one
  step of the cell on ``meta`` (the plain blocked attention at the
  config's blocks, which is what a meta tensor runs).  A meta tensor runs
  its ops in Python, so an LM cell is traced at 1 and 2 layers and its
  FLOPs taken as ``f(1) + (L - 1) (f(2) - f(1))``: its layers are alike,
  so that is the full depth's count.  ``flops_per_chip`` is that over the
  mesh's ranks (an even split);
* **roofline times** on one NVIDIA H100 SXM (published dense peaks):
  ``flops_per_chip`` at 989 TFLOP/s bf16, the argument bytes at 3.35 TB/s
  of HBM3 (each argument read once: a floor on the traffic), and which
  of the two is larger.

Not reported: **collective bytes**.  The reference parses them from XLA's
partitioned HLO, which has no PyTorch counterpart (``collective_bytes``
is null, with the reason).  A cell whose step reads values on the host
(the Spade peels' kernels and round counts, GCN's destination rows, MoE
routing counts) cannot run on ``meta``: it reports its argument bytes and
a ``meta_run`` reason, and counts as no failure.
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
from repro_torch.dist.sharding import AxisEnv, local_shape, logical_leaves, use_axis_env
from repro_torch.launch.cells import Cell, build_cell, reference_args
from repro_torch.launch.mesh import MULTI_POD, SINGLE_POD, make_production_mesh

__all__ = ["CARD", "PEAK_FLOPS", "HBM_BW", "LINK_BW", "cell_flops", "argument_bytes",
           "run_cell", "main"]

# one NVIDIA H100 SXM: published dense peaks (NVIDIA's data sheet, 700 W)
CARD = "NVIDIA H100 SXM (published peaks)"
PEAK_FLOPS = 989e12  # bf16 dense
HBM_BW = 3.35e12  # HBM3
LINK_BW = 450e9  # NVLink, each direction (no collective bytes to put over it)

NO_COLLECTIVES = ("the reference parses collective bytes from XLA's partitioned HLO, "
                  "which has no PyTorch counterpart")


def _fake_world(n: int) -> None:
    """Join torch's fake process group as rank 0 of ``n`` (leaving any
    group of another size first)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


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
        return _traced_flops(build_cell(arch, shape, roofline=roofline)), "traced"
    f1, f2 = (_traced_flops(build_cell(arch, shape, roofline=roofline, override_layers=n))
              for n in (1, 2))
    L = get_config(arch).n_layers
    return f1 + (L - 1) * (f2 - f1), f"traced at 1 and 2 layers, extrapolated to {L}"


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
        env = AxisEnv(mesh=make_production_mesh(multi_pod=multi, device_type="cpu"))
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
            "collective_bytes_per_chip": None, "collectives": None,
            "collective_bytes_reason": NO_COLLECTIVES, "t_collective_s": None,
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
        if "flops" in fl:
            per_chip = fl["flops"] / n_chips
            t_compute = per_chip / PEAK_FLOPS
            result.update(
                flops_per_chip=per_chip, t_compute_s=t_compute,
                useful_flops_ratio=cell.model_flops / fl["flops"] if fl["flops"] else 0.0,
                dominant="compute" if t_compute >= t_memory else "memory")
        result["wall_s"] = round(time.time() - t0, 1)
        times = (f"compute={result['t_compute_s']:.3e}s " if "flops" in fl
                 else f"meta_run: {fl['meta_run'][:80]} ")
        print(f"[{arch} x {shape} x {mesh_kind}] OK {times}memory={t_memory:.3e}s "
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
