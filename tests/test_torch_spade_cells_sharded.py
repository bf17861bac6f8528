"""The Spade cells (``spade-grab`` x ``grab4_static`` / ``grab4_stream``)
run sharded on a ``DeviceMesh`` through ``repro_torch.launch.cells.
shard_cell`` (the edge-sharded engine, the graph's edges on ``edges``) on
the CPU, against ``repro``'s cells run under GSPMD and against the port
unsharded.

``repro``'s side: the smoke cells jitted with their ``in_logical``
shardings on a ``jax.sharding.Mesh`` of the conftest's host devices
(``jax.make_mesh`` fails on this container: ROADMAP C.5), on (data 2,
model 2) and (data 4, model 1).

The port's side: one :func:`repro_torch.dist.spawn` of four ``gloo``
ranks; each rank steps both cells on meshes over the same world:

* ``data2_model2`` and ``data4_model1``: ``edges`` resolves to ``data``,
  the blocks replicated over ``model``;
* ``pod2_data2``: (pod 2, data 2, model 1), ``edges`` resolves to the
  tuple ``("pod", "data")``, a flattened group of four, pod-major;
* ``model4``: a mesh of one dim, ``model``: ``edges`` resolves to no dim,
  and the engine runs each rank on a group of itself (no collective);
* ``tuple_data_model``: the engine called directly with ``axis=("data",
  "model")`` on the (2, 2) mesh, a group of all four ranks.

Weights are unit (the cells' own), so every float32 sum is exact and every
output field is bit for bit: the static cell's ``level``, ``best_level``,
``best_g``, ``n_rounds``, ``delta``; the stream cell's ``level``,
``best_g``, ``community``, ``edge_count``, ``w0`` and its graph, the
ranks' edge blocks joined (by ``unshard_graph``, and slot for slot on the
host).  Each rank's all-reduces and bytes a step equal the dry run's
count (``dist.graph.cell_step_collectives``).

Spawned ranks import this file for its rank functions only: the ``if``
below keeps ``jax`` and ``repro`` out of them.
"""

from __future__ import annotations

import multiprocessing

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import SPADE_SHAPES  # noqa: E402
from repro_torch.dist import spawn  # noqa: E402

if multiprocessing.parent_process() is None:  # not in a spawned rank
    import jax
    from jax.sharding import Mesh

    from repro.dist import sharding as jsharding
    from repro.launch import cells as jcells

ARCH = "spade-grab"
SHAPES = tuple(SPADE_SHAPES)
FIELDS = {"grab4_static": ("level", "best_level", "best_g", "n_rounds", "delta"),
          "grab4_stream": ("level", "best_g", "community", "edge_count", "w0")}
EDGES = ("src", "dst", "c", "edge_mask")
JAX_MESHES = {"data2_model2": (2, 2), "data4_model1": (4, 1)}
CASES = ("data2_model2", "data4_model1", "pod2_data2", "model4", "tuple_data_model")
TIMEOUT = 240


def _numpy(res, shape: str) -> dict:
    return {f: np.asarray(getattr(res, f)) for f in FIELDS[shape]}


def _step(cell, shape: str, graph_of=None) -> dict:
    """One step of a (sharded) port cell: its fields as numpy, and for the
    stream cell the graph (``graph_of`` joins a sharded one)."""
    from repro_torch.dist import graph as dg

    dg.reset_stats()
    res = cell.fn(*cell.args)
    out = {"fields": {f: getattr(res, f).numpy().copy() for f in FIELDS[shape]},
           "stats": {k: dg.STATS[k] for k in ("all_reduces", "reduced_bytes")}}
    if shape == "grab4_stream":
        g = res.graph
        out["block"] = {f: getattr(g, f).numpy().copy() for f in EDGES}
        if graph_of is not None:
            g = graph_of(g)
        out["graph"] = {f: getattr(g, f).numpy().copy() for f in EDGES}
    return out


def spade_rank(mesh) -> dict:
    """A rank: both cells on every case's mesh, through ``shard_cell``
    (the last case through the engine directly), and the dry run's count
    of each case's collectives a step."""
    import dataclasses
    import functools

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.dist import graph as dg
    from repro_torch.dist.sharding import AxisEnv
    from repro_torch.launch.cells import build_cell, shard_cell

    torch.set_num_threads(1)  # the ranks share the host's cores
    world = dist.get_world_size()
    meshes = {
        "data2_model2": mesh,
        "data4_model1": DeviceMesh("cpu", torch.arange(world).reshape(4, 1),
                                   mesh_dim_names=("data", "model")),
        "pod2_data2": DeviceMesh("cpu", torch.arange(world).reshape(2, 2, 1),
                                 mesh_dim_names=("pod", "data", "model")),
        "model4": DeviceMesh("cpu", torch.arange(world), mesh_dim_names=("model",)),
    }
    out = {}
    for case in CASES:
        for shape in SHAPES:
            cell = build_cell(ARCH, shape, concrete=True, smoke=True, device="cpu")
            if case == "tuple_data_model":
                axes, m = ("data", "model"), mesh
                kw = dict(cell.fn.keywords, mesh=m, axis=axes)
                if shape == "grab4_static":
                    sc = dataclasses.replace(
                        cell, fn=functools.partial(dg.sharded_bulk_peel, **kw),
                        args=(dg.shard_graph(cell.args[0], m, axes),))
                else:
                    state = dataclasses.replace(
                        cell.args[0], graph=dg.shard_graph(cell.args[0].graph, m, axes))
                    sc = dataclasses.replace(
                        cell, fn=functools.partial(dg.sharded_insert_and_maintain, **kw),
                        args=(state,) + cell.args[1:])
            else:
                m = meshes[case]
                sc = shard_cell(cell, AxisEnv(m))
                axes = sc.fn.keywords["axis"]
            r = _step(sc, shape, lambda g: dg.unshard_graph(g, m, axes))
            g0 = sc.args[0] if shape == "grab4_static" else sc.args[0].graph
            r.update(axes=axes, rank_world=(g0.rank, g0.world), predicted=dg.cell_step_collectives(
                g0.n_capacity, sc.fn.keywords["max_rounds"], bool(axes)))
            out[(case, shape)] = r
    return out


def _jax_gspmd(shape: str, mesh_shape: tuple[int, int]) -> dict:
    """``repro``'s smoke cell jitted with its ``in_logical`` shardings on a
    (data, model) mesh of host devices."""
    j = jcells.build_cell(ARCH, shape, concrete=True, smoke=True)
    devs = np.array(jax.devices()[:int(np.prod(mesh_shape))]).reshape(mesh_shape)
    mesh = Mesh(devs, ("data", "model"))
    with jsharding.use_axis_env(jsharding.AxisEnv(mesh=mesh)), mesh:
        res = jax.jit(j.fn, in_shardings=jsharding.tree_shardings(j.in_logical))(*j.args)
    out = {"fields": _numpy(res, shape)}
    if shape == "grab4_stream":
        out["graph"] = {f: np.asarray(getattr(res.graph, f)) for f in EDGES}
    return out


@pytest.fixture(scope="module")
def runs():
    from repro_torch.launch.cells import build_cell

    ref = {(m, s): _jax_gspmd(s, shp) for m, shp in JAX_MESHES.items() for s in SHAPES}
    port = {s: _step(build_cell(ARCH, s, concrete=True, smoke=True, device="cpu"), s)
            for s in SHAPES}
    ranks = spawn(spade_rank, 4, device="cpu", timeout=TIMEOUT,
                  mesh_shape={"data": 2, "model": 2})
    return {"ref": ref, "port": port, "ranks": ranks}


def _equal(got: dict, want: dict, what: str) -> None:
    assert got.keys() == want.keys(), what
    for k, w in want.items():
        assert got[k].dtype == w.dtype and np.array_equal(got[k], w), f"{what}: {k} differs"


@pytest.mark.parametrize("shape", SHAPES)
def test_port_unsharded_equals_repro_gspmd(runs, shape):
    """The reference's GSPMD run gives the unsharded bits on both meshes,
    and so does the port's unsharded step."""
    for m in JAX_MESHES:
        want = runs["ref"][(m, shape)]
        _equal(runs["port"][shape]["fields"], want["fields"], f"{m} {shape}")
        if shape == "grab4_stream":
            _equal(runs["port"][shape]["graph"], want["graph"], f"{m} {shape} graph")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_cell_equals_repro_gspmd(runs, case, shape):
    """Every rank's output fields, and the joined edge blocks, bit for bit
    with ``repro``'s GSPMD run (on the mesh of the same shape where there
    is one, else (data 4, model 1)'s, which equals the other)."""
    want = runs["ref"][(case if case in JAX_MESHES else "data4_model1", shape)]
    for r, got in enumerate(runs["ranks"]):
        got = got[(case, shape)]
        _equal(got["fields"], want["fields"], f"{case} {shape} rank {r}")
        if shape == "grab4_stream":
            _equal(got["graph"], want["graph"], f"{case} {shape} rank {r} graph")


@pytest.mark.parametrize("case", CASES)
def test_edge_groups_and_their_collectives(runs, case):
    """The rank's index and the group's size as the case's edge dims
    name them (pod-major for (pod, data); the whole world for (data,
    model); a group of one on a mesh without an ``edges`` dim), the blocks
    joined on the host slot for slot equal to ``unshard_graph``'s, and
    each step's all-reduces and bytes equal to the dry run's count: 1 +
    max_rounds of V + 1 float64, none on a group of one."""
    ranks = runs["ranks"]
    want_axes = {"data2_model2": ("data",), "data4_model1": ("data",),
                 "pod2_data2": ("pod", "data"), "model4": (),
                 "tuple_data_model": ("data", "model")}[case]
    for shape in SHAPES:
        rw = [r[(case, shape)]["rank_world"] for r in ranks]
        if case == "model4":
            assert rw == [(0, 1)] * 4
        elif case == "data2_model2":
            assert rw == [(0, 2), (0, 2), (1, 2), (1, 2)]
        else:
            assert rw == [(r, 4) for r in range(4)]
        for r in ranks:
            got = r[(case, shape)]
            assert tuple(got["axes"]) == want_axes
            pred = got["predicted"]
            assert got["stats"] == {"all_reduces": pred["calls"],
                                    "reduced_bytes": pred["bytes"]}, (case, shape)
            assert (pred["calls"] == 0) == (case == "model4")
        if shape == "grab4_stream":
            world = rw[0][1]
            firsts = {k: i for i, (k, _) in reversed(list(enumerate(rw)))}
            blocks = [ranks[firsts[k]][(case, shape)]["block"] for k in range(world)]
            E = ranks[0][(case, shape)]["graph"]["src"].shape[0]
            joined = {f: np.concatenate([b[f] for b in blocks])[:E] for f in EDGES}
            _equal(joined, ranks[0][(case, shape)]["graph"], f"{case} joined on the host")

