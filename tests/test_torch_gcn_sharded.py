"""gcn-cora's train step run sharded on a ``DeviceMesh`` through
``repro_torch.launch.cells.shard_cell`` on the CPU (the vertex arrays on
``vertex``, the edge arrays on ``edges``, the parameters replicated),
against ``repro``'s cells run under GSPMD and against the port unsharded.

``repro``'s side: each smoke cell's ``train_step`` jitted with its
``in_logical`` shardings on a ``jax.sharding.Mesh`` of the conftest's host
devices (``jax.make_mesh`` fails on this container: ROADMAP C.5), on
(data 2, model 2) and (data 4, model 1).  The port's side: one
:func:`repro_torch.dist.spawn` of four ``gloo`` ranks stepping each cell,
from ``repro``'s initial state, on both meshes; rank 0 also on its own
one-rank (data 1, model 1) mesh, which gives the unsharded bits.

Tolerances, as ``tests/test_torch_cells.py``'s for a train step and why:
loss and ``grad_norm`` at rtol ``RTOL`` 1e-5 (the ranks add the
aggregate's partial sums, the loss's numerator and the gradients' partial
sums over the vertex shards in another order than one device, and XLA in
another again: float32 roundings); the parameters within 1 % of a step
plus 2 ulps, but for at most 2 elements of a leaf or 0.1 % of them, each
within ``2 lr`` (Adam's first step moves an element by about
``lr * sign(g)``: a last-bit difference flips the sign of a ``g`` near 0).

Spawned ranks import this file for its rank functions only: the ``if``
below keeps ``jax`` and ``repro`` out of them.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import pytree  # noqa: E402
from repro_torch.convert import train_state_from_numpy, train_state_to_numpy  # noqa: E402
from repro_torch.dist import spawn  # noqa: E402

if multiprocessing.parent_process() is None:  # not in a spawned rank
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    from repro.dist import sharding as jsharding
    from repro.launch import cells as jcells
    from test_torch_cells import assert_params_close, jax_leaves, torch_leaves

ARCH = "gcn-cora"
SHAPES = tuple(tconfigs.GNN_SHAPES)
MESHES = {"data2_model2": (2, 2), "data4_model1": (4, 1)}
RTOL = 1e-5
TIMEOUT = 240


def _port_step(state_np, shape: str, env=None) -> dict:
    """The port's smoke cell stepped once from ``state_np`` (on ``env``'s
    mesh through ``shard_cell`` when given): loss, grad_norm and the
    parameters in the reference's layout, as numpy."""
    from repro_torch.dist.sharding import use_axis_env
    from repro_torch.launch.cells import build_cell, shard_cell

    cell = build_cell(ARCH, shape, concrete=True, smoke=True, device="cpu")
    state = train_state_from_numpy(state_np, tconfigs.get_smoke_config(ARCH), "cpu")
    cell = dataclasses.replace(cell, args=(state,) + cell.args[1:])
    if env is None:
        state, metrics = cell.fn(*cell.args)
    else:
        cell = shard_cell(cell, env)
        with use_axis_env(env):
            state, metrics = cell.fn(*cell.args)
        whole = lambda tree: pytree.tree_map(lambda t: t.full_tensor(), tree)
        state = dataclasses.replace(state, params=whole(state.params), m=whole(state.m),
                                    v=whole(state.v))
    return {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
            "lr": float(metrics["lr"]),
            "params": torch_leaves(train_state_to_numpy(state).params)}


def gcn_rank(mesh, path: str) -> dict:
    """A rank: every shape on (data 2, model 2) and (data 4, model 1);
    rank 0 also on its own one-rank mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.dist.sharding import AxisEnv

    torch.set_num_threads(1)  # the ranks share the host's cores
    with open(path, "rb") as f:
        states = pickle.load(f)
    rank, world = dist.get_rank(), dist.get_world_size()
    meshes = {"data2_model2": mesh,
              "data4_model1": DeviceMesh("cpu", torch.arange(world).reshape(4, 1),
                                         mesh_dim_names=("data", "model"))}
    own = [dist.new_group([r]) for r in range(world)][rank]
    one = DeviceMesh.from_group([own, own], "cpu", mesh=torch.tensor([[rank]]),
                                mesh_dim_names=("data", "model"))
    out = {(m, s): _port_step(states[s], s, AxisEnv(meshes[m])) for m in MESHES
           for s in SHAPES}
    if rank == 0:
        out.update({("one", s): _port_step(states[s], s, AxisEnv(one)) for s in SHAPES})
    return out


def _divisible(s, x):
    """``s``, or replicated where a dim of ``x`` does not divide by its
    shard count (the smoke batch's one-element triplet arrays), as the
    port's placements do."""
    try:
        s.shard_shape(x.shape)
        return s
    except ValueError:
        return NamedSharding(s.mesh, PartitionSpec())


def _jax_gspmd(j, mesh_shape: tuple[int, int]) -> dict:
    """``repro``'s train step jitted with the cell's ``in_logical``
    shardings on a (data, model) mesh of host devices."""
    devs = np.array(jax.devices()[:int(np.prod(mesh_shape))]).reshape(mesh_shape)
    mesh = Mesh(devs, ("data", "model"))
    with jsharding.use_axis_env(jsharding.AxisEnv(mesh=mesh)), mesh:
        sh = jax.tree.map(_divisible, jsharding.tree_shardings(j.in_logical), tuple(j.args),
                          is_leaf=lambda x: isinstance(x, NamedSharding))
        state, metrics = jax.jit(j.fn, in_shardings=sh)(*j.args)
    return {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
            "lr": float(metrics["lr"]), "params": jax_leaves(state.params)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    states, ref, port = {}, {}, {}
    for s in SHAPES:
        j = jcells.build_cell(ARCH, s, concrete=True, smoke=True)
        states[s] = jax.tree.map(np.asarray, j.args[0])
        for m, shp in MESHES.items():
            ref[(m, s)] = _jax_gspmd(j, shp)
        port[s] = _port_step(states[s], s)
    path = tmp_path_factory.mktemp("gcn_sharded") / "states.pkl"
    path.write_bytes(pickle.dumps(states))
    ranks = spawn(gcn_rank, 4, device="cpu", args=(str(path),), timeout=TIMEOUT,
                  mesh_shape={"data": 2, "model": 2})
    return {"ref": ref, "port": port, "ranks": ranks}


def _close(got: dict, want: dict, what: str) -> None:
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=f"{what} {k}")
    assert got["lr"] == want["lr"], what
    assert_params_close(got["params"], want["params"], want["lr"], what)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_step_matches_repro_gspmd(runs, mesh, shape):
    for r, got in enumerate(runs["ranks"]):
        _close(got[(mesh, shape)], runs["ref"][(mesh, shape)], f"{mesh} {shape} rank {r}")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_step_matches_port_unsharded(runs, mesh, shape):
    """Every rank holds the same replicated result, within RTOL of the
    port's unsharded step."""
    ranks = runs["ranks"]
    for r, got in enumerate(ranks):
        _close(got[(mesh, shape)], runs["port"][shape], f"{mesh} {shape} rank {r}")
        for k, v in got[(mesh, shape)]["params"].items():
            assert np.array_equal(v, ranks[0][(mesh, shape)]["params"][k]), (mesh, shape, r, k)


@pytest.mark.parametrize("shape", SHAPES)
def test_one_rank_mesh_gives_the_unsharded_bits(runs, shape):
    got, want = runs["ranks"][0][("one", shape)], runs["port"][shape]
    assert (got["loss"], got["grad_norm"]) == (want["loss"], want["grad_norm"])
    for k, v in want["params"].items():
        assert np.array_equal(got["params"][k], v), (shape, k)
