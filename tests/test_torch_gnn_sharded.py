"""GAT's, MeshGraphNet's and DimeNet's train steps run sharded on a
``DeviceMesh`` through ``repro_torch.launch.cells.shard_cell`` on the CPU
(the vertex arrays on ``vertex``, the edge and triplet arrays on
``edges``, the parameters replicated), against ``repro``'s cells run
under GSPMD and against the port unsharded.

``repro``'s side: each smoke cell's ``train_step`` jitted with its
``in_logical`` shardings on a ``jax.sharding.Mesh`` of the conftest's host
devices (``jax.make_mesh`` fails on this container: ROADMAP C.5), on
(data 2, model 2) and (data 4, model 1).  The port's side: one
:func:`repro_torch.dist.spawn` of four ``gloo`` ranks stepping each cell,
from ``repro``'s initial state, on both meshes; rank 0 also on its own
one-rank (data 1, model 1) mesh, which gives the unsharded bits; and
GAT's control, rank 1's softmax denominators left unsummed over the edge
group (``chip_smoke.unsummed_denominators``), which must fall outside the
tolerances; and MeshGraphNet with a ``mean`` aggregator, its loss and
gradients against the unsharded ones.

Tolerances, as ``tests/test_torch_gcn_sharded.py``'s and why: loss and
``grad_norm`` at rtol ``RTOL`` 1e-5 (the ranks add the row sums, the
softmax denominators, the triplets' sums, the loss's numerator and the
gradients' partial sums in another order than one device, and XLA in
another again: float32 roundings); the parameters within 1 % of a step
plus 2 ulps, but for at most 2 elements of a leaf or 0.1 % of them, each
within ``2 lr`` (Adam's first step moves an element by about
``lr * sign(g)``: a last-bit difference flips the sign of a ``g`` near 0).

The remat cases hold MeshGraphNet's and DimeNet's unsharded gradients
with the reference's rematerialisation against the same step without it,
bit for bit, and check that the forward stores less with it.

Spawned ranks import this file for its rank functions only: the ``if``
below keeps ``jax`` and ``repro`` out of them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import multiprocessing
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import unsummed_denominators  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import pytree  # noqa: E402
from repro_torch.convert import train_state_from_numpy, train_state_to_numpy  # noqa: E402
from repro_torch.dist import sharding, spawn  # noqa: E402

if multiprocessing.parent_process() is None:  # not in a spawned rank
    import jax

    from repro.launch import cells as jcells
    from test_torch_cells import assert_params_close, torch_leaves
    from test_torch_gcn_sharded import _jax_gspmd

ARCHS = ("gat-cora", "meshgraphnet", "dimenet")
SHAPES = ("full_graph_sm", "molecule")
MESHES = {"data2_model2": (2, 2), "data4_model1": (4, 1)}
RTOL = 1e-5
TIMEOUT = 300


def _port_step(arch: str, state_np, shape: str, env=None) -> dict:
    """The port's smoke cell stepped once from ``state_np`` (on ``env``'s
    mesh through ``shard_cell`` when given): loss, grad_norm and the
    parameters in the reference's layout, as numpy."""
    from repro_torch.dist.sharding import use_axis_env
    from repro_torch.launch.cells import build_cell, shard_cell

    cell = build_cell(arch, shape, concrete=True, smoke=True, device="cpu")
    state = train_state_from_numpy(state_np, tconfigs.get_smoke_config(arch), "cpu")
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


def _mean_loss_grads(env=None) -> list:
    """MeshGraphNet's smoke cell with a ``mean`` aggregator (no shipped
    config has one): its loss and gradients, unsharded or on ``env``'s
    mesh (whole), as numpy."""
    from repro_torch.dist.sharding import use_axis_env
    from repro_torch.launch.cells import build_cell, shard_cell
    from repro_torch.models.gnn import gnn_loss

    cfg = dataclasses.replace(tconfigs.get_smoke_config("meshgraphnet"), aggregator="mean")
    cell = build_cell("meshgraphnet", SHAPES[0], concrete=True, smoke=True, device="cpu")
    if env is not None:
        cell = shard_cell(cell, env)
    params = cell.args[0].params
    leaves = pytree.leaves(params)
    with torch.enable_grad(), use_axis_env(env) if env else contextlib.nullcontext():
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = gnn_loss(params, cell.args[1], cfg)
        grads = torch.autograd.grad(loss, leaves)
        if env is not None:
            loss = loss.full_tensor()
            grads = [sharding.redistribute(g, p.placements).full_tensor()
                     for g, p in zip(grads, leaves)]
    return [t.detach().numpy() for t in [loss, *grads]]


def gnn_rank(mesh, path: str) -> dict:
    """A rank: every architecture and shape on (data 2, model 2) and
    (data 4, model 1), GAT's control on (data 2, model 2); rank 0 also on
    its own one-rank mesh."""
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
    out = {(a, m, s): _port_step(a, states[a, s], s, AxisEnv(meshes[m]))
           for a in ARCHS for m in MESHES for s in SHAPES}
    with unsummed_denominators(1):
        out["control"] = _port_step("gat-cora", states["gat-cora", SHAPES[0]], SHAPES[0],
                                    AxisEnv(mesh))
    out["mean"] = _mean_loss_grads(AxisEnv(mesh))
    if rank == 0:
        out.update({(a, "one", s): _port_step(a, states[a, s], s, AxisEnv(one))
                    for a in ARCHS for s in SHAPES})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    states, ref, port = {}, {}, {}
    for a in ARCHS:
        for s in SHAPES:
            j = jcells.build_cell(a, s, concrete=True, smoke=True)
            states[a, s] = jax.tree.map(np.asarray, j.args[0])
            for m, shp in MESHES.items():
                ref[a, m, s] = _jax_gspmd(j, shp)
            port[a, s] = _port_step(a, states[a, s], s)
    path = tmp_path_factory.mktemp("gnn_sharded") / "states.pkl"
    path.write_bytes(pickle.dumps(states))
    ranks = spawn(gnn_rank, 4, device="cpu", args=(str(path),), timeout=TIMEOUT,
                  mesh_shape={"data": 2, "model": 2})
    return {"ref": ref, "port": port, "ranks": ranks}


def _close(got: dict, want: dict, what: str) -> None:
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=f"{what} {k}")
    assert got["lr"] == want["lr"], what
    assert_params_close(got["params"], want["params"], want["lr"], what)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_repro_gspmd(runs, arch, mesh, shape):
    for r, got in enumerate(runs["ranks"]):
        _close(got[arch, mesh, shape], runs["ref"][arch, mesh, shape],
               f"{arch} {mesh} {shape} rank {r}")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_port_unsharded(runs, arch, mesh, shape):
    """Every rank holds the same replicated result, within RTOL of the
    port's unsharded step."""
    ranks = runs["ranks"]
    for r, got in enumerate(ranks):
        _close(got[arch, mesh, shape], runs["port"][arch, shape], f"{arch} {mesh} {shape} "
                                                                  f"rank {r}")
        for k, v in got[arch, mesh, shape]["params"].items():
            assert np.array_equal(v, ranks[0][arch, mesh, shape]["params"][k]), (arch, mesh, r, k)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_mesh_gives_the_unsharded_bits(runs, arch, shape):
    got, want = runs["ranks"][0][arch, "one", shape], runs["port"][arch, shape]
    assert (got["loss"], got["grad_norm"]) == (want["loss"], want["grad_norm"])
    for k, v in want["params"].items():
        assert np.array_equal(got["params"][k], v), (arch, shape, k)


def test_unsummed_denominators_control_fails(runs):
    """GAT with rank 1's softmax denominators left unsummed over the edge
    group falls outside the tolerances on every rank."""
    want = runs["port"]["gat-cora", SHAPES[0]]
    for r, got in enumerate(runs["ranks"]):
        with pytest.raises(AssertionError):
            _close(got["control"], want, f"control rank {r}")


def test_mean_aggregator_matches_unsharded(runs):
    """MeshGraphNet with a ``mean`` aggregator on (data 2, model 2): the
    counts summed over the edge group before the division; the loss and
    every gradient within RTOL of the unsharded ones (scaled by the
    leaf's largest)."""
    want = _mean_loss_grads()
    for r, got in enumerate(runs["ranks"]):
        for i, (a, b) in enumerate(zip(got["mean"], want)):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=RTOL * np.abs(b).max(),
                                       err_msg=f"rank {r} leaf {i}")


def _grads_and_saved(arch: str, remat: bool) -> tuple[list, int]:
    """The unsharded smoke cell's loss gradients (the reference's
    rematerialisation on or off) and the bytes the forward saved for the
    backward."""
    from repro_torch.launch.cells import build_cell
    from repro_torch.models import gnn

    cell = build_cell(arch, "full_graph_sm", concrete=True, smoke=True, device="cpu")
    params, g = cell.args[0].params, cell.args[1]
    leaves = pytree.leaves(params)
    saved = [0]

    def pack(t):
        saved[0] += t.numel() * t.element_size()
        return t

    remat_fn = gnn._remat
    if not remat:
        gnn._remat = lambda fn, *args: fn(*args)
    try:
        with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            for p in leaves:
                p.requires_grad_(True)
            loss, _ = gnn.gnn_loss(params, g, tconfigs.get_smoke_config(arch))
        grads = torch.autograd.grad(loss, leaves)
    finally:
        gnn._remat = remat_fn
    return [loss.detach()] + list(grads), saved[0]


@pytest.mark.parametrize("arch", ["meshgraphnet", "dimenet"])
def test_remat_keeps_the_bits(arch):
    """MeshGraphNet's processor step and DimeNet's interaction block run
    under ``torch.utils.checkpoint`` as the reference's ``jax.checkpoint``:
    the loss and every gradient the same bits as without it, the forward
    storing less."""
    got, saved = _grads_and_saved(arch, remat=True)
    want, saved_plain = _grads_and_saved(arch, remat=False)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), (arch, i)
    assert saved < saved_plain, (saved, saved_plain)
