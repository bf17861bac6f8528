"""``repro_torch.ft``'s checkpoints of sharded states on the CPU: one
:func:`repro_torch.dist.spawn` of two ``gloo`` ranks on (data 2, model 1)
runs a train step of three smoke cells through ``shard_cell`` (qwen3-14b
with FSDP, gcn-cora, two-tower-retrieval with its tables on ``rows``),
saves each state three times with a ``CheckpointManager`` (keep 2,
every rank calling it, each writing only its own shards), updates the
state in place right after each save, and restores the last step onto
(data 1, model 2) and onto one device.

Everything is compared bit for bit: a restore gives the state as it was
when ``maybe_save`` returned, and ``repro``'s own ``load_pytree`` reads
the two-tower and the LM checkpoints whole (with no mesh).

Spawned ranks import this file for its rank functions only: the ``if``
below keeps ``jax`` and ``repro`` out of them.
"""

from __future__ import annotations

import multiprocessing
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import pytree  # noqa: E402
from repro_torch.dist import spawn  # noqa: E402

if multiprocessing.parent_process() is None:  # not in a spawned rank
    import jax
    import jax.numpy as jnp

    from repro.ft import checkpoint as jckpt
    from repro.models import transformer as jtf
    from repro.models import two_tower as jtt
    from repro.train import optimizer as jopt

CELLS = {"lm": ("qwen3-14b", "train_4k"), "gnn": ("gcn-cora", "full_graph_sm"),
         "tt": ("two-tower-retrieval", "train_batch")}
STEPS = (1, 2, 3)
KEEP = 2
TIMEOUT = 240


def _leaves(state) -> dict:
    """``{keystr: numpy array}`` of every leaf of a state, DTensors whole."""
    from torch.distributed.tensor import DTensor

    out = {}
    for path, x in pytree.leaves_with_path(state):
        if isinstance(x, DTensor):
            x = x.full_tensor()
        out[pytree.keystr(path)] = x.detach().cpu().numpy().copy()
    return out


def ck_rank(mesh, ckdir: str) -> dict:
    """A rank: each cell stepped once on ``mesh``, saved three times by a
    manager (the state bumped in place after each save), then restored
    onto (data 1, model 2) and onto the CPU alone."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor

    from repro_torch.dist.sharding import AxisEnv, use_axis_env
    from repro_torch.ft import CheckpointManager, load_pytree
    from repro_torch.launch.cells import build_cell, shard_cell

    torch.set_num_threads(1)  # the ranks share the host's cores
    env = AxisEnv(mesh)
    other = AxisEnv(DeviceMesh("cpu", torch.arange(dist.get_world_size()).reshape(1, 2),
                               mesh_dim_names=("data", "model")))
    out = {}
    for tag, (arch, shape) in CELLS.items():
        cell = shard_cell(build_cell(arch, shape, concrete=True, smoke=True, device="cpu"), env)
        with use_axis_env(env):
            state, _ = cell.fn(*cell.args)
        d = os.path.join(ckdir, tag)
        mgr = CheckpointManager(d, keep=KEEP, every_steps=1)
        saved = {}
        for s in STEPS:
            assert mgr.maybe_save(state, s)
            saved[s] = _leaves(state)
            with torch.no_grad():  # the next step's update, in place, at once
                for x in pytree.leaves(state):
                    if isinstance(x, DTensor):
                        x.to_local().add_(1.0)
        mgr.wait()
        mgr.check()
        mgr.close()
        like = build_cell(arch, shape, smoke=True)  # the structure, on meta
        restored = load_pytree(like.args[0], d, env=other, logical=like.in_logical[0])
        split = [pytree.keystr(p) for p, x in pytree.leaves_with_path(restored)
                 if isinstance(x, DTensor) and x.to_local().shape != x.shape]
        out[tag] = {"saved": saved[STEPS[-1]], "steps": sorted(os.listdir(d)),
                    "other_mesh": _leaves(restored), "split_on_other": split,
                    "one_device": _leaves(load_pytree(like.args[0], d, device="cpu"))}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ckdir = tmp_path_factory.mktemp("ck_sharded")
    ranks = spawn(ck_rank, 2, device="cpu", args=(str(ckdir),), timeout=TIMEOUT,
                  mesh_shape={"data": 2, "model": 1})
    return {"ranks": ranks, "ckdir": ckdir}


def _equal(got: dict, want: dict, what: str) -> None:
    assert got.keys() == want.keys(), (what, sorted(got.keys() ^ want.keys()))
    for k, w in want.items():
        assert got[k].dtype == w.dtype and np.array_equal(got[k], w), (what, k)


@pytest.mark.parametrize("tag", list(CELLS))
def test_restore_onto_another_mesh_and_one_device(runs, tag):
    """Both ranks restore the state as it was at the last save, bit for
    bit, on (data 1, model 2) (the tables and the FSDP leaves split over
    ``model``) and on the CPU alone; the in-place update after
    ``maybe_save`` reached no saved step."""
    for r, got in enumerate(runs["ranks"]):
        g = got[tag]
        _equal(g["other_mesh"], g["saved"], f"{tag} rank {r} other mesh")
        _equal(g["one_device"], g["saved"], f"{tag} rank {r} one device")
        if tag != "gnn":
            assert g["split_on_other"], (tag, r)
        _equal(g["saved"], runs["ranks"][0][tag]["saved"], f"{tag} rank {r} vs rank 0")


@pytest.mark.parametrize("tag", list(CELLS))
def test_keep_holds_across_ranks(runs, tag):
    want = [f"step_{s:08d}" for s in STEPS[-KEEP:]]
    for got in runs["ranks"]:
        assert got[tag]["steps"] == want
    assert sorted(os.listdir(runs["ckdir"] / tag)) == want


def _jax_state(tag: str):
    from repro.configs import get_smoke_config

    arch = CELLS[tag][0]
    cfg = get_smoke_config(arch)
    key = jax.random.PRNGKey(0)
    params = (jtf.init_lm_params(key, cfg) if tag == "lm" else jtt.init_two_tower_params(key, cfg))
    return jopt.init_train_state(params), tconfigs.get_smoke_config(arch)


@pytest.mark.parametrize("tag", ["lm", "tt"])
def test_repro_reads_the_sharded_checkpoint(runs, tag):
    """``repro``'s ``load_pytree`` restores the two ranks' checkpoint into
    its own ``TrainState``, with no mesh: the saved state's values."""
    from repro_torch.convert import train_state_from_numpy

    like, cfg = _jax_state(tag)
    loaded = jax.tree.map(np.asarray, jckpt.load_pytree(jax.tree.map(jnp.asarray, like),
                                                        str(runs["ckdir"] / tag)))
    assert int(loaded.step) == 1
    got = _leaves(train_state_from_numpy(loaded, cfg, "cpu"))
    _equal(got, runs["ranks"][0][tag]["saved"], f"{tag} read by repro")
