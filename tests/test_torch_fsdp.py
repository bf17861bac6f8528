"""The port's dense LM train step sharded on a ``DeviceMesh`` with FSDP
(``repro_torch.launch.cells.shard_cell`` on a train cell: the state's
parameters, ``m`` and ``v`` as DTensors in the reference's
``lm_param_logical(fsdp=True)`` layout) on the CPU, against the port
unsharded and against ``repro``'s ``make_train_step``.

One :func:`repro_torch.dist.spawn` of four ``gloo`` ranks on a ``(data 2,
model 2)`` mesh trains ``qwen3-14b-smoke`` (float32) two steps of two
microbatches, without and with int8 compression; saves the sharded state
and restores it onto a two-rank mesh (``ft.replan``'s ``MeshPlan``), which
takes a third step; checks K3's ``FlashAttention`` Function under
``local_map`` with the q heads sharded against autograd of the dense
reference; and the gradient of the all-to-all gather against DTensor's
all-gather.  Rank 0 also trains on its own one-rank group's ``(data 1,
model 1)`` mesh, which must give the unsharded step's bits.

Weights are the port's seeded draw, carried to ``repro`` as numpy
(``convert.train_state_to_numpy``); the batch is numpy from a seed.
Tolerances (those of ``tests/test_torch_train.py``, and why): loss and
``grad_norm`` at rtol 1e-5 (the ranks add their partial products, their
gradients' reduce-scatters and the norm's all-reduce in another order:
measured within 3e-7); every updated parameter within 1 % of a step
(``lr / 100``) but for at most 2 elements of a leaf or a share of them
(``ODD_SHARE``, 1e-3; 5e-3 with compression): Adam moves an element by
about ``lr * sign(g)``, and where ``g`` is near 0 a last-bit difference
flips the sign (measured: at most 1 element a leaf).
K3's gradients: within 1e-5 of the largest ``|grad|``.

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
from repro_torch.dist import spawn  # noqa: E402

if multiprocessing.parent_process() is None:  # not in a spawned rank
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as j_get_smoke_config
    from repro.ft import checkpoint as jckpt
    from repro.models import transformer as jtf
    from repro.train import optimizer as jopt
    from repro.train.train_step import make_train_step as j_make_train_step

ARCH = "qwen3-14b"
B, S, MICRO = 4, 32, 2
ADAM = dict(lr=1e-2, warmup_steps=1, grad_clip=1.0)
N_STEPS = 2
RTOL = 1e-5
STEP_TOL = 1e-2  # of lr
ODD_SHARE = {False: 1e-3, True: 5e-3}
GRAD_TOL = 1e-5
TIMEOUT = 240
BATCH_LOGICAL = {"tokens": ("batch", None), "labels": ("batch", None)}


def _cfg():
    return tconfigs.get_smoke_config(ARCH)


def _step(compress: bool):
    from repro_torch.models import lm_loss
    from repro_torch.train import AdamConfig, make_train_step

    return make_train_step(lambda m, b: lm_loss(m, b["tokens"], b["labels"]),
                           AdamConfig(**ADAM), microbatches=MICRO, compress=compress,
                           batch_logical=BATCH_LOGICAL)


def _state(params_np, compress: bool):
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.train import init_train_state

    return init_train_state(lm_params_from_numpy(params_np, _cfg(), device="cpu"), compress)


def _batch(inp) -> dict:
    return {k: torch.from_numpy(v) for k, v in inp.items()}


def _numpy(state) -> dict:
    """Every leaf of a (sharded or plain) LM state, whole, by the port's
    names: ``params``, ``m``, ``v`` (and ``err``)."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.dist.sharding import redistribute

    def whole(t):
        if isinstance(t, DTensor):
            t = redistribute(t.detach(), [Replicate()] * t.device_mesh.ndim).to_local()
        return t.detach().numpy().copy()

    out = {"params": {n: whole(p) for n, p in state.params.named_parameters()}}
    for k in ("m", "v", "err"):
        if getattr(state, k) is not None:
            out[k] = {n: whole(t) for n, t in getattr(state, k).items()}
    return out


def _sharded_run(mesh, params_np, inp, compress: bool, steps: int = N_STEPS, ckdir=None):
    """``steps`` sharded train steps on ``mesh`` through ``shard_cell``:
    the metrics, the final state whole, and whether every leaf of the
    state is a DTensor placed as its parameter holding only its shard;
    with ``ckdir``, the state saved there after the last step."""
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.dist.sharding import AxisEnv, use_axis_env
    from repro_torch.ft import save_pytree
    from repro_torch.launch.cells import build_cell, shard_cell

    env = AxisEnv(mesh)
    cell = build_cell(ARCH, "train_4k", smoke=True, concrete=True, device="cpu")
    cell = shard_cell(dataclasses.replace(cell, args=(_state(params_np, compress),
                                                      _batch(inp))), env)
    state, batch = cell.args
    step, metrics = _step(compress), []
    with use_axis_env(env):
        for _ in range(steps):
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        if ckdir is not None:
            save_pytree(state, ckdir, steps)
    placed = []
    for n, p in state.params.named_parameters():
        split = np.prod([mesh.size(i) for i, pl in enumerate(p.placements)
                         if isinstance(pl, Shard)])
        for t in [p] + [getattr(state, k)[n] for k in ("m", "v", "err")
                        if getattr(state, k) is not None]:
            placed.append(isinstance(t, DTensor) and t.placements == p.placements
                          and t.to_local().numel() * split == t.numel())
    return {"metrics": metrics, "state": _numpy(state), "placed": all(placed),
            "n_placed": len(placed)}


def _k3_heads_sharded(mesh) -> dict:
    """K3's Function under ``local_map``, q [B, S, Hq, D] with its batch on
    ``data`` and its heads on ``model``, k and v whole but for the batch:
    dq, dk, dv (gathered) and the largest error over the largest |grad|
    against autograd of ``attention_ref`` on the whole tensors."""
    from torch.distributed.tensor import Replicate

    from repro_torch.dist.sharding import AxisEnv, place, redistribute, use_axis_env
    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.models.attention import flash_attention

    g = torch.Generator().manual_seed(3)
    mk = lambda *s: torch.randn(s, generator=g)
    q, k, v, do = mk(2, 40, 8, 16), mk(2, 40, 2, 16), mk(2, 40, 2, 16), mk(2, 40, 8, 16)
    with torch.enable_grad(), use_axis_env(AxisEnv(mesh)):
        qs = place(q, "batch", None, "model", None).requires_grad_(True)
        ks, vs = (place(t, "batch", None, None, None).requires_grad_(True) for t in (k, v))
        o = flash_attention(qs, ks, vs, q_block=16, kv_block=16)
        got = torch.autograd.grad(o, (qs, ks, vs), place(do, "batch", None, "model", None))
        placements = [str(t.placements) for t in got]
        got = [redistribute(t, [Replicate()] * mesh.ndim).to_local() for t in got]
    ref = [t.permute(0, 2, 1, 3).clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(attention_ref(*ref), ref, do.permute(0, 2, 1, 3))
    errs = {n: float((a.permute(0, 2, 1, 3) - w).abs().max() / w.abs().max())
            for n, a, w in zip(("dq", "dk", "dv"), got, want)}
    return {"errs": errs, "placements": placements}


def _gather_gradient(mesh) -> dict:
    """The all-to-all gather's gradient against DTensor's all-gather's:
    a weight sharded on ``data`` gathered whole and multiplied by a
    batch-sharded input, so that its gradient is a partial sum over the
    batch shards, reduce-scattered back into the weight's placements."""
    from torch.distributed.tensor import Replicate

    from repro_torch.dist import sharding

    g = torch.Generator().manual_seed(5)
    w0, x0 = torch.randn(8, 6, generator=g), torch.randn(4, 8, generator=g)
    out = {}
    with torch.enable_grad(), sharding.use_axis_env(sharding.AxisEnv(mesh)):
        x = sharding.place(x0, "batch", None)
        for name in ("all_to_all", "all_gather"):
            w = sharding.place(w0, "fsdp", "model").requires_grad_(True)
            whole = [Replicate(), w.placements[1]]
            wg = (sharding._gather_by_all_to_all(w, 0) if name == "all_to_all"
                  else w.redistribute(w.device_mesh, whole))
            assert tuple(wg.placements) == tuple(whole)
            (gw,) = torch.autograd.grad(((x @ wg) ** 2).sum(), (w,))
            out[name] = (str(gw.placements), gw.full_tensor().numpy())
    w = w0.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(((x0 @ w) ** 2).sum(), (w,))
    out["plain"] = want.numpy()
    return out


def fsdp_rank(mesh, path: str, ckdir: str) -> dict:
    """A rank: the sharded runs on ``mesh`` (the weights and batch read
    from ``path``), the checkpoint's save on it and restore onto a
    two-rank mesh, rank 0's one-rank mesh runs, the K3 and gather
    checks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.dist.sharding import AxisEnv, use_axis_env
    from repro_torch.ft import load_pytree, replan
    from repro_torch.launch.cells import build_cell

    torch.set_num_threads(1)  # the ranks share the host's cores
    with open(path, "rb") as f:
        params_np, inp = pickle.load(f)
    rank = dist.get_rank()
    out = {"four": {c: _sharded_run(mesh, params_np, inp, c, ckdir=None if c else ckdir)
                    for c in (False, True)}}
    # the elastic restart: the state saved on four ranks, restored onto
    # replan's two-rank (data 2, model 1) mesh, one step more
    plan = replan(2, 1, B)
    two = plan.mesh.device_mesh("cpu")
    if rank < 2:
        like = build_cell(ARCH, "train_4k", smoke=True)
        env = AxisEnv(two)
        state = load_pytree(like.args[0], ckdir, env=env, logical=like.in_logical[0])
        restored = _numpy(state)
        with use_axis_env(env):
            state, m = _step(False)(state, _batch(inp))
        out["restored"] = {"mesh": dict(zip(two.mesh_dim_names, two.shape)),
                           "state_at_save": restored, "metrics": {k: float(v) for k, v in m.items()},
                           "state": _numpy(state)}
    own = [dist.new_group([r]) for r in range(dist.get_world_size())][rank]
    if rank == 0:
        one = DeviceMesh.from_group([own, own], "cpu", mesh=torch.tensor([[rank]]),
                                    mesh_dim_names=("data", "model"))
        out["one"] = {c: _sharded_run(one, params_np, inp, c) for c in (False, True)}
    out["k3"] = _k3_heads_sharded(mesh)
    out["gather"] = _gather_gradient(mesh)
    return out


# ---------------------------------------------------------------------------
# the parent: the port unsharded, repro, the spawn
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.convert import train_state_to_numpy
    from repro_torch.models import TransformerLM
    from repro_torch.train import init_train_state

    torch.set_num_threads(1)
    cfg, jcfg = _cfg(), j_get_smoke_config(ARCH)
    model = TransformerLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    params_np = train_state_to_numpy(init_train_state(model)).params
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    inp = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    port = {}
    for compress in (False, True):
        state, step, metrics = _state(params_np, compress), _step(compress), []
        for i in range(N_STEPS + (0 if compress else 1)):
            state, m = step(state, _batch(inp))
            metrics.append({k: float(v) for k, v in m.items()})
            if i == N_STEPS - 1:
                port[compress] = {"metrics": metrics[:N_STEPS], "state": _numpy(state)}
        if not compress:
            port["third"] = {"metrics": metrics[-1], "state": _numpy(state)}
    step_j = jax.jit(j_make_train_step(lambda p, b: jtf.lm_loss(p, b["t"], b["l"], jcfg),
                                       jopt.AdamConfig(**ADAM), microbatches=MICRO))
    st_j = jax.tree.map(jnp.asarray, jopt.init_train_state(params_np))
    ref = []
    for _ in range(N_STEPS):
        st_j, m_j = step_j(st_j, {"t": jnp.asarray(tokens), "l": jnp.asarray(inp["labels"])})
        ref.append({k: float(v) for k, v in m_j.items()})
    path = tmp_path_factory.mktemp("fsdp") / "inputs.pkl"
    path.write_bytes(pickle.dumps((params_np, inp)))
    ckdir = tmp_path_factory.mktemp("fsdp_ck")
    ranks = spawn(fsdp_rank, 4, device="cpu", args=(str(path), str(ckdir)), timeout=TIMEOUT,
                  mesh_shape={"data": 2, "model": 2})
    return {"port": port, "ref": {"metrics": ref, "state": jax.tree.map(np.asarray, st_j)},
            "ranks": ranks, "ckdir": str(ckdir), "jcfg": jcfg, "params_np": params_np}


def _metrics_close(got: list[dict], want: list[dict], what: str, keys=("loss", "grad_norm",
                                                                      "lr")) -> None:
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        for k in keys:
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, err_msg=f"{what} step {i} {k}")


def _params_close(got: dict, want: dict, what: str, compress: bool = False) -> None:
    """Within 1 % of a step but for a few elements (module docstring)."""
    lr = ADAM["lr"]
    assert set(got) == set(want), what
    for n, w in want.items():
        d = np.abs(np.asarray(got[n], np.float64) - np.asarray(w, np.float64))
        odd = int((d > STEP_TOL * lr).sum())
        assert odd <= max(2, ODD_SHARE[compress] * d.size), f"{what} {n}: {odd} of {d.size}"


@pytest.mark.parametrize("compress", [False, True], ids=["plain", "compress"])
def test_sharded_train_matches_unsharded_port(runs, compress):
    """Four ranks on (data 2, model 2), two steps of two microbatches:
    loss, grad_norm and lr on every rank, and every updated parameter,
    against the port's unsharded step."""
    want = runs["port"][compress]
    for r, rank in enumerate(runs["ranks"]):
        got = rank["four"][compress]
        _metrics_close(got["metrics"], want["metrics"], f"rank {r}")
        _params_close(got["state"]["params"], want["state"]["params"], f"rank {r}", compress)


def test_sharded_train_matches_repro(runs):
    """The same two sharded steps against ``repro``'s jitted
    ``make_train_step`` (GSPMD's step, here on one device) on the same
    weights and batch."""
    from repro_torch.convert import train_state_from_numpy

    ref = runs["ref"]
    got = runs["ranks"][0]["four"][False]
    _metrics_close(got["metrics"], ref["metrics"], "vs repro")
    ref_params = dict(train_state_from_numpy(ref["state"], _cfg(), "cpu").params
                      .named_parameters())
    _params_close(got["state"]["params"], {n: p.detach().numpy()
                                           for n, p in ref_params.items()}, "vs repro")


def test_sharded_state_is_placed_as_its_parameters(runs):
    """After the steps, every parameter, ``m``, ``v`` (and ``err``) leaf is
    a DTensor in its parameter's placements, and each rank holds only its
    shard of it."""
    for rank in runs["ranks"]:
        for compress in (False, True):
            got = rank["four"][compress]
            assert got["placed"] and got["n_placed"] > 0, compress


@pytest.mark.parametrize("compress", [False, True], ids=["plain", "compress"])
def test_one_rank_mesh_is_bit_identical(runs, compress):
    """Rank 0 alone on (data 1, model 1): the loss, grad_norm, lr and every
    leaf of the state after two steps are the unsharded step's bits."""
    got, want = runs["ranks"][0]["one"][compress], runs["port"][compress]
    assert got["metrics"] == want["metrics"]
    assert set(got["state"]) == set(want["state"])
    for tree, leaves in want["state"].items():
        for n, w in leaves.items():
            assert np.array_equal(got["state"][tree][n], w), (compress, tree, n)


def test_k3_function_under_local_map_heads_sharded(runs):
    """K3's Function under ``local_map`` with the q heads sharded on
    ``model`` and the batch on ``data``: dq keeps q's placements, dk and
    dv (partial sums over the head shards, reduce-scattered by their
    gather's backward) and dq within GRAD_TOL of autograd of the dense
    reference."""
    for rank in runs["ranks"]:
        k3 = rank["k3"]
        assert k3["placements"][0] == "(Shard(dim=0), Shard(dim=2))"
        assert max(k3["errs"].values()) <= GRAD_TOL, k3["errs"]


def test_gather_by_all_to_all_gradient(runs):
    """The all-to-all gather's gradient is DTensor's all-gather's: the
    same placements (the weight's) and values, and the plain gradient."""
    for rank in runs["ranks"]:
        (pa, a), (pg, g) = rank["gather"]["all_to_all"], rank["gather"]["all_gather"]
        assert pa == pg == "(Shard(dim=0), Shard(dim=1))"
        np.testing.assert_allclose(a, g, rtol=1e-6)
        np.testing.assert_allclose(a, rank["gather"]["plain"], rtol=1e-5)


def test_checkpoint_restores_onto_another_mesh(runs):
    """The state saved by four ranks after two steps, restored onto
    ``replan``'s two-rank mesh: the saved state exactly (each rank read
    its shards), and a third step that matches the unsharded third step."""
    want = runs["port"]["third"]
    saved = runs["ranks"][0]["four"][False]["state"]
    for r in (0, 1):
        got = runs["ranks"][r]["restored"]
        assert got["mesh"] == {"data": 2, "model": 1}
        for tree, leaves in saved.items():
            for n, w in leaves.items():
                assert np.array_equal(got["state_at_save"][tree][n], w), (r, tree, n)
        _metrics_close([got["metrics"]], [want["metrics"]], f"rank {r} third step")
        _params_close(got["state"]["params"], want["state"]["params"], f"rank {r} third")
    assert "restored" not in runs["ranks"][2] and "restored" not in runs["ranks"][3]


def test_repro_reads_the_sharded_checkpoint(runs):
    """``repro``'s ``load_pytree`` restores the four ranks' float32
    checkpoint into its own ``TrainState``: the saved state's values."""
    from repro_torch.convert import train_state_from_numpy

    like = jax.tree.map(jnp.asarray, jopt.init_train_state(runs["params_np"]))
    loaded = jckpt.load_pytree(like, runs["ckdir"])
    assert int(loaded.step) == N_STEPS
    state = train_state_from_numpy(jax.tree.map(np.asarray, loaded), _cfg(), "cpu")
    saved = runs["ranks"][0]["four"][False]["state"]
    for n, p in state.params.named_parameters():
        assert np.array_equal(p.detach().numpy(), saved["params"][n]), n
    for n, t in state.m.items():
        assert np.array_equal(t.numpy(), saved["m"][n]), n
