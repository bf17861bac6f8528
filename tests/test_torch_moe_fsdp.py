"""The port's MoE LM train step sharded on a ``DeviceMesh`` with FSDP
(``repro_torch.launch.cells.shard_cell`` on a MoE train cell: the state's
parameters, ``m`` and ``v`` as DTensors in the reference's
``lm_param_logical(fsdp=True)`` layout, the experts on ``expert`` and
their ``D`` on ``fsdp``, the tokens on ``batch``) on the CPU, against the
port unsharded and against ``repro``'s ``make_train_step``.

One :func:`repro_torch.dist.spawn` of four ``gloo`` ranks builds every
case's mesh over the same world, and each case trains two steps of two
microbatches:

* ``olmoe``: ``olmoe-1b-7b-smoke`` on (data 2, model 2): the router, the
  attention and the experts' ``D`` split on ``data``, the experts on
  ``model``, each data shard's token blocks routed on its ranks;
* ``mixtral_halves``: ``mixtral-8x7b-smoke`` with 2 experts of
  ``virtual_split`` 2 on (data 1, model 4): four virtual experts, one a
  rank, so each rank holds half an expert and the pair sum's all-reduce
  runs, forward and backward; ``m`` and ``v`` are unfolded as the
  parameters are;
* ``olmoe_no_ep``: ``olmoe-1b-7b-smoke`` with ``expert_parallel=False`` on
  (data 2, model 2): every expert on every rank, ``F`` split on
  ``model``, the products' partial sums all-reduced and the buffer's
  gradient a partial sum over the ``F`` shards;
* ``one``: rank 0 alone on its own one-rank (data 1, model 1) mesh,
  olmoe: the unsharded step's bits.

Besides: the gradient of the aux loss alone (the NLL's weight 0) on the
olmoe mesh against autograd of the unsharded port's aux: each rank's
tokens take the replicated loss's gradient once (an all-reduce in the
probability sums' backward would double it on data 2); the mixtral state
saved by the four ranks after two steps, restored onto ``replan``'s
two-rank (data 2, model 1) mesh, where a third step matches the unsharded
third step, and read by ``repro``'s ``load_pytree``.

Weights are the port's seeded draw, carried to ``repro`` as numpy
(``convert.train_state_to_numpy``: the reference's unfolded layout); the
batch is numpy from a seed.  Tolerances (``tests/test_torch_fsdp.py``'s,
and why): loss, aux and ``grad_norm`` at rtol 1e-5 (the ranks add their
partial products, the aux loss's sums, their gradients' reduce-scatters
and the norm's all-reduce in another order); every updated parameter
within 1 % of a step (``lr / 100``) but for at most 2 elements of a leaf
or a share of them (``ODD_SHARE``, 1e-3): Adam moves an element by about
``lr * sign(g)``, and where ``g`` is near 0 a last-bit difference flips
the sign.  The aux gradient: within ``GRAD_TOL`` (1e-5) of the largest
``|grad|`` of its leaf.

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

# case -> (arch, MoESpec overrides, mesh)
CASES = {"olmoe": ("olmoe-1b-7b", {}, {"data": 2, "model": 2}),
         "mixtral_halves": ("mixtral-8x7b", {"n_experts": 2}, {"data": 1, "model": 4}),
         "olmoe_no_ep": ("olmoe-1b-7b", {"expert_parallel": False}, {"data": 2, "model": 2})}
CKPT_CASE = "mixtral_halves"
B, S, MICRO = 4, 32, 2
ADAM = dict(lr=1e-2, warmup_steps=1, grad_clip=1.0)
N_STEPS = 2
RTOL = 1e-5
STEP_TOL = 1e-2  # of lr
ODD_SHARE = 1e-3
GRAD_TOL = 1e-5
TIMEOUT = 300
BATCH_LOGICAL = {"tokens": ("batch", None), "labels": ("batch", None)}
METRICS = ("loss", "aux", "grad_norm", "lr")


def _cfg(case: str, get=None):
    arch, over, _ = CASES[case]
    cfg = (get or tconfigs.get_smoke_config)(arch)
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **over))


def _step():
    from repro_torch.models import lm_loss
    from repro_torch.train import AdamConfig, make_train_step

    return make_train_step(lambda m, b: lm_loss(m, b["tokens"], b["labels"]),
                           AdamConfig(**ADAM), microbatches=MICRO,
                           batch_logical=BATCH_LOGICAL)


def _state(case: str, params_np):
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.train import init_train_state

    return init_train_state(lm_params_from_numpy(params_np, _cfg(case), device="cpu"))


def _batch(inp) -> dict:
    return {k: torch.from_numpy(v) for k, v in inp.items()}


def _numpy(state) -> dict:
    """Every leaf of a (sharded or plain) LM state, whole and in the
    port's folded layout, by the port's names: ``params``, ``m``, ``v``."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.convert import fold_experts
    from repro_torch.dist.sharding import redistribute

    moe = state.params.cfg.moe

    def whole(name, t):
        if isinstance(t, DTensor):
            t = redistribute(t.detach(), [Replicate()] * t.device_mesh.ndim).to_local()
        leaf = name.rpartition(".")[2]
        if leaf in ("w_gate", "w_up", "w_down") and t.shape[0] != moe.n_experts:
            t = fold_experts(leaf, t, moe.virtual_split)
        return t.detach().numpy().copy()

    out = {"params": {n: whole(n, p) for n, p in state.params.named_parameters()}}
    for k in ("m", "v"):
        out[k] = {n: whole(n, t) for n, t in getattr(state, k).items()}
    return out


def _metrics(m: dict) -> dict:
    return {k: float(m[k]) for k in METRICS}


def _placed(state, mesh) -> bool:
    """Every parameter, ``m`` and ``v`` leaf a DTensor placed as its
    parameter, holding only its shard."""
    from torch.distributed.tensor import DTensor, Shard

    ok = []
    for n, p in state.params.named_parameters():
        split = np.prod([mesh.size(i) for i, pl in enumerate(p.placements)
                         if isinstance(pl, Shard)])
        for t in (p, state.m[n], state.v[n]):
            ok.append(isinstance(t, DTensor) and t.placements == p.placements
                      and t.shape == p.shape and t.to_local().numel() * split == t.numel())
    return bool(ok) and all(ok)


def _sharded_run(case: str, mesh, params_np, inp, ckdir=None):
    """``N_STEPS`` sharded train steps of ``case`` on ``mesh`` through
    ``shard_cell``: the metrics, the final state whole, whether every leaf
    is placed as its parameter; with ``ckdir``, the state saved there."""
    from repro_torch.dist.sharding import AxisEnv, use_axis_env
    from repro_torch.ft import save_pytree
    from repro_torch.launch.cells import build_cell, lm_param_logical, shard_cell

    env = AxisEnv(mesh)
    cfg = _cfg(case)
    cell = build_cell(CASES[case][0], "train_4k", smoke=True)
    logical = dataclasses.replace(cell.in_logical[0], **{
        k: lm_param_logical(cfg, fsdp=True) for k in ("params", "m", "v")})
    cell = shard_cell(dataclasses.replace(cell, args=(_state(case, params_np), _batch(inp)),
                                          in_logical=(logical, cell.in_logical[1])), env)
    state, batch = cell.args
    step, metrics = _step(), []
    with use_axis_env(env):
        for _ in range(N_STEPS):
            state, m = step(state, batch)
            metrics.append(_metrics(m))
        if ckdir is not None:
            save_pytree(state, ckdir, N_STEPS)
    return {"metrics": metrics, "state": _numpy(state), "placed": _placed(state, mesh)}


def _aux_grads(mesh, params_np, inp) -> dict:
    """The gradient of the aux loss alone (``forward``'s aux) on ``mesh``
    through ``shard_cell``'s olmoe state, every leaf gathered whole."""
    from torch.distributed.tensor import Replicate

    from repro_torch.dist.sharding import AxisEnv, redistribute, shard_tree, use_axis_env
    from repro_torch.launch.cells import build_cell, shard_cell
    from repro_torch.models import forward
    from repro_torch.train.train_step import _grads

    env = AxisEnv(mesh)
    cell = build_cell(CASES["olmoe"][0], "train_4k", smoke=True)
    cell = shard_cell(dataclasses.replace(cell, args=(_state("olmoe", params_np),
                                                      _batch(inp))), env)
    model = cell.args[0].params
    with use_axis_env(env):
        batch = shard_tree(_batch(inp), BATCH_LOGICAL)
        _, _, grads = _grads(lambda m, b: (forward(m, b["tokens"])[1], {}), model, batch)
        grads = [redistribute(g, [Replicate()] * mesh.ndim).to_local() for g in grads]
    return dict(zip(sorted(dict(model.named_parameters())), (g.numpy() for g in grads)))


def _gloo_gathers(mesh) -> dict:
    """A constraint that slices a whole tensor over ``model``, whose
    backward all-gathers the gradient (DTensor's own gather), without and
    with ``GlooGathers(cpu=True)``: the gradient and the collectives'
    calls by kind."""
    from contextlib import nullcontext

    from repro_torch.dist import sharding

    x0 = torch.randn(8, 6, generator=torch.Generator().manual_seed(7))
    out = {}
    with torch.enable_grad(), sharding.use_axis_env(sharding.AxisEnv(mesh)):
        for mode in (False, True):
            x = sharding.place(x0, None, None).requires_grad_(True)
            with sharding.LocalCost() as cost, (sharding.GlooGathers(cpu=True) if mode
                                                else nullcontext()):
                y = sharding.constrain(x, "model", None)
                (gx,) = torch.autograd.grad((y * y).sum(), (x,))
            out[mode] = (str(gx.placements), gx.to_local().numpy(), dict(cost.calls))
    out["want"] = (2 * x0).numpy()
    return out


def moe_fsdp_rank(mesh, path: str, ckdir: str) -> dict:
    """A rank: each case's sharded run on its mesh (built over the same
    four ranks; the weights and batch read from ``path``), the mixtral
    state saved after it and restored onto a two-rank mesh for a third
    step, rank 0's one-rank run, and the aux loss's gradient."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.dist.sharding import AxisEnv, use_axis_env
    from repro_torch.ft import load_pytree, replan
    from repro_torch.launch.cells import build_cell, lm_param_logical
    from repro_torch.models import TransformerLM
    from repro_torch.train import init_train_state

    torch.set_num_threads(1)  # the ranks share the host's cores
    with open(path, "rb") as f:
        params, inp = pickle.load(f)
    rank = dist.get_rank()
    wide = DeviceMesh("cpu", torch.arange(4).reshape(1, 4), mesh_dim_names=("data", "model"))
    out = {}
    for case, (_, _, shape) in CASES.items():
        m = wide if shape["data"] == 1 else mesh
        out[case] = _sharded_run(case, m, params[case], inp,
                                 ckdir if case == CKPT_CASE else None)
    # the elastic restart: the mixtral state saved on four ranks, restored
    # onto replan's two-rank (data 2, model 1) mesh, one step more
    two = replan(2, 1, B).mesh.device_mesh("cpu")
    if rank < 2:
        like = build_cell(CASES[CKPT_CASE][0], "train_4k", smoke=True)
        cfg = _cfg(CKPT_CASE)
        meta = init_train_state(TransformerLM(cfg, device="meta", init=False))
        pl = lm_param_logical(cfg, fsdp=True)
        logical = dataclasses.replace(like.in_logical[0], params=pl, m=pl, v=pl)
        env = AxisEnv(two)
        state = load_pytree(meta, ckdir, env=env, logical=logical)
        restored = _numpy(state)
        with use_axis_env(env):
            state, m = _step()(state, _batch(inp))
        out["restored"] = {"mesh": dict(zip(two.mesh_dim_names, two.shape)),
                           "state_at_save": restored, "metrics": _metrics(m),
                           "placed": _placed(state, two), "state": _numpy(state)}
    own = [dist.new_group([r]) for r in range(dist.get_world_size())][rank]
    if rank == 0:
        one = DeviceMesh.from_group([own, own], "cpu", mesh=torch.tensor([[rank]]),
                                    mesh_dim_names=("data", "model"))
        out["one"] = _sharded_run("olmoe", one, params["olmoe"], inp)
    out["aux_grads"] = _aux_grads(mesh, params["olmoe"], inp)
    out["gloo_gathers"] = _gloo_gathers(mesh)
    return out


# ---------------------------------------------------------------------------
# the parent: the port unsharded, repro, the spawn
# ---------------------------------------------------------------------------


def _port_run(case: str, params_np, inp, steps: int) -> list[dict]:
    """The port's unsharded steps: after each, its metrics and state."""
    state, step, out = _state(case, params_np), _step(), []
    for _ in range(steps):
        state, m = step(state, _batch(inp))
        out.append({"metrics": _metrics(m), "state": _numpy(state)})
    return out


def _repro_run(case: str, params_np, inp) -> dict:
    """``repro``'s jitted ``make_train_step`` on the same weights and
    batch: its metrics and final state."""
    jcfg = _cfg(case, j_get_smoke_config)
    step = jax.jit(j_make_train_step(lambda p, b: jtf.lm_loss(p, b["t"], b["l"], jcfg),
                                     jopt.AdamConfig(**ADAM), microbatches=MICRO))
    st = jax.tree.map(jnp.asarray, jopt.init_train_state(params_np))
    metrics = []
    for _ in range(N_STEPS):
        st, m = step(st, {"t": jnp.asarray(inp["tokens"]), "l": jnp.asarray(inp["labels"])})
        metrics.append({k: float(m[k]) for k in METRICS})
    return {"metrics": metrics, "state": jax.tree.map(np.asarray, st)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.convert import train_state_to_numpy
    from repro_torch.models import TransformerLM, forward
    from repro_torch.train import init_train_state

    torch.set_num_threads(1)
    params, port, ref = {}, {}, {}
    rng = np.random.default_rng(1)
    vocab = {_cfg(c).vocab for c in CASES}
    assert len(vocab) == 1
    tokens = rng.integers(0, vocab.pop(), (B, S)).astype(np.int32)
    inp = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    for case in CASES:
        model = TransformerLM(_cfg(case), device="cpu",
                              generator=torch.Generator().manual_seed(0))
        params[case] = train_state_to_numpy(init_train_state(model)).params
        port[case] = _port_run(case, params[case], inp, N_STEPS + (case == CKPT_CASE))
        ref[case] = _repro_run(case, params[case], inp)
    model = _state("olmoe", params["olmoe"]).params
    with torch.enable_grad():
        aux = forward(model, _batch(inp)["tokens"])[1]
        names, leaves = zip(*model.named_parameters())
        grads = torch.autograd.grad(aux, leaves, allow_unused=True, materialize_grads=True)
    aux_grads = {n: g.numpy() for n, g in zip(names, grads)}
    path = tmp_path_factory.mktemp("moe_fsdp") / "inputs.pkl"
    path.write_bytes(pickle.dumps((params, inp)))
    ckdir = tmp_path_factory.mktemp("moe_fsdp_ck")
    ranks = spawn(moe_fsdp_rank, 4, device="cpu", args=(str(path), str(ckdir)),
                  timeout=TIMEOUT, mesh_shape={"data": 2, "model": 2})
    return {"port": port, "ref": ref, "ranks": ranks, "ckdir": str(ckdir), "params": params,
            "aux_grads": aux_grads}


def _metrics_close(got: list[dict], want: list[dict], what: str) -> None:
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        for k in METRICS:
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, err_msg=f"{what} step {i} {k}")


def _params_close(got: dict, want: dict, what: str) -> None:
    """Within 1 % of a step but for a few elements (module docstring)."""
    lr = ADAM["lr"]
    assert set(got) == set(want), what
    for n, w in want.items():
        d = np.abs(np.asarray(got[n], np.float64) - np.asarray(w, np.float64))
        odd = int((d > STEP_TOL * lr).sum())
        assert odd <= max(2, ODD_SHARE * d.size), f"{what} {n}: {odd} of {d.size}"


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_moe_train_matches_unsharded_port(runs, case):
    """Every rank, two steps of two microbatches on the case's mesh: loss,
    aux, grad_norm and lr, and every updated parameter, against the port's
    unsharded step."""
    want = runs["port"][case]
    for r, rank in enumerate(runs["ranks"]):
        got = rank[case]
        _metrics_close(got["metrics"], [w["metrics"] for w in want[:N_STEPS]], f"rank {r}")
        _params_close(got["state"]["params"], want[N_STEPS - 1]["state"]["params"],
                      f"rank {r} {case}")


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_moe_train_matches_repro(runs, case):
    """The same sharded steps against ``repro``'s jitted
    ``make_train_step`` (GSPMD's step, here on one device) on the same
    weights and batch."""
    from repro_torch.convert import train_state_from_numpy

    ref = runs["ref"][case]
    got = runs["ranks"][0][case]
    _metrics_close(got["metrics"], ref["metrics"], f"{case} vs repro")
    ref_params = dict(train_state_from_numpy(ref["state"], _cfg(case), "cpu").params
                      .named_parameters())
    _params_close(got["state"]["params"], {n: p.detach().numpy()
                                           for n, p in ref_params.items()}, f"{case} vs repro")


def test_sharded_moe_state_is_placed_as_its_parameters(runs):
    """After the steps, every parameter, ``m`` and ``v`` leaf of every case
    (mixtral's experts unfolded in all three) is a DTensor in its
    parameter's placements, and each rank holds only its shard of it."""
    for rank in runs["ranks"]:
        for case in CASES:
            assert rank[case]["placed"], case


def test_one_rank_mesh_is_bit_identical(runs):
    """Rank 0 alone on (data 1, model 1), olmoe: the loss, aux, grad_norm,
    lr and every leaf of the state after two steps are the unsharded
    step's bits."""
    got, want = runs["ranks"][0]["one"], runs["port"]["olmoe"]
    assert got["metrics"] == [w["metrics"] for w in want]
    for tree, leaves in want[-1]["state"].items():
        for n, w in leaves.items():
            assert np.array_equal(got["state"][tree][n], w), (tree, n)


def test_aux_gradient_counts_each_token_once(runs):
    """The gradient of the aux loss alone on (data 2, model 2): every leaf
    (the router's, through the routing's ``local_map`` and its FSDP
    gather's reduce-scatter; the others', through the hidden states)
    within GRAD_TOL of autograd of the unsharded aux on every rank."""
    want = runs["aux_grads"]
    router = [n for n in want if n.endswith(".router")]
    assert router and all(np.abs(want[n]).max() > 0 for n in router)
    for r, rank in enumerate(runs["ranks"]):
        got = rank["aux_grads"]
        assert set(got) == set(want)
        for n, w in want.items():
            scale = max(float(np.abs(w).max()), 1e-30)
            err = float(np.abs(got[n] - w).max()) / scale
            assert err <= GRAD_TOL, f"rank {r} {n}: {err:.3g} of the largest |grad|"


def test_checkpoint_restores_moe_state_onto_another_mesh(runs):
    """The mixtral state saved by four ranks after two steps (each rank
    half an expert), restored onto ``replan``'s two-rank mesh (whole
    virtual experts, D split on ``data``): the saved state exactly, every
    leaf placed as its parameter, and a third step that matches the
    unsharded third step."""
    third = runs["port"][CKPT_CASE][N_STEPS]
    saved = runs["ranks"][0][CKPT_CASE]["state"]
    for r in (0, 1):
        got = runs["ranks"][r]["restored"]
        assert got["mesh"] == {"data": 2, "model": 1} and got["placed"]
        for tree, leaves in saved.items():
            for n, w in leaves.items():
                assert np.array_equal(got["state_at_save"][tree][n], w), (r, tree, n)
        _metrics_close([got["metrics"]], [third["metrics"]], f"rank {r} third step")
        _params_close(got["state"]["params"], third["state"]["params"], f"rank {r} third")
    assert "restored" not in runs["ranks"][2] and "restored" not in runs["ranks"][3]


def test_repro_reads_the_sharded_moe_checkpoint(runs):
    """``repro``'s ``load_pytree`` restores the four ranks' float32 mixtral
    checkpoint into its own ``TrainState`` (virtual experts unfolded):
    the saved state's values."""
    from repro_torch.convert import train_state_from_numpy

    like = jax.tree.map(jnp.asarray, jopt.init_train_state(runs["params"][CKPT_CASE]))
    loaded = jckpt.load_pytree(like, runs["ckdir"])
    assert int(loaded.step) == N_STEPS
    state = train_state_from_numpy(jax.tree.map(np.asarray, loaded), _cfg(CKPT_CASE), "cpu")
    saved = runs["ranks"][0][CKPT_CASE]["state"]
    for n, p in state.params.named_parameters():
        assert np.array_equal(p.detach().numpy(), saved["params"][n]), n
    for tree in ("m", "v"):
        for n, t in getattr(state, tree).items():
            assert np.array_equal(t.numpy(), saved[tree][n]), (tree, n)


def test_gloo_gathers_run_a_gather_as_an_all_to_all(runs):
    """``GlooGathers`` (what ``use_axis_env`` enters on a gloo mesh of CUDA
    ranks, where gloo's all-gather faults) runs DTensor's own all-gather in
    a constraint's backward as an all-to-all of the same bytes: the same
    gradient, the gather counted as the all-to-all it ran."""
    for rank in runs["ranks"]:
        got = rank["gloo_gathers"]
        (pl, plain, calls), (pl_mode, viaa2a, calls_mode) = got[False], got[True]
        assert pl == pl_mode
        np.testing.assert_array_equal(plain, got["want"])
        np.testing.assert_array_equal(viaa2a, got["want"])
        assert calls["all-gather"] >= 1 and calls["all-to-all"] == 0
        assert calls_mode["all-to-all"] == calls["all-gather"] and calls_mode["all-gather"] == 0
