"""The port's MoE LM serving path run sharded on a ``DeviceMesh``
(``repro_torch.launch.cells.shard_cell``: the experts on ``expert``, the
tokens on ``batch``) on the CPU, against the port unsharded and against
``repro``'s unsharded functions.

One :func:`repro_torch.dist.spawn` of four ``gloo`` ranks builds every
case's mesh over the same world:

* ``olmoe``: ``olmoe-1b-7b-smoke`` on (data 2, model 2): 2 x 32-token
  prompts, 64 tokens in 32 blocks of 2, 16 on each data shard (the
  block-local route); three decode steps, whose one block of 2 tokens
  spans the data shards (the tokens gathered, each rank keeping its
  rows); ``forward`` and ``lm_loss`` with the aux loss over all tokens;
* ``mixtral_halves``: ``mixtral-8x7b-smoke`` with 2 experts of
  ``virtual_split`` 2 on (data 1, model 4): four virtual experts, one a
  rank, so each rank holds half an expert and the partial ``w_down``
  products are added across ranks; the rolling cache of its window;
* ``olmoe_no_ep``: ``olmoe-1b-7b-smoke`` with ``expert_parallel=False``
  on (data 2, model 2): every expert on every rank, ``F`` split on
  ``model``, the partial sums all-reduced;
* ``one``: rank 0's own one-rank (data 1, model 1) mesh, olmoe: the
  unsharded run's bits.

Weights come from ``repro``'s ``init_lm_params`` (float32), carried across
with ``repro_torch.convert``; prompts, labels and the fed decode tokens
from numpy.  Tolerance: the sharded logits within ``TOL`` of the row's
largest magnitude of the port's unsharded run and ``JAX_TOL`` of
``repro``'s (the ranks add partial sums and the aux loss's sums in
another order: measured up to 1.04e-6 of the row scale), the loss and the
aux loss within ``TOL`` relative.  Every MoE call's routing is recorded:
each rank's ``slot`` and ``keep`` equal the same blocks of the unsharded
port's, and its ``topi`` equals ``repro``'s but on near-ties of
``repro``'s router logits.

Spawned ranks import this file for its rank functions only: the ``if``
below keeps ``jax`` and ``repro`` out of them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import multiprocessing
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.dist import spawn  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

if multiprocessing.parent_process() is None:  # not in a spawned rank
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as j_get_smoke_config
    from repro.models import transformer as jtf
    from test_torch_moe import near_ties

# case -> (arch, MoESpec overrides, mesh)
CASES = {"olmoe": ("olmoe-1b-7b", {}, {"data": 2, "model": 2}),
         "mixtral_halves": ("mixtral-8x7b", {"n_experts": 2}, {"data": 1, "model": 4}),
         "olmoe_no_ep": ("olmoe-1b-7b", {"expert_parallel": False}, {"data": 2, "model": 2})}
B, S, N_DECODE = 2, 32, 3
TOL = 1e-5
JAX_TOL = 1e-5
ROUTE_MARGIN = 1e-4  # float32: two router logits closer than this are a near-tie
TIMEOUT = 240


def _cfg(case: str, get=None):
    arch, over, _ = CASES[case]
    cfg = (get or tconfigs.get_smoke_config)(arch)
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **over))


def _inputs(cfg, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            "decode": rng.integers(0, cfg.vocab, (N_DECODE, B)).astype(np.int32)}


@contextlib.contextmanager
def _routes(rec: list):
    """Every MoE call's routing as the FFN computes it: this rank's part of
    ``topi``, ``slot`` and ``keep``, and the global index of its first
    token and block."""
    from repro_torch.dist.sharding import local, shard_span
    from repro_torch.models import moe

    route = moe.moe_route

    def recorded(x, router, spec):
        r = route(x, router, spec)
        rec.append({"t0": shard_span(r.topi, 0)[0], "b0": shard_span(r.slot, 0)[0],
                    **{k: local(getattr(r, k)).numpy().copy() for k in ("topi", "slot", "keep")}})
        return r

    moe.moe_route = recorded
    try:
        yield rec
    finally:
        moe.moe_route = route


def _run(case: str, model, inp: dict, env=None) -> dict:
    """prefill, N_DECODE decode steps on the fed tokens, forward (its aux)
    and lm_loss, as numpy arrays, and the routing of every MoE call; on
    ``env``'s mesh through ``shard_cell`` when given."""
    from repro_torch.dist.sharding import place, use_axis_env
    from repro_torch.launch.cells import build_cell, lm_param_logical, shard_cell

    cfg = model.cfg
    tokens = torch.from_numpy(inp["tokens"])
    labels = torch.from_numpy(inp["labels"])
    dec = [torch.from_numpy(t) for t in inp["decode"]]
    pos = [torch.full((B,), S + i, dtype=torch.int32) for i in range(N_DECODE)]
    fn = ttf.prefill
    if env is not None:
        cell = build_cell(CASES[case][0], "prefill_32k", smoke=True)
        cell = dataclasses.replace(cell, args=(model, tokens),
                                   in_logical=(lm_param_logical(cfg, fsdp=False),
                                               cell.in_logical[1]))
        cell = shard_cell(cell, env)
        fn, (model, tokens) = cell.fn, cell.args
        with use_axis_env(env):
            labels = place(labels, "batch", None)
            dec = [place(t, "batch") for t in dec]
            pos = [place(p, "batch") for p in pos]
    whole = lambda t: (t.full_tensor() if env is not None else t).numpy().copy()
    out, rec = {}, []
    with torch.no_grad(), _routes(rec), (use_axis_env(env) if env is not None
                                         else contextlib.nullcontext()):
        logits, cache = fn(model, tokens)
        out["prefill"] = whole(logits)
        for i in range(N_DECODE):
            logits, cache = ttf.decode_step(model, cache, dec[i], pos[i])
            out[f"decode{i}"] = whole(logits)
        logits, aux = ttf.forward(model, tokens)
        out["forward"], out["aux"] = whole(logits), whole(aux)
        loss, _ = ttf.lm_loss(model, tokens, labels)
        out["loss"] = whole(loss)
    return out, rec


def moe_rank(mesh, path: str) -> dict:
    """A rank: each case on its mesh (built over the same four ranks), the
    weights and inputs read from ``path``; rank 0 also olmoe on its own
    one-rank mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.dist.sharding import AxisEnv

    torch.set_num_threads(1)  # the ranks share the host's cores
    with open(path, "rb") as f:
        params, inputs = pickle.load(f)
    rank = dist.get_rank()
    wide = DeviceMesh("cpu", torch.arange(4).reshape(1, 4), mesh_dim_names=("data", "model"))
    own = [dist.new_group([r]) for r in range(dist.get_world_size())][rank]
    one = DeviceMesh.from_group([own, own], "cpu", mesh=torch.tensor([[rank]]),
                                mesh_dim_names=("data", "model"))
    out = {}
    for case, (_, _, shape) in CASES.items():
        m = wide if shape["data"] == 1 else mesh
        model = lm_params_from_numpy(params[case], _cfg(case), device="cpu")
        out[case] = _run(case, model, inputs[case], AxisEnv(m))
    if rank == 0:
        model = lm_params_from_numpy(params["olmoe"], _cfg("olmoe"), device="cpu")
        out["one"] = _run("olmoe", model, inputs["olmoe"], AxisEnv(one))
    return out


def _jax_run(case: str, params: dict, inp: dict) -> tuple[dict, list]:
    """``repro``'s unsharded prefill, decode steps, forward and lm_loss on
    the same inputs, and the router logits of every MoE call (a debug
    callback in a patched ``moe_ffn``)."""
    jcfg = _cfg(case, j_get_smoke_config)
    jp = jax.tree.map(jnp.asarray, params)
    rec = []
    j_moe = jtf.moe_ffn

    def recorded(x, p, spec):
        logits = x.astype(jnp.float32) @ p["router"].astype(jnp.float32)
        jax.debug.callback(lambda lg: rec.append(np.asarray(lg)), logits)
        return j_moe(x, p, spec)

    jtf.moe_ffn = recorded
    try:
        logits, cache = jtf.prefill(jp, inp["tokens"], jcfg)
        r = {"prefill": logits}
        for i in range(N_DECODE):
            logits, cache = jtf.decode_step(jp, cache, inp["decode"][i],
                                            np.full((B,), S + i, np.int32), jcfg)
            r[f"decode{i}"] = logits
        r["forward"], r["aux"] = jtf.forward(jp, inp["tokens"], jcfg)
        r["loss"] = jtf.lm_loss(jp, inp["tokens"], inp["labels"], jcfg)[0]
        jax.effects_barrier()
    finally:
        jtf.moe_ffn = j_moe
    return {k: np.asarray(v) for k, v in r.items()}, rec


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per case: the reference's weights and inputs, the port's and
    ``repro``'s unsharded runs (with their routing), and the four ranks'
    sharded runs; rank 0's one-rank run."""
    params, inputs, port, ref = {}, {}, {}, {}
    for case in CASES:
        cfg, jcfg = _cfg(case), _cfg(case, j_get_smoke_config)
        params[case] = jax.tree.map(np.asarray, jtf.init_lm_params(jax.random.PRNGKey(0), jcfg))
        inputs[case] = inp = _inputs(cfg)
        port[case] = _run(case, lm_params_from_numpy(params[case], cfg, device="cpu"), inp)
        ref[case] = _jax_run(case, params[case], inp)
    path = tmp_path_factory.mktemp("moe_tp") / "inputs.pkl"
    path.write_bytes(pickle.dumps((params, inputs)))
    ranks = spawn(moe_rank, 4, device="cpu", args=(str(path),), timeout=TIMEOUT,
                  mesh_shape={"data": 2, "model": 2})
    return {"port": port, "ref": ref, "ranks": ranks}


def _row_close(got, want, tol: float, what: str) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max(axis=-1, keepdims=True) if want.ndim else np.abs(want)
    err = np.abs(got - want)
    assert (err <= tol * scale).all(), (
        f"{what}: max err {err.max():.3g}, {float((err / np.maximum(scale, 1e-30)).max()):.3g} "
        f"of the row scale (tolerance {tol})")


def _routing_check(got: list, port: list, jax_logits: list, K: int, what: str) -> None:
    """Each recorded call of a rank: ``slot`` and ``keep`` the port's for
    the same blocks, ``topi`` the reference's but on its near-ties."""
    assert len(got) == len(port) == len(jax_logits), what
    for c, (g, p, lg) in enumerate(zip(got, port, jax_logits)):
        n_tok, n_blk = g["topi"].shape[0], g["slot"].shape[0]
        tok, blk = slice(g["t0"], g["t0"] + n_tok), slice(g["b0"], g["b0"] + n_blk)
        assert np.array_equal(g["slot"], p["slot"][blk]), f"{what} call {c}: slot"
        assert np.array_equal(g["keep"], p["keep"][blk]), f"{what} call {c}: keep"
        j_topi = np.argsort(-lg, axis=-1, kind="stable")[:, :K][tok]
        differ = ~(j_topi == g["topi"]).all(axis=-1)
        ties = near_ties(lg[tok], K, ROUTE_MARGIN)
        assert ties[differ].all(), f"{what} call {c}: topi differs off the near-ties"


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_moe_matches_unsharded_and_jax(runs, case):
    """Every rank: the prefill's and three decode steps' logits, forward's
    logits and aux, and lm_loss within TOL of the port unsharded and
    JAX_TOL of ``repro``; every MoE call's routing rule-1 equal."""
    (port, port_rec), (ref, j_logits) = runs["port"][case], runs["ref"][case]
    K = _cfg(case).moe.top_k
    _routing_check(port_rec, port_rec, j_logits, K, f"{case} unsharded port")
    for r, ranks in enumerate(runs["ranks"]):
        got, rec = ranks[case]
        assert set(got) == set(port)
        for key in port:
            _row_close(got[key], port[key], TOL, f"rank {r} {case} {key} vs the port")
            _row_close(got[key], ref[key], JAX_TOL, f"rank {r} {case} {key} vs repro")
        _routing_check(rec, port_rec, j_logits, K, f"rank {r} {case}")


def test_one_rank_mesh_is_bit_identical(runs):
    """One rank on (data 1, model 1): every output and every call's
    routing the unsharded run's bits."""
    (got, rec), (port, port_rec) = runs["ranks"][0]["one"], runs["port"]["olmoe"]
    assert set(got) == set(port)
    for key in port:
        assert np.array_equal(got[key], port[key]), key
    for g, p in zip(rec, port_rec):
        assert all(np.array_equal(g[k], p[k]) for k in ("topi", "slot", "keep"))
