"""two-tower-retrieval run sharded on a ``DeviceMesh`` through
``repro_torch.launch.cells.shard_cell`` on the CPU (the tables and the
candidates on ``("rows", None)``, the batch on ``batch``, the MLPs and
``temp`` replicated), against ``repro``'s unsharded functions on the same
weights and against the port unsharded.

One :func:`repro_torch.dist.spawn` of four ``gloo`` ranks on (data 2,
model 2); rank 0 also on its own one-rank (data 1, model 1) mesh.  Each
rank takes its rows of the reference's tables
(``convert.two_tower_params_from_numpy(env=)``) and runs the smoke cells:
``score_pairs`` (serve_p99), ``score_pairs`` on a 64-row batch in chunks
of two gathered rows (``BAG_BYTES`` cut: eight chunks a rank),
``retrieval_scores`` over 512 candidates, top 100, and two train steps.

Tolerances, and why:

* Scores: rtol 1e-5, atol 1e-6 against ``repro`` (as
  ``tests/test_torch_recsys.py``: float32 products and the bag's sums in
  another order than XLA's; here the bags' partial sums are also added
  over the ranks).  Retrieval's top-100 indices are equal (no near-ties
  among 512 normal candidates).
* Integer-valued tables, MLP weights and candidates (small integers:
  every bag and first-layer product is exact in float32): scores and the
  top 100 bit for bit with the port unsharded.
* Two train steps (lr 1e-2): loss and ``grad_norm`` at rtol 1e-5 and the
  parameters as ``tests/test_torch_cells.py`` holds a train step
  (within 1 % of a step plus 2 ulps but for a few elements, each within
  ``2 lr``): the ranks add the loss's terms, the gradients' partial sums
  and the table rows' gradients in another order than one device.
* The one-rank mesh: the unsharded bits, serving and training.

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
from repro_torch.convert import two_tower_params_from_numpy  # noqa: E402
from repro_torch.dist import spawn  # noqa: E402
from repro_torch.models import two_tower as ttt  # noqa: E402

if multiprocessing.parent_process() is None:  # not in a spawned rank
    import jax
    import jax.numpy as jnp

    from repro.models import two_tower as jtt
    from repro.train import optimizer as jopt
    from repro.train.train_step import make_train_step as j_make_train_step
    from test_torch_cells import assert_params_close, jax_leaves

ARCH = "two-tower-retrieval"
RTOL, ATOL = 1e-5, 1e-6
ADAM = dict(lr=1e-2, warmup_steps=1, weight_decay=0.0)
STEPS = 2
BULK = 64  # rows of the chunked batch
BULK_ROWS = 2  # gathered rows a chunk (BAG_BYTES cut)
TOP_K = 100
TIMEOUT = 240


def _inputs(seed: int = 0) -> dict:
    """The reference's tables and weights (numpy, from ``repro``'s init),
    the same tree with small integer values, and the batches."""
    cfg = tconfigs.get_smoke_config(ARCH)
    rng = np.random.default_rng(seed)
    Fu, Fi, M = cfg.n_user_fields, cfg.n_item_fields, cfg.multi_hot

    def batch(B, log_q=False):
        return dict(
            user_idx=rng.integers(0, cfg.user_vocab, (B, Fu, M)).astype(np.int32),
            user_wt=(rng.random((B, Fu, M)) * (rng.random((B, Fu, M)) > 0.2)).astype(np.float32),
            item_idx=rng.integers(0, cfg.item_vocab, (B, Fi, M)).astype(np.int32),
            item_wt=rng.random((B, Fi, M)).astype(np.float32),
            log_q=(rng.normal(size=B) * 0.1 if log_q else np.zeros(B)).astype(np.float32))

    def ints(shape):
        return rng.integers(-2, 3, shape).astype(np.float32)

    params = jax.tree.map(np.asarray, jtt.init_two_tower_params(jax.random.PRNGKey(seed),
                                                                jax_cfg()))
    params_int = jax.tree.map(lambda x: ints(x.shape) if x.ndim else x, params)
    int_batch = lambda b: b | {"user_wt": (b["user_wt"] > 0.5).astype(np.float32),
                               "item_wt": (b["item_wt"] > 0.5).astype(np.float32)}
    N = 512
    return {"params": params, "params_int": params_int,
            "serve": batch(4), "bulk": batch(BULK), "train": batch(8, log_q=True),
            "query": batch(1), "cand": rng.normal(size=(N, cfg.tower_mlp[-1])).astype(np.float32),
            "cand_int": ints((N, cfg.tower_mlp[-1])),
            "int_serve": int_batch(batch(4)), "int_bulk": int_batch(batch(BULK))}


def jax_cfg():
    from repro.configs import get_smoke_config

    return get_smoke_config(ARCH)


def _tbatch(b: dict) -> ttt.RecsysBatch:
    return ttt.RecsysBatch(**{k: torch.from_numpy(v) for k, v in b.items()})


def _whole(x) -> np.ndarray:
    from torch.distributed.tensor import DTensor

    return (x.full_tensor() if isinstance(x, DTensor) else x).detach().numpy()


def _port(inp: dict, env=None) -> dict:
    """The port's smoke cells on ``inp`` (on ``env``'s mesh through
    ``shard_cell`` when given): scores, chunked scores, the top 100 and
    two train steps' metrics and parameters; the same serving on the
    integer tree."""
    from repro_torch.dist.sharding import use_axis_env
    from repro_torch.launch.cells import build_cell, shard_cell
    from repro_torch.train import AdamConfig, init_train_state, make_train_step

    cfg = tconfigs.get_smoke_config(ARCH)

    def run(shape, args, fn=None):
        cell = build_cell(ARCH, shape, concrete=True, smoke=True, device="cpu")
        cell = dataclasses.replace(cell, args=args, fn=fn or cell.fn)
        if env is None:
            return cell.fn(*cell.args)
        cell = shard_cell(cell, env)
        with use_axis_env(env):
            return cell.fn(*cell.args)

    def serve(tree, tag, cand):
        params = two_tower_params_from_numpy(inp[tree], cfg, "cpu", env=env)
        q = _tbatch(inp["query"])
        v, i = run("retrieval_cand", (params, q.user_idx, q.user_wt, torch.from_numpy(cand)))
        bulk_bytes = BULK_ROWS * cfg.n_user_fields * cfg.multi_hot * cfg.embed_dim * 4
        saved, ttt.BAG_BYTES = ttt.BAG_BYTES, bulk_bytes
        try:
            bulk = run("serve_bulk", (params, _tbatch(inp[f"{tag}bulk"])))
        finally:
            ttt.BAG_BYTES = saved
        return {f"{tag}score": _whole(run("serve_p99", (params, _tbatch(inp[f"{tag}serve"])))),
                f"{tag}bulk": _whole(bulk), f"{tag}top_v": _whole(v), f"{tag}top_i": _whole(i)}

    with torch.no_grad():
        out = serve("params", "", inp["cand"]) | serve("params_int", "int_", inp["cand_int"])
    step = make_train_step(lambda p, b: ttt.two_tower_loss(p, b, cfg), AdamConfig(**ADAM))
    state = init_train_state(two_tower_params_from_numpy(inp["params"], cfg, "cpu", env=env))
    out["metrics"] = []
    for _ in range(STEPS):
        state, m = run("train_batch", (state, _tbatch(inp["train"])), fn=step)
        out["metrics"].append({k: float(_whole(m[k])) for k in ("loss", "grad_norm", "lr",
                                                                 "in_batch_acc")})
    out["params"] = _leaves(state.params)
    return out


def _leaves(tree, path: tuple = ()) -> dict:
    """``{path of dict keys: numpy array}`` of a tree of (D)tensors."""
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in _leaves(tree[k], path + (k,)).items()}
    return {path: _whole(tree)}


def tt_rank(mesh, path: str) -> dict:
    """A rank: the smoke cells on (data 2, model 2); its drawn rows
    against the whole init's; rank 0 also on its own one-rank mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.dist.sharding import AxisEnv

    torch.set_num_threads(1)  # the ranks share the host's cores
    with open(path, "rb") as f:
        inp = pickle.load(f)
    rank, world = dist.get_rank(), dist.get_world_size()
    env = AxisEnv(mesh)
    out = {"mesh": _port(inp, env)}
    cfg = tconfigs.get_smoke_config(ARCH)
    drawn = ttt.init_two_tower_params(cfg, device="cpu", seed=3, env=env)
    whole = ttt.init_two_tower_params(cfg, device="cpu", seed=3)
    out["rows"] = {}
    for name in ("user_table", "item_table"):
        t = drawn[name]
        lo = t.to_local().shape[0] * (mesh.get_coordinate()[0] * 2 + mesh.get_coordinate()[1])
        n = t.to_local().shape[0]
        out["rows"][name] = (lo, n, bool(torch.equal(t.to_local(), whole[name][lo:lo + n])),
                             bool(torch.equal(t.to_local(), ttt.table_rows(cfg, name, lo, n, device="cpu",
                                                                           seed=3))))
    out["mlp_equal"] = all(torch.equal(drawn[k][n].to_local(), whole[k][n])
                           for k in ("user_mlp", "item_mlp") for n in whole[k])
    own = [dist.new_group([r]) for r in range(world)][rank]
    if rank == 0:
        one = DeviceMesh.from_group([own, own], "cpu", mesh=torch.tensor([[rank]]),
                                    mesh_dim_names=("data", "model"))
        out["one"] = _port(inp, AxisEnv(one))
    return out


def _jax(inp: dict) -> dict:
    """``repro``'s unsharded functions on the same trees and batches."""
    cfg = jax_cfg()
    pj = jax.tree.map(jnp.asarray, inp["params"])
    jb = lambda b: jtt.RecsysBatch(**{k: jnp.asarray(v) for k, v in b.items()})
    q = jb(inp["query"])
    v, i = jtt.retrieval_scores(pj, q.user_idx, q.user_wt, jnp.asarray(inp["cand"]), cfg, TOP_K)
    out = {"score": np.asarray(jtt.score_pairs(pj, jb(inp["serve"]), cfg)),
           "bulk": np.asarray(jtt.score_pairs(pj, jb(inp["bulk"]), cfg)),
           "top_v": np.asarray(v), "top_i": np.asarray(i), "metrics": []}
    step = jax.jit(j_make_train_step(lambda p, b: jtt.two_tower_loss(p, b, cfg),
                                     jopt.AdamConfig(**ADAM)))
    st = jopt.init_train_state(pj)
    for _ in range(STEPS):
        st, m = step(st, jb(inp["train"]))
        out["metrics"].append({k: float(m[k]) for k in ("loss", "grad_norm", "lr",
                                                        "in_batch_acc")})
    out["params"] = jax_leaves(st.params)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    inp = _inputs()
    path = tmp_path_factory.mktemp("tt_sharded") / "inputs.pkl"
    path.write_bytes(pickle.dumps(inp))
    ranks = spawn(tt_rank, 4, device="cpu", args=(str(path),), timeout=TIMEOUT,
                  mesh_shape={"data": 2, "model": 2})
    return {"ref": _jax(inp), "port": _port(inp), "ranks": ranks}


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


@pytest.mark.parametrize("what", ["score", "bulk", "top_v"])
def test_sharded_serving_matches_repro(runs, what):
    for r, got in enumerate(runs["ranks"]):
        _close(got["mesh"][what], runs["ref"][what], f"{what} rank {r}")
        assert np.array_equal(got["mesh"][what], runs["ranks"][0]["mesh"][what]), (what, r)


def test_sharded_retrieval_indices_equal_repro(runs):
    for r, got in enumerate(runs["ranks"]):
        assert np.array_equal(got["mesh"]["top_i"], runs["ref"]["top_i"]), r
        v = got["mesh"]["top_v"]
        assert (v[:-1] >= v[1:]).all(), r


@pytest.mark.parametrize("what", ["int_score", "int_bulk", "int_top_v", "int_top_i"])
def test_sharded_serving_bit_for_bit_on_integers(runs, what):
    for r, got in enumerate(runs["ranks"]):
        assert np.array_equal(got["mesh"][what], runs["port"][what]), (what, r)


@pytest.mark.parametrize("step", range(STEPS))
def test_sharded_train_steps_match_repro(runs, step):
    want = runs["ref"]["metrics"][step]
    for r, got in enumerate(runs["ranks"]):
        m = got["mesh"]["metrics"][step]
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(m[k], want[k], rtol=RTOL, err_msg=f"{k} rank {r}")
        np.testing.assert_allclose(m["lr"], want["lr"], rtol=1e-6)
        assert m["in_batch_acc"] == want["in_batch_acc"], r
        np.testing.assert_allclose(m["loss"], runs["port"]["metrics"][step]["loss"], rtol=RTOL)


def test_sharded_train_params_match_repro_and_port(runs):
    for r, got in enumerate(runs["ranks"]):
        assert_params_close(got["mesh"]["params"], runs["ref"]["params"], ADAM["lr"],
                            f"rank {r} vs repro")
        assert_params_close(got["mesh"]["params"], runs["port"]["params"], ADAM["lr"],
                            f"rank {r} vs the port")
        for k, v in got["mesh"]["params"].items():
            assert np.array_equal(v, runs["ranks"][0]["mesh"]["params"][k]), (r, k)


def test_one_rank_mesh_gives_the_unsharded_bits(runs):
    got, want = runs["ranks"][0]["one"], runs["port"]
    for k in ("score", "bulk", "top_v", "top_i", "int_score", "int_bulk", "int_top_v",
              "int_top_i"):
        assert np.array_equal(got[k], want[k]), k
    assert got["metrics"] == want["metrics"]
    for k, v in want["params"].items():
        assert np.array_equal(got["params"][k], v), k


def test_a_rank_draws_the_whole_inits_rows(runs):
    """``init_two_tower_params(env=)`` draws only a rank's rows, and they
    are the whole table's (and :func:`table_rows`'), on every rank; its
    MLPs are the whole init's."""
    cfg = tconfigs.get_smoke_config(ARCH)
    for r, got in enumerate(runs["ranks"]):
        for name, V in (("user_table", cfg.user_vocab), ("item_table", cfg.item_vocab)):
            lo, n, equal, equal_rows = got["rows"][name]
            assert (lo, n) == (r * V // 4, V // 4) and equal and equal_rows, (r, name)
        assert got["mlp_equal"], r
