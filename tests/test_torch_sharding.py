"""The port's sharding layer (``repro_torch.dist.sharding`` on
``DeviceMesh``), production meshes and dry run against the JAX package on
the CPU.

The reference's side needs no devices: ``jax.sharding.AbstractMesh`` with
the production shapes (``jax.make_mesh``, which the reference's own mesh
helper calls, fails on this container: ROADMAP C.5).  The port's side
joins torch's fake process group (one process plays every rank) in a
module fixture that leaves it again, as the group is process-wide state
that other test files of an xdist worker share; the dry run itself runs
in subprocesses.

Everything is compared exactly: mesh-dim names, shard counts, per-leaf
shard shapes of every cell on both production meshes.  The sharded dry
run's counter (``sharding.LocalCost``) is held to a hand-counted case,
and the dense LM serving cells' sharded traces to the one-device count.
"""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402

from repro.dist import sharding as jsharding  # noqa: E402
from repro.launch import cells as jcells  # noqa: E402
from repro_torch.configs import Skip, all_cells, get_smoke_config  # noqa: E402
from repro_torch.dist import sharding as tsharding  # noqa: E402
from repro_torch.launch import cells as tcells  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import gnn as tgnn  # noqa: E402
from test_torch_cells import _key  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"single": (tmesh.SINGLE_POD, tmesh.SINGLE_POD_AXES),
          "multi": (tmesh.MULTI_POD, tmesh.MULTI_POD_AXES)}
CELLS = [(a, s) for a, s, spec in all_cells() if not isinstance(spec, Skip)]


@pytest.fixture(scope="module")
def meshes():
    """The port's production meshes over a 512-rank fake process group
    (the single-pod mesh over its first 256 ranks), and the reference's
    abstract meshes of the same shapes."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        pytest.skip("a process group is already initialised in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=512)
    try:
        out = {}
        for kind, (shape, axes) in MESHES.items():
            t = (tmesh.make_production_mesh(multi_pod=True, device_type="cpu")
                 if kind == "multi" else
                 DeviceMesh("cpu", torch.arange(256).reshape(shape), mesh_dim_names=axes))
            out[kind] = (tsharding.AxisEnv(mesh=t),
                         jsharding.AxisEnv(mesh=AbstractMesh(shape, axes)))
        yield out
    finally:
        dist.destroy_process_group()


def test_production_mesh_shapes(meshes):
    for kind, (shape, axes) in MESHES.items():
        env, _ = meshes[kind]
        assert tuple(env.mesh.shape) == shape and env.mesh.mesh_dim_names == axes
        assert env.mesh_shape == dict(zip(axes, shape))
    with pytest.raises(RuntimeError, match="256 ranks"):
        tmesh.make_production_mesh(device_type="cpu")  # the group holds 512


@pytest.mark.parametrize("kind", list(MESHES))
def test_resolve_axis_size_and_placements_every_rule(meshes, kind):
    env, jenv = meshes[kind]
    names = list(env.mesh_shape)
    for logical in tsharding.DEFAULT_RULES:
        assert env.resolve(logical) == jenv.resolve(logical), logical
        assert env.axis_size(logical) == jenv.axis_size(logical), logical
        for dims in ((logical,), (None, logical), (logical, None)):
            want = jenv.spec(*dims)
            got = env.placements(*dims)
            assert len(got) == len(names)
            for name, p in zip(names, got):
                carried = [d for d, entry in enumerate(want)
                           if entry == name or (isinstance(entry, tuple) and name in entry)]
                assert (p == tsharding.Shard(carried[0]) if carried
                        else p == tsharding.Replicate()), (dims, name, p)
    assert env.resolve(None) is None and env.axis_size(None) == 1
    assert env.placements() == tuple(tsharding.Replicate() for _ in names)
    with pytest.raises(KeyError, match="unknown logical axis"):
        env.resolve("nope")
    with pytest.raises(ValueError, match="two tensor dims"):
        env.placements("model", "expert")
    custom = tsharding.AxisEnv(env.mesh, rules={"batch": ()})
    assert custom.resolve("batch") is None and custom.axis_size("batch") == 1
    assert tsharding.AxisEnv(env.mesh, rules={"x": ("model", "data")}).resolve("x") == (
        "model", "data")
    with pytest.raises(ValueError, match="mesh's order"):
        tsharding.AxisEnv(env.mesh, rules={"x": ("model", "data")}).placements("x")


def _reference_shards(arch, shape, jenv) -> dict:
    with jsharding.use_axis_env(jenv):
        cell = jcells.build_cell(arch, shape)
        shardings = jsharding.tree_shardings(cell.in_logical)
    shards = jax.tree.leaves(shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
    leaves = jax.tree_util.tree_flatten_with_path(cell.args)[0]
    assert len(shards) == len(leaves)
    return {tuple(_key(e) for e in p): (tuple(x.shape), s.shard_shape(x.shape))
            for (p, x), s in zip(leaves, shards)}


@pytest.mark.parametrize("kind", list(MESHES))
@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_cell_shard_shapes_equal_jax(meshes, arch, shape, kind):
    """Every leaf of every cell's arguments (the reference's layout, full
    size, on meta): the global shape and the shard shape under the logical
    axes on each production mesh, equal to ``NamedSharding(AbstractMesh,
    spec).shard_shape``."""
    env, jenv = meshes[kind]
    cell = tcells.build_cell(arch, shape)
    sizes = list(env.mesh_shape.values())
    got = {path: (tuple(x.shape), tsharding.local_shape(x.shape, env.placements(*names), sizes))
           for path, x, names in tsharding.logical_leaves(tcells.reference_args(cell),
                                                          cell.in_logical)}
    assert got == _reference_shards(arch, shape, jenv)


def test_tree_shardings_mirror_the_logical_tree(meshes):
    env, _ = meshes["single"]
    cell = tcells.build_cell("spade-grab", "grab4_stream")
    with pytest.raises(ValueError, match="active AxisEnv"):
        tsharding.tree_shardings(cell.in_logical)
    with tsharding.use_axis_env(env):
        assert tsharding.axis_env() is env
        tree = tsharding.tree_shardings(cell.in_logical)
    assert tsharding.axis_env() is None
    assert tree[0].graph.src == (tsharding.Shard(0), tsharding.Replicate())
    assert tree[0].graph.n_capacity == cell.in_logical[0].graph.n_capacity
    assert tree[0].best_g == (tsharding.Replicate(),) * 2


def test_recsys_logical_tree_is_the_full_configs(meshes):
    """``recsys_param_logical`` names three layers a tower, as the
    reference's does: the full config's; the smoke config's two-layer
    towers have no ``w2`` to pair with it."""
    full = tcells.build_cell("two-tower-retrieval", "serve_p99")
    assert len(tsharding.logical_leaves(tcells.reference_args(full), full.in_logical)) == 15 + 5
    smoke = tcells.build_cell("two-tower-retrieval", "serve_p99", concrete=True, smoke=True,
                              device="cpu")
    with pytest.raises(KeyError, match="w2"):
        tsharding.logical_leaves(tcells.reference_args(smoke), smoke.in_logical)


def test_constrain_divisibility_rule(meshes):
    from torch.distributed.tensor import DTensor

    env, jenv = meshes["single"]
    x = torch.zeros(32, 7)
    assert tsharding.constrain(x, "batch", "model") is x  # no env: a no-op
    with tsharding.use_axis_env(env):
        assert tsharding.constrain(x, "batch", "model") is x  # one device's data
        with pytest.raises(ValueError, match="logical axes"):
            tsharding.constrain(x, "batch")
        d = DTensor.from_local(torch.zeros(32, 7), env.mesh,
                               [tsharding.Replicate(), tsharding.Replicate()], run_check=False)
        y = tsharding.constrain(d, "batch", "model")
    # 32 rows divide by data's 16; 7 columns do not divide by model's 16
    assert tuple(y.placements) == (tsharding.Shard(0), tsharding.Replicate())
    assert tuple(y.shape) == (32, 7) and tuple(y.to_local().shape) == (2, 7)
    spec = [jenv.resolve(n) if dim % jenv.axis_size(n) == 0 else None
            for dim, n in zip((32, 7), ("batch", "model"))]
    assert spec == ["data", None]


def _dryrun(tmp_path, *args) -> tuple[str, list[dict]]:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *args,
                          "--out", str(tmp_path)], capture_output=True, text=True, env=env,
                         cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout, [json.loads(p.read_text()) for p in sorted(tmp_path.glob("*.json"))]


def test_dryrun_subprocess_one_cell(tmp_path):
    text, (res,) = _dryrun(tmp_path, "--arch", "gat-cora", "--shape", "molecule",
                           "--mesh", "multi")
    """GAT's molecule cell on the multi-pod mesh traces sharded (ROADMAP
    D.3b): its collectives a step by kind, as ``test_dryrun_sharded_smoke_gnn``
    counts them (the edges over (pod, data), one collective each), and the
    traced rank's FLOPs."""
    assert "0 failures" in text
    assert res["status"] == "OK" and res["n_chips"] == 512 and res["mesh"] == "multi"
    assert res["collective_calls"] == {"all-gather": 2, "all-reduce": 18, "reduce-scatter": 2,
                                       "all-to-all": 0, "collective-permute": 0}
    assert res["collective_bytes_per_chip"] == sum(res["collectives"].values()) > 0
    assert res["t_collective_s"] == res["collective_bytes_per_chip"] / 450e9
    assert "collective_bytes_reason" not in res
    assert res["flops"] > 0 and 0 < res["flops_per_chip"] < res["flops"]
    assert res["argument_bytes"] < res["argument_bytes_global"]
    assert res["dominant"] in ("compute", "memory", "collective") and "meta_run" not in res


def test_dryrun_spade_cells_report_meta_run(tmp_path):
    """The Spade cells' FLOPs are not traced (their kernels refuse meta),
    and their collectives a step come from the edge-sharded engine's
    count: the peel's prologue and its 20 rounds each all-reduce the
    float64 dw and dropped mass, 6,023,168 + 1 elements (48,185,352 B), on
    both meshes."""
    text, results = _dryrun(tmp_path, "--family", "spade", "--mesh", "both")
    assert "4 cells, 0 failures" in text
    for res in results:
        assert res["status"] == "OK" and "flops" not in res
        assert "meta" in res["meta_run"] and res["argument_bytes"] > 0
        assert res["collective_calls"]["all-reduce"] == 21
        assert sum(res["collective_calls"].values()) == 21
        assert res["collectives"]["all-reduce"] == 21 * 48_185_352 == 1_011_892_392
        assert res["collective_bytes_per_chip"] == 1_011_892_392
        assert res["t_collective_s"] == 1_011_892_392 / 450e9
        assert "collective_bytes_reason" not in res and "structure" in res["sharded_counted"]
    # sorted by file name: grab4_static (multi, single), grab4_stream (multi, single)
    static, stream = results[1], results[3]
    assert static["step_name"] == "bulk_peel" and stream["step_name"] == "insert_and_maintain"
    assert stream["argument_bytes"] > static["argument_bytes"]  # the state beside the graph


def test_local_cost_hand_countable(meshes):
    """``LocalCost`` on the single-pod mesh (data 16, model 16), meta
    DTensors: a column-parallel product needs no collective, gathering its
    columns is one all-gather of the rank's rows, whole; the row-parallel
    product's partial sums one all-reduce of its output; FLOPs are the
    shards' products.  Rows over all 256 ranks (pure data parallelism):
    per-device FLOPs x ranks = the one-device count."""
    from repro_torch.dist.sharding import COLLECTIVES, LocalCost, place

    env, _ = meshes["single"]
    B, D, F = 64, 256, 512
    rows = B // 16
    with tsharding.use_axis_env(env):
        x = place(torch.empty(B, D, device="meta"), "batch", None)
        w1 = place(torch.empty(D, F, device="meta"), None, "model")
        w2 = place(torch.empty(F, D, device="meta"), "model", None)
        with LocalCost() as c:
            h = x @ w1
            tsharding.constrain(h, "batch", None)
            tsharding.constrain(h @ w2, "batch", None)
        want = dict.fromkeys(COLLECTIVES, 0)
        assert c.collectives == want | {"all-gather": rows * F * 4, "all-reduce": rows * D * 4}
        assert c.calls == want | {"all-gather": 1, "all-reduce": 1}
        assert c.flops == 2 * rows * D * (F // 16) * 2
        xr = place(torch.empty(512, D, device="meta"), "rows", None)
        w = place(torch.empty(D, F, device="meta"), None, None)
        with LocalCost() as c:
            xr @ w
    assert c.flops * 256 == 2 * 512 * D * F and not any(c.collectives.values())


@pytest.mark.parametrize("module", tsharding._PROPAGATION)
def test_local_cost_propagation_modules_exist(module):
    """``LocalCost`` leaves out the plain ops that DTensor's sharding
    propagation evaluates on global shapes by finding these modules on the
    call stack: a torch that renamed one would count those ops silently."""
    assert importlib.import_module(module).__name__ == module


@pytest.mark.parametrize("heads", [4, 16], ids=["seq", "heads"])
def test_dryrun_sharded_smoke_prefill(meshes, heads):
    """qwen3-14b's smoke prefill cell sharded on a fake (data 2, model 2)
    mesh (the production meshes' device type, ``cuda``, whose DTensor moves
    a shard between dims by an all-to-all): collectives under ``repro``'s
    five names, the sequence-sharded layout (its 4 q heads) with
    all-to-alls, the head-sharded one (16 q heads) without, and per-device
    FLOPs x 4 at least the one-device count."""
    import dataclasses

    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.dist.sharding import COLLECTIVES
    from repro_torch.launch import dryrun
    from repro_torch.models import TransformerLM

    mesh = DeviceMesh("cuda", torch.arange(4).reshape(2, 2), mesh_dim_names=("data", "model"))
    env = tsharding.AxisEnv(mesh)

    def make(n):
        cell = tcells.build_cell("qwen3-14b", "prefill_32k", smoke=True, override_layers=n)
        cfg = dataclasses.replace(cell.args[0].cfg, n_heads=heads)
        return dataclasses.replace(cell, args=(TransformerLM(cfg, "meta", init=False),
                                               cell.args[1]))

    res = dryrun.sharded_cost(make, env, 2)
    coll = res["collectives"]
    assert tuple(coll) == COLLECTIVES and res["collective_bytes_per_chip"] == sum(coll.values())
    assert coll["all-gather"] > 0 and coll["all-reduce"] > 0
    assert (coll["all-to-all"] > 0) == (heads == 4)
    one_device = dryrun._traced_flops(make(2))
    assert res["flops_per_chip"] * 4 >= one_device > res["flops_per_chip"]


def test_dryrun_subprocess_dense_lm_cell(tmp_path):
    text, (res,) = _dryrun(tmp_path, "--arch", "qwen3-14b", "--shape", "decode_32k",
                           "--mesh", "single")
    assert "0 failures" in text and res["status"] == "OK" and res["n_chips"] == 256
    assert "collective_bytes_reason" not in res and res["collective_bytes_per_chip"] > 0
    assert res["collective_bytes_per_chip"] == sum(res["collectives"].values())
    assert res["t_collective_s"] == res["collective_bytes_per_chip"] / 450e9
    assert res["flops_per_chip"] > 0 and "sharded" in res["sharded_counted"]
    assert res["dominant"] in ("compute", "memory", "collective")


def test_local_cost_fsdp_hand_countable(meshes):
    """FSDP on a fake (data 2) mesh, meta DTensors: one linear layer's
    weight sharded on ``data``, gathered whole inside a rematerialised
    function, its input sharded on the batch.  The forward and the
    recomputation each all-gather the whole weight, the backward
    reduce-scatters its gradient into the rank's rows (the shard's bytes),
    and the loss's mean over the batch shards is one all-reduce of a
    float32; the gradient keeps the weight's placements."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.utils.checkpoint import checkpoint

    from repro_torch.dist.sharding import COLLECTIVES, LocalCost, place, settle, unshard

    mesh = DeviceMesh("cuda", torch.arange(2), mesh_dim_names=("data",))
    B, D, F = 8, 64, 96
    with tsharding.use_axis_env(tsharding.AxisEnv(mesh)), torch.enable_grad():
        x = place(torch.empty(B, D, device="meta"), "batch", None)
        w = place(torch.empty(D, F, device="meta"), "fsdp", None).requires_grad_(True)
        with LocalCost() as c:
            y = checkpoint(lambda t: t @ unshard(w, "fsdp"), x, use_reentrant=False)
            (g,) = torch.autograd.grad(settle(y.mean()), (w,))
    want = dict.fromkeys(COLLECTIVES, 0)
    assert c.collectives == want | {"all-gather": 2 * D * F * 4,
                                    "reduce-scatter": D // 2 * F * 4, "all-reduce": 4}
    assert c.calls == want | {"all-gather": 2, "reduce-scatter": 1, "all-reduce": 1}
    assert tuple(g.placements) == tuple(w.placements) and g.to_local().shape == (D // 2, F)


def test_dryrun_sharded_smoke_train(meshes):
    """qwen3-14b's smoke train cell sharded on a fake (data 2, model 2)
    mesh with FSDP: its traced step has all-gathers (the weights, a layer
    at a time, and the forward's layouts), reduce-scatters (the weights'
    gradients) and all-reduces (the row-parallel products, the replicated
    leaves' gradients, AdamW's norm), under ``repro``'s five names, and
    per-device FLOPs x 4 at least the one-device count."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.dist.sharding import COLLECTIVES
    from repro_torch.launch import dryrun

    mesh = DeviceMesh("cuda", torch.arange(4).reshape(2, 2), mesh_dim_names=("data", "model"))
    env = tsharding.AxisEnv(mesh)
    make = lambda n: tcells.build_cell("qwen3-14b", "train_4k", smoke=True, override_layers=n)
    res = dryrun.sharded_cost(make, env, 2)
    coll = res["collectives"]
    assert tuple(coll) == COLLECTIVES and res["collective_bytes_per_chip"] == sum(coll.values())
    assert coll["all-gather"] > 0 and coll["reduce-scatter"] > 0 and coll["all-reduce"] > 0
    one_device = dryrun._traced_flops(make(2))
    assert res["flops_per_chip"] * 4 >= one_device > res["flops_per_chip"]


def test_dryrun_sharded_smoke_moe_prefill(meshes):
    """olmoe-1b-7b's smoke prefill cell sharded on a fake (data 2, model 2)
    mesh: its traced step all-gathers (the experts' outputs over
    ``model``, one a layer, and the attention's k and v) and all-reduces
    (the row-parallel products, the aux loss's sums over the token
    shards), and per-device FLOPs x 4 at least the one-device count (each
    model rank routes its data shard's tokens)."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.dist.sharding import COLLECTIVES
    from repro_torch.launch import dryrun

    mesh = DeviceMesh("cuda", torch.arange(4).reshape(2, 2), mesh_dim_names=("data", "model"))
    env = tsharding.AxisEnv(mesh)
    make = lambda n: tcells.build_cell("olmoe-1b-7b", "prefill_32k", smoke=True,
                                       override_layers=n)
    cell = make(1)
    res = dryrun.sharded_cost(make, env, 2)
    coll = res["collectives"]
    assert tuple(coll) == COLLECTIVES and res["collective_bytes_per_chip"] == sum(coll.values())
    # a layer's expert outputs [E, TB / 2, Cb, D] gathered over model 2:
    # 8 experts, 16 blocks of 2 tokens a data rank, capacity 1, float32
    cfg = cell.args[0].cfg
    y = cfg.moe.n_experts * 16 * 1 * cfg.d_model * 4
    assert coll["all-gather"] >= 2 * y and coll["all-reduce"] > 0
    assert res["collective_calls"]["all-reduce"] >= 2 * 2  # the aux loss: 2 a layer
    one_device = dryrun._traced_flops(make(2))
    assert res["flops_per_chip"] * 4 >= one_device > res["flops_per_chip"]


def test_dryrun_sharded_smoke_moe_train(meshes):
    """olmoe-1b-7b's smoke train cell sharded on a fake (data 2, model 2)
    mesh with FSDP, one step of B 2 x S 64 (one microbatch: a data rank's
    64 tokens fill 16 of the 32 token blocks, capacity 1), counted by hand
    a layer (the trace at 2 layers less the trace at 1), float32:

    - all-gather, 25 calls: the layer's 8 weights whole along ``data``,
      each keeping its ``model`` shard (wq, wk, wv, wo, the router and the
      three expert leaves), in the forward and again in the remat (16); k
      and v whole over ``model`` in both (4); DTensor's own two in the
      attention's backward (a weight product's operands made whole over
      ``model``, as the dense train cells have); the experts' output ``y``
      [E, 16, 1, D] over ``model`` in both (2); the buffer's gradient over
      ``model`` (1).  ``y``'s gather's backward takes a local slice;
    - reduce-scatter, 12: the 8 weights' gradients into their shards, and
      the attention's 4 (k and v, as the dense cells);
    - all-reduce, 9: ``wo``'s partial sums in both passes (2), the aux
      loss's probability sums and counts, E float32 each, in both (4; the
      sums' backward is none: each rank's tokens take the whole loss's
      gradient once), the attention's one in the backward, and the two
      norm scales' gradients (``attn_norm``'s a partial sum over both
      dims, one all-reduce over their flattened group; ``mlp_norm``'s over
      ``data``)."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch import dryrun

    mesh = DeviceMesh("cuda", torch.arange(4).reshape(2, 2), mesh_dim_names=("data", "model"))
    env = tsharding.AxisEnv(mesh)
    make = lambda n: tcells.build_cell("olmoe-1b-7b", "train_4k", smoke=True,
                                       override_layers=n)
    cfg = make(1).args[0].params.cfg
    one, two = (dryrun.sharded_cost(make, env, n) for n in (1, 2))
    D, E, F, HD = cfg.d_model, cfg.moe.n_experts, cfg.moe.d_ff_expert, cfg.n_heads * cfg.d_head
    KV = cfg.n_kv_heads * cfg.d_head
    B, S = make(1).args[1]["tokens"].shape
    rows = B // 2 * S  # a data rank's tokens
    weights = 4 * (3 * D * HD // 2 + HD // 2 * D + D * E + 3 * (E // 2) * D * F)
    y = 4 * E * 16 * 1 * D
    want_calls = {"all-gather": 25, "reduce-scatter": 12, "all-reduce": 9}
    want_bytes = {"all-gather": 2 * weights + 4 * 4 * rows * KV + 2 * 4 * D * rows + 3 * y,
                  "reduce-scatter": weights // 2 + 4 * 4 * rows * KV // 2,
                  "all-reduce": 3 * 4 * rows * D + 4 * 4 * E + 2 * 4 * D}
    for kind in ("all-gather", "reduce-scatter", "all-reduce"):
        assert two["collective_calls"][kind] - one["collective_calls"][kind] == want_calls[kind]
        assert two["collectives"][kind] - one["collectives"][kind] == want_bytes[kind], kind
    assert two["collectives"]["all-to-all"] == 0


TT_SHAPES = ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand")


@pytest.mark.parametrize("arch,shape,item", [("two-tower-retrieval", s, "D.4") for s in TT_SHAPES])
def test_unsharded_cells_name_their_slice(meshes, arch, shape, item):
    """No cell is left unsharded: the two-tower cells (ROADMAP D.4, the
    last) shard on the single-pod mesh, the tables (and a train state's
    ``m`` and ``v``) on ``("rows", None)`` over (data, model), the MLPs
    replicated, the batch on ``batch`` and the candidates on ``rows``."""
    env, _ = meshes["single"]
    cell = tcells.shard_cell(tcells.build_cell(arch, shape), env)
    params = cell.args[0].params if shape == "train_batch" else cell.args[0]
    trees = [params] + ([cell.args[0].m, cell.args[0].v] if shape == "train_batch" else [])
    rows = (tsharding.Shard(0), tsharding.Shard(0))
    for tree in trees:
        for name in ("user_table", "item_table"):
            assert tuple(tree[name].placements) == rows, (shape, name)
        assert tuple(tree["user_mlp"]["w0"].placements) == (tsharding.Replicate(),) * 2
    if shape == "retrieval_cand":
        assert tuple(cell.args[3].placements) == rows
        assert tuple(cell.args[1].placements) == (tsharding.Replicate(),) * 2
    else:
        assert tuple(cell.args[1].user_idx.placements) == (tsharding.Shard(0),
                                                           tsharding.Replicate())


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mixtral-8x7b"])
def test_moe_train_cells_run_sharded(meshes, arch):
    """The MoE train cells trace sharded in the dry run (no null
    collective entry): ``shard_cell`` places their state on the mesh."""
    from torch.distributed.tensor import DTensor

    env, _ = meshes["single"]
    cell = tcells.shard_cell(tcells.build_cell(arch, "train_4k", override_layers=1), env)
    state = cell.args[0]
    assert all(isinstance(p, DTensor) for p in state.params.parameters())
    assert all(isinstance(x, DTensor) for x in state.m.values())


@pytest.mark.parametrize("arch,shape", [("spade-grab", s) for s in ("grab4_static",
                                                                   "grab4_stream")]
                         + [(a, s) for a in ("gcn-cora", "gat-cora", "meshgraphnet", "dimenet")
                            for s in ("full_graph_sm", "minibatch_lg", "ogb_products",
                                      "molecule")])
def test_spade_and_gcn_cells_run_sharded(meshes, arch, shape):
    """``shard_cell`` runs both Spade cells (on the edge-sharded engine)
    and every GNN cell (GCN, GAT, MeshGraphNet and DimeNet; the batch's
    edge arrays on ``edges``), so the dry run traces them."""
    from torch.distributed.tensor import DTensor

    from repro_torch.dist.graph import ShardedGraph

    env, _ = meshes["single"]
    cell = tcells.shard_cell(tcells.build_cell(arch, shape), env)
    if arch == "spade-grab":
        g = cell.args[0] if shape == "grab4_static" else cell.args[0].graph
        assert isinstance(g, ShardedGraph) and cell.fn.keywords["axis"] == ("data",)
    else:
        assert isinstance(cell.args[1].edge_src, DTensor)
        assert tuple(cell.args[1].edge_src.placements)[0] == tsharding.Shard(0)


def test_dryrun_sharded_smoke_gcn(meshes):
    """gcn-cora's smoke train step traced sharded on the single-pod mesh
    (data 16, model 16), hand-counted: per layer one all-gather of ``h``
    over ``model`` (the whole [N, d]) and, in the backward, its reduce-
    scatter; all-reduces of the degrees (over ``data``), each layer's
    aggregate rows (over ``data``) and their gradient rows, the loss's
    numerator and count, and the four parameters' gradients (over
    ``model``)."""
    from repro_torch.launch import dryrun

    env, _ = meshes["single"]
    make = lambda n: tcells.build_cell("gcn-cora", "full_graph_sm", smoke=True)
    res = dryrun.sharded_cost(make, env, None)
    cell = make(None)
    g = cell.args[1]
    N, F = g.node_feat.shape
    cfg = cell.args[0].params["w"][0].shape, cell.args[0].params["w"][1].shape
    H, C = cfg[0][1], cfg[1][1]
    rows = N // 16
    calls, coll = res["collective_calls"], res["collectives"]
    assert calls == {"all-gather": 2, "all-reduce": 11, "reduce-scatter": 2, "all-to-all": 0,
                     "collective-permute": 0}
    assert coll["all-gather"] == 4 * N * (H + C)
    assert coll["reduce-scatter"] == 4 * rows * (H + C)
    params = sum(p.numel() for p in cell.args[0].params["w"] + cell.args[0].params["b"])
    assert coll["all-reduce"] == 4 * N + 2 * 4 * rows * (H + C) + 4 + 8 + 4 * params


def _gnn_hand_count(arch: str, cell, rows: int, e_block: int) -> tuple[dict, dict]:
    """(calls, bytes) by kind of one sharded smoke train step of ``arch``
    on (data 16, model 16), counted by hand (float32; the bytes are each
    collective's output).  Every kind: the loss's numerator and count
    (two all-reduces, 4 + 8 B) and one all-reduce a parameter leaf (its
    partial gradient settled: over ``model`` for a node-level weight,
    over the flattened (data, model) group for one the edges read).

    - GAT, a layer: ``h`` [N, heads d] gathered over ``model`` and, in the
      backward, reduce-scattered to the rank's rows; all-reduces over
      ``data``: the softmax's max and denominator [rows, heads], the
      messages' row sums [rows, heads, d], in the backward the
      denominator's gradient and ``h``'s rows' gradient.
    - MeshGraphNet, a processor step: ``h`` [N, H] gathered in the forward
      and again in the remat's recompute, its gradient reduce-scattered
      once; the aggregate's rows [rows, H] settled in both passes and
      ``h``'s rows' gradient all-reduced over ``data``.
    - DimeNet: ``x`` [N, H] gathered and its gradient reduce-scattered,
      ``edge_len`` [E] gathered over ``data``, ``per_node``'s rows settled
      and ``x``'s rows' gradient all-reduced; a block: ``m`` [E, H]
      gathered over ``data`` in the forward, the recompute and the
      backward of the triplets' sums, and [E_b, H] reduce-scattered as
      often (the sums in both passes, ``m``'s gradient)."""
    g, params = cell.args[1], cell.args[0].params
    N, E = g.node_feat.shape[0], g.edge_src.shape[0]
    leaves = [x for _, x in tgnn.flatten_params(params)]
    calls = {"all-reduce": 2 + len(leaves)}
    coll = {"all-reduce": 12 + 4 * sum(x.numel() for x in leaves)}
    if arch == "gat-cora":
        hd = [lp["a_src"].shape for lp in params["layers"]]
        calls.update({"all-gather": len(hd), "reduce-scatter": len(hd)})
        calls["all-reduce"] += 5 * len(hd)
        coll["all-gather"] = sum(4 * N * h * d for h, d in hd)
        coll["reduce-scatter"] = sum(4 * rows * h * d for h, d in hd)
        coll["all-reduce"] += sum(3 * 4 * rows * h + 2 * 4 * rows * h * d for h, d in hd)
    elif arch == "meshgraphnet":
        L, H = params["proc_edge"]["w0"].shape[0], params["proc_edge"]["w0"].shape[2]
        calls.update({"all-gather": 2 * L, "reduce-scatter": L})
        calls["all-reduce"] += 3 * L
        coll["all-gather"] = 2 * L * 4 * N * H
        coll["reduce-scatter"] = L * 4 * rows * H
        coll["all-reduce"] += 3 * L * 4 * rows * H
    else:
        L, H = params["blocks"]["w_msg"].shape[:2]
        calls.update({"all-gather": 2 + 3 * L, "reduce-scatter": 1 + 3 * L})
        calls["all-reduce"] += 2
        coll["all-gather"] = 4 * N * H + 4 * E + 3 * L * 4 * E * H
        coll["reduce-scatter"] = 4 * rows * H + 3 * L * 4 * e_block * H
        coll["all-reduce"] += 2 * 4 * rows * H
    zero = {"all-to-all": 0, "collective-permute": 0}
    return calls | zero, coll | zero


@pytest.mark.parametrize("arch", ["gat-cora", "meshgraphnet", "dimenet"])
def test_dryrun_sharded_smoke_gnn(meshes, arch):
    """GAT's, MeshGraphNet's and DimeNet's smoke train steps traced sharded
    on the single-pod mesh (data 16, model 16): every collective's calls
    and bytes as :func:`_gnn_hand_count` counts them."""
    from repro_torch.launch import dryrun

    env, _ = meshes["single"]
    make = lambda n: tcells.build_cell(arch, "full_graph_sm", smoke=True)
    res = dryrun.sharded_cost(make, env, None)
    cell = make(None)
    g = cell.args[1]
    calls, coll = _gnn_hand_count(arch, cell, g.node_feat.shape[0] // 16,
                                  g.edge_src.shape[0] // 16)
    assert res["collective_calls"] == calls
    assert res["collectives"] == coll


def _two_tower_hand_count(shape: str, cfg, B: int) -> tuple[dict, dict]:
    """A two-tower smoke cell's collectives a rank on (data 2, model 2),
    float32 and int32 (four bytes), by hand.  A tower with ``F`` fields
    (one chunk): its batch rows' lookups and weights all-gathered over
    ``data`` ([B, F, M] each), the partial bags reduce-scattered over
    ``data`` to the rank's [B / 2, F D] and all-reduced over ``model``.
    A train step adds: the item embeddings [B, K] and ``log_q`` [B]
    gathered, the loss's and accuracy's sums all-reduced (one element
    each); in the backward each bag's gradient [B, F D] all-gathered, the
    item embeddings' gradient reduce-scattered, one all-reduce a
    replicated leaf's gradient (the MLPs' and ``temp``) and AdamW's norm
    (one element).  Retrieval: the query's bag [1, Fu D] all-reduced over
    (data, model), then the ranks' top-100 (score, index) pairs, float64
    [100, 2], gathered over them."""
    D, M, K = cfg.embed_dim, cfg.multi_hot, cfg.tower_mlp[-1]
    fields = (cfg.n_user_fields, cfg.n_item_fields)
    calls = dict.fromkeys(("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                           "collective-permute"), 0)
    coll = dict(calls)

    def add(kind, nbytes, n=1):
        calls[kind] += n
        coll[kind] += nbytes

    if shape == "retrieval_cand":
        add("all-reduce", 4 * cfg.n_user_fields * D)
        add("all-gather", 8 * 2 * 100 * 4)
        return calls, coll
    for F in fields:
        add("all-gather", 2 * 4 * B * F * M, 2)
        add("reduce-scatter", 4 * B // 2 * F * D)
        add("all-reduce", 4 * B // 2 * F * D)
    if shape == "train_batch":
        add("all-gather", 4 * B * K + 4 * B, 2)
        add("all-reduce", 4 + 4, 2)
        for F in fields:
            add("all-gather", 4 * B * F * D)
        add("reduce-scatter", 4 * B // 2 * K)
        for F in fields:
            dims = [F * D, *cfg.tower_mlp]
            add("all-reduce", 4 * sum(a * b + b for a, b in zip(dims[:-1], dims[1:])),
                2 * (len(dims) - 1))
        add("all-reduce", 4 + 4, 2)  # temp's gradient, AdamW's norm
    return calls, coll


@pytest.mark.parametrize("shape", TT_SHAPES)
def test_dryrun_sharded_smoke_two_tower(meshes, shape):
    """The two-tower smoke cells traced sharded on a fake (data 2, model
    2) mesh, as the dry run traces them: every collective's calls and
    bytes as :func:`_two_tower_hand_count` counts them, and the traced
    rank's FLOPs."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch import dryrun

    mesh = DeviceMesh("cuda", torch.arange(4).reshape(2, 2), mesh_dim_names=("data", "model"))
    env = tsharding.AxisEnv(mesh)
    make = lambda n: tcells.build_cell("two-tower-retrieval", shape, smoke=True)
    res = dryrun.sharded_cost(make, env, None)
    cell = make(None)
    B = cell.args[1].user_idx.shape[0] if shape != "retrieval_cand" else 1
    calls, coll = _two_tower_hand_count(shape, get_smoke_config("two-tower-retrieval"), B)
    assert res["collective_calls"] == calls
    assert res["collectives"] == coll
    assert res["collective_bytes_per_chip"] == sum(coll.values())
    assert res["flops_per_chip"] > 0


def test_dryrun_subprocess_two_tower_cells(tmp_path):
    """The dry run of the two-tower family on both production meshes: 8
    entries, none with a null collective count (ROADMAP C.9)."""
    text, results = _dryrun(tmp_path, "--family", "recsys", "--mesh", "both")
    assert "8 cells, 0 failures" in text and len(results) == 8
    for res in results:
        assert res["status"] == "OK" and "collective_bytes_reason" not in res
        assert res["collective_bytes_per_chip"] == sum(res["collectives"].values()) > 0
        assert res["t_collective_s"] == res["collective_bytes_per_chip"] / 450e9
        assert 0 < res["flops_per_chip"] and res["dominant"] in ("compute", "memory", "collective")
