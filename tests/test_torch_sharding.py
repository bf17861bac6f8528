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
shard shapes of every cell on both production meshes.
"""

from __future__ import annotations

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
from repro_torch.configs import Skip, all_cells  # noqa: E402
from repro_torch.dist import sharding as tsharding  # noqa: E402
from repro_torch.launch import cells as tcells  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
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
    assert "0 failures" in text
    assert res["status"] == "OK" and res["n_chips"] == 512 and res["mesh"] == "multi"
    assert res["collective_bytes_per_chip"] is None and "HLO" in res["collective_bytes_reason"]
    assert res["flops"] > 0 and res["flops_per_chip"] == res["flops"] / 512
    assert res["argument_bytes"] < res["argument_bytes_global"]
    assert res["dominant"] in ("compute", "memory") and "meta_run" not in res


def test_dryrun_spade_cells_report_meta_run(tmp_path):
    text, results = _dryrun(tmp_path, "--family", "spade", "--mesh", "single")
    assert "2 cells, 0 failures" in text
    for res in results:
        assert res["status"] == "OK" and "flops" not in res
        assert "meta" in res["meta_run"] and res["argument_bytes"] > 0
    static, stream = results  # sorted by file name: grab4_static, grab4_stream
    assert static["step_name"] == "bulk_peel" and stream["step_name"] == "insert_and_maintain"
    assert stream["argument_bytes"] > static["argument_bytes"]  # the state beside the graph
