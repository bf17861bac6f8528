"""The port's fault-tolerance layer (``repro_torch.ft``: checkpoints,
elastic re-planning, the straggler watchdog; with ``repro_torch.train``
and ``repro_torch.dist.compression``) on the CPU: twins of the nine cases
of ``tests/test_ft.py``, and checkpoints crossing between the packages.

Checkpoints are the reference's layout on disk: the same manifest
(``paths``, ``dtypes``, ``shapes``, ``n_leaves``, ``step``) and, for
float32 and int leaves, byte-identical ``leaf_*.npy`` files.  A bf16 leaf
has the same data bytes; only its header may differ, since numpy writes a
plain two-byte void dtype as ``'|V2'`` where ``ml_dtypes`` writes
``'<V2'``.  The reference's ``load_pytree`` cannot restore a bf16 leaf
(``jax.device_put`` refuses the ``|V2`` array; ROADMAP C.8), so bf16
checkpoints are crossed only from the reference to the port here.

Tolerances: the resume case is bit for bit (the same steps on the same
device); the tiny-loss case of the twin keeps the reference's rtol 1e-6.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_get_smoke_config  # noqa: E402
from repro.ft import checkpoint as jckpt  # noqa: E402
from repro.models import gnn as jgnn  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import train_state_from_numpy, train_state_to_numpy  # noqa: E402
from repro_torch.dist.compression import compress_grads  # noqa: E402
from repro_torch.ft import (CheckpointManager, MeshPlan, StepWatchdog,  # noqa: E402
                            best_mesh_for, latest_step, load_pytree, replan, save_pytree)
from repro_torch.models import GNN, TransformerLM, lm_loss  # noqa: E402
from repro_torch.train import AdamConfig, init_train_state, make_train_step  # noqa: E402


def tiny_state():
    params = {"w": torch.arange(12.0).reshape(3, 4), "b": torch.ones(4)}
    return init_train_state(params)


def _linear_loss(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    return torch.mean((pred - batch["y"]) ** 2), {}


def _batch(rng, n):
    return {"x": torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)),
            "y": torch.from_numpy(rng.normal(size=(n, 4)).astype(np.float32))}


# ---------------------------------------------------------------------------
# the nine cases of tests/test_ft.py
# ---------------------------------------------------------------------------


def test_save_load_roundtrip(tmp_path):
    st = tiny_state()
    d = str(tmp_path / "ckpt")
    save_pytree(st, d, step=7)
    assert latest_step(d) == 7
    st2 = load_pytree(st, d)
    assert torch.equal(st2.params["w"], st.params["w"]) and st2.params["w"] is not st.params["w"]
    assert int(st2.step) == 0 and st2.step.dtype == torch.int32 and st2.err is None


def test_keep_k_retention_and_async(tmp_path):
    d = str(tmp_path / "ckpt")
    mgr = CheckpointManager(d, keep=2, every_steps=1)
    st = tiny_state()
    for i in range(1, 6):
        mgr.maybe_save(st, i)
    mgr.close()
    steps = sorted(int(x.split("_")[1]) for x in os.listdir(d) if x.startswith("step_"))
    assert steps == [4, 5]
    mgr.check()
    assert not mgr._worker.is_alive()


def test_atomic_commit_no_tmp_left(tmp_path):
    d = str(tmp_path / "ckpt")
    save_pytree(tiny_state(), d, step=1)
    assert not any(x.endswith(".tmp") for x in os.listdir(d))


def test_resume_training_equivalence(tmp_path):
    """Train 4 steps straight == train 2, checkpoint, restore, train 2."""
    step = make_train_step(_linear_loss, AdamConfig(lr=1e-2, weight_decay=0.0))
    batch = _batch(np.random.default_rng(0), 8)
    sA = tiny_state()
    for _ in range(4):
        sA, _ = step(sA, batch)

    sB = tiny_state()
    for _ in range(2):
        sB, _ = step(sB, batch)
    d = str(tmp_path / "ck")
    save_pytree(sB, d, step=2)
    sB2 = load_pytree(tiny_state(), d)
    for _ in range(2):
        sB2, _ = step(sB2, batch)
    np.testing.assert_allclose(sA.params["w"].detach().numpy(),
                               sB2.params["w"].detach().numpy(), rtol=1e-6)


def test_elastic_reshard_restore(tmp_path):
    """A checkpoint restores onto the device of a smaller mesh (the mesh
    record's one device; on the card that is a cuda index)."""
    st = tiny_state()
    d = str(tmp_path / "ck")
    save_pytree(st, d, step=1)
    mesh = best_mesh_for(1, 1)
    assert isinstance(mesh, MeshPlan) and mesh.devices.tolist() == [[0]]
    assert mesh.axis_names == ("data", "model") and mesh.shape == {"data": 1, "model": 1}
    st2 = load_pytree(st, d, device="cpu")
    assert torch.equal(st2.params["b"], st.params["b"])
    assert st2.params["b"].device.type == "cpu"


def test_replan_preserves_global_batch():
    plan = replan(n_devices=1, model_axis=1, global_batch=64)
    assert plan.global_batch == 64
    assert plan.per_replica_batch * plan.mesh.devices.shape[0] == 64
    with pytest.raises(ValueError):
        best_mesh_for(1, model_axis=2)
    plan = replan(n_devices=8, model_axis=2, global_batch=6)  # dp 4 -> 3
    assert plan.mesh.shape == {"data": 3, "model": 2} and plan.per_replica_batch == 2
    assert plan.mesh.devices.tolist() == [[0, 1], [2, 3], [4, 5]]


def test_watchdog_flags_stragglers():
    seen = []
    dog = StepWatchdog(factor=3.0, min_history=3, on_straggler=lambda s, t: seen.append(s))
    for i in range(5):
        assert not dog.observe(i, 1.0)
    assert dog.observe(5, 10.0)
    assert dog.flagged == [5] == seen
    assert not dog.observe(6, 1.1)


def test_compression_error_feedback_converges():
    """EF compression: quantization error is re-injected, so the running sum
    of dequantized grads tracks the true sum."""
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.normal(size=(256,)).astype(np.float32)) * 0.01
    err = torch.zeros_like(g)
    total_true, total_deq = np.zeros(256), np.zeros(256)
    for _ in range(50):
        deq, err = compress_grads(g, err)
        total_true += g.numpy()
        total_deq += deq.numpy()
    # relative drift of the accumulated signal stays bounded by one quantum
    scale = np.abs(g.numpy()).max() / 127.0
    assert np.abs(total_true - total_deq).max() <= scale + 1e-6


def test_compressed_training_still_learns():
    step = make_train_step(
        _linear_loss,
        AdamConfig(lr=1e-2, weight_decay=0.0, warmup_steps=1, total_steps=10_000),
        compress=True,
    )
    rng = np.random.default_rng(1)
    params = {"w": torch.from_numpy(rng.normal(size=(3, 4)).astype(np.float32)),
              "b": torch.zeros(4)}
    st = init_train_state(params, with_error_feedback=True)
    batch = _batch(rng, 32)
    l0 = None
    for i in range(30):
        st, m = step(st, batch)
        if i == 0:
            l0 = float(m["loss"])
    assert float(m["loss"]) < l0 * 0.7


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------


def _reference_state(kind: str):
    """(the reference's TrainState, its numpy form, the port's config):
    ``lm-bf16``, qwen3-14b's smoke LM in bf16 with error-feedback buffers;
    ``lm-f32``, mixtral-8x7b's (virtual experts); ``gnn``, gcn-cora's."""
    rng = np.random.default_rng(9)
    gen = torch.Generator().manual_seed(3)
    if kind == "gnn":
        cfg, jcfg = tconfigs.get_smoke_config("gcn-cora"), j_get_smoke_config("gcn-cora")
        params = GNN(cfg, 8, device="cpu", generator=gen).params()
    else:
        arch = "qwen3-14b" if kind == "lm-bf16" else "mixtral-8x7b"
        dtype = "bfloat16" if kind == "lm-bf16" else "float32"
        cfg = dataclasses.replace(tconfigs.get_smoke_config(arch), dtype=dtype)
        jcfg = dataclasses.replace(j_get_smoke_config(arch), dtype=dtype)
        params = TransformerLM(cfg, device="cpu", generator=gen)
    # the weights drawn by the port, in the reference's layout (bf16 typed),
    # held to the structure, shapes and dtypes of the reference's own init
    params = jax.tree.map(lambda x: jnp.asarray(x.view(jnp.bfloat16) if x.dtype == np.uint16
                                                else x),
                          train_state_to_numpy(init_train_state(params)).params)
    init = (lambda: jgnn.init_gnn_params(jax.random.PRNGKey(0), jcfg, 8, 4)) \
        if kind == "gnn" else (lambda: jtf.init_lm_params(jax.random.PRNGKey(0), jcfg))
    want = jax.eval_shape(init)
    assert jax.tree.structure(params) == jax.tree.structure(want)
    assert all(x.shape == w.shape and x.dtype == w.dtype
               for x, w in zip(jax.tree.leaves(params), jax.tree.leaves(want)))
    st = jopt.init_train_state(params, kind == "lm-bf16")
    noise = lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32))
    st = dataclasses.replace(st, step=jnp.int32(5), m=jax.tree.map(noise, st.m),
                             v=jax.tree.map(noise, st.v))
    return st, jax.tree.map(np.asarray, st), cfg


def _npy(path: str) -> tuple[bytes, bytes]:
    """(header, data) of a .npy file."""
    with open(path, "rb") as f:
        raw = f.read()
    n = 10 + int.from_bytes(raw[8:10], "little")  # format 1.0
    return raw[:n], raw[n:]


@pytest.mark.parametrize("kind", ["lm-bf16", "lm-f32", "gnn"])
def test_checkpoint_layout_matches_reference(tmp_path, kind):
    j_state, state_np, cfg = _reference_state(kind)
    jckpt.save_pytree(j_state, str(tmp_path / "j"), step=5)
    state = train_state_from_numpy(state_np, cfg, "cpu")
    save_pytree(state, str(tmp_path / "t"), step=5)
    man = [json.load(open(tmp_path / w / "step_00000005" / "manifest.json")) for w in "jt"]
    for key in ("step", "n_leaves", "paths", "dtypes", "shapes"):
        assert man[0][key] == man[1][key], key
    assert ("bfloat16" in man[0]["dtypes"]) == (kind == "lm-bf16")
    assert "int32" in man[0]["dtypes"]
    for i, dt in enumerate(man[0]["dtypes"]):
        j_head, j_data = _npy(str(tmp_path / "j" / "step_00000005" / f"leaf_{i:05d}.npy"))
        t_head, t_data = _npy(str(tmp_path / "t" / "step_00000005" / f"leaf_{i:05d}.npy"))
        assert t_data == j_data, man[0]["paths"][i]
        if dt == "bfloat16":
            assert t_head == j_head.replace(b"'<V2'", b"'|V2'"), man[0]["paths"][i]
        else:
            assert t_head == j_head, man[0]["paths"][i]


@pytest.mark.parametrize("kind", ["lm-f32", "gnn"])
def test_reference_restores_port_checkpoint(tmp_path, kind):
    j_state, state_np, cfg = _reference_state(kind)
    save_pytree(train_state_from_numpy(state_np, cfg, "cpu"), str(tmp_path), step=5)
    like = jopt.init_train_state(jax.tree.map(jnp.zeros_like, j_state.params))
    restored = jckpt.load_pytree(like, str(tmp_path))
    for (p, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(restored)[0],
                              jax.tree_util.tree_flatten_with_path(j_state)[0]):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a), np.asarray(b)), p


@pytest.mark.parametrize("kind", ["lm-bf16", "lm-f32", "gnn"])
def test_port_restores_reference_checkpoint(tmp_path, kind):
    """Into a port state of other values (another seed, step 0), bit for
    bit, bf16 leaves through the manifest's dtype."""
    j_state, state_np, cfg = _reference_state(kind)
    jckpt.save_pytree(j_state, str(tmp_path), step=5)
    other = jax.tree.map(np.asarray, jopt.init_train_state(
        jax.tree.map(jnp.zeros_like, j_state.params), j_state.err is not None))
    like = train_state_from_numpy(other, cfg, "cpu")
    got = train_state_to_numpy(load_pytree(like, str(tmp_path)))
    want = jax.tree.map(lambda x: x.view(np.uint16) if x.dtype.name == "bfloat16" else x,
                        state_np)
    for field in ("params", "m", "v", "err", "step"):
        a, b = getattr(got, field), getattr(want, field)
        assert jax.tree.structure(a) == jax.tree.structure(b), field
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            assert x.dtype == y.dtype and np.array_equal(x, y), field
    with pytest.raises(ValueError, match="tree structure"):
        load_pytree(tiny_state(), str(tmp_path))


def test_lm_resume_through_manager_bit_identical(tmp_path):
    """The smoke qwen3-14b LM: 4 steps straight give the bits of 2 steps,
    a ``CheckpointManager`` save, a restore into a fresh state, 2 steps."""
    cfg = tconfigs.get_smoke_config("qwen3-14b")
    weights = TransformerLM(cfg, device="cpu", generator=torch.Generator().manual_seed(6))

    def fresh():
        model = TransformerLM(cfg, device="cpu", init=False)
        model.load_state_dict(weights.state_dict())
        return init_train_state(model)

    rng = np.random.default_rng(2)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16)))
    step = make_train_step(lambda m, b: lm_loss(m, b, b.roll(-1, 1)),
                           AdamConfig(lr=1e-2, warmup_steps=1))
    a = fresh()
    for _ in range(4):
        a, _ = step(a, tok)
    b = fresh()
    mgr = CheckpointManager(str(tmp_path), keep=1, every_steps=2)
    for i in range(1, 3):
        b, _ = step(b, tok)
        mgr.maybe_save(b, i)
    mgr.wait()
    mgr.check()
    b = load_pytree(fresh(), str(tmp_path))
    mgr.close()
    assert int(b.step) == 2 and latest_step(str(tmp_path)) == 2
    for _ in range(2):
        b, _ = step(b, tok)
    x, y = train_state_to_numpy(a), train_state_to_numpy(b)
    for field in ("params", "m", "v", "step"):
        for u, w in zip(jax.tree.leaves(getattr(x, field)), jax.tree.leaves(getattr(y, field))):
            assert np.array_equal(u, w), field
