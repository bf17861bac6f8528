"""Graph store, stream generator and semantics of the port against the JAX
reference, and the port's import boundary.

Tolerances: buffers and DG/DW weights are bit-identical.  FD weights
(``1/log(deg + 5)``) agree to 2 float32 ulps: torch's and XLA's ``log``
differ in the last bit on some lanes.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import semantics as jsem  # noqa: E402
from repro.graphstore import generators as jgen  # noqa: E402
from repro.graphstore import structs as jst  # noqa: E402
from repro_torch.core import semantics as tsem  # noqa: E402
from repro_torch.graphstore import generators as tgen  # noqa: E402
from repro_torch.graphstore import structs as tst  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
FIELDS = ("src", "dst", "c", "edge_mask", "a", "vertex_mask")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed,scenario", [(9, "join"), (4, "burst")])
def test_transaction_stream_byte_identical(seed, scenario):
    kw = dict(n=2000, m=9000, seed=seed, scenario=scenario)
    a, b = jgen.make_transaction_stream(**kw), tgen.make_transaction_stream(**kw)
    assert a.n_vertices == b.n_vertices
    for f in ("base_src", "base_dst", "base_amt", "inc_src", "inc_dst",
              "inc_amt", "inc_time", "fraud_label", "fraud_block"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert x.tobytes() == y.tobytes(), f
    assert tgen.DATASET_STATS == jgen.DATASET_STATS


def assert_graph_equal(tg, jg, tag=""):
    assert (tg.n_capacity, tg.e_capacity) == (jg.n_capacity, jg.e_capacity)
    for f in FIELDS:
        x, y = getattr(tg, f).numpy(), np.asarray(getattr(jg, f))
        assert x.dtype == y.dtype, f"{tag}:{f}"
        np.testing.assert_array_equal(x, y, err_msg=f"{tag}:{f}")


@pytest.mark.parametrize("seed", range(3))
def test_append_remove_sequences_buffer_equal(seed):
    """Random append (with interior-invalid lanes, and past capacity) and
    remove sequences leave both packages' buffers equal, and so do their
    peel weights and totals."""
    rng = np.random.default_rng(seed)
    n, m, V, E, B = 40, 30, 48, 96, 8
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    c = rng.integers(1, 6, m).astype(np.float32)
    a = rng.integers(0, 3, n).astype(np.float32)
    jg = jst.device_graph_from_coo(n, src, dst, c, a, n_capacity=V, e_capacity=E)
    tg = tst.device_graph_from_coo(n, src, dst, c, a, n_capacity=V, e_capacity=E,
                                   device="cpu")
    assert_graph_equal(tg, jg, "coo")
    count = m
    for step in range(14):
        if rng.random() < 0.55:
            bs = rng.integers(0, n, B).astype(np.int32)
            bd = rng.integers(0, n, B).astype(np.int32)
            bc = rng.integers(1, 6, B).astype(np.float32)
            valid = rng.random(B) < 0.7
            jg = jst.append_edges(jg, jnp.int32(count), jnp.asarray(bs),
                                  jnp.asarray(bd), jnp.asarray(bc), jnp.asarray(valid))
            tg = tst.append_edges(tg, torch.tensor(count, dtype=torch.int32),
                                  torch.from_numpy(bs), torch.from_numpy(bd),
                                  torch.from_numpy(bc), torch.from_numpy(valid))
            count = min(count + int(valid.sum()), E)
        else:
            drop = rng.random(E) < 0.25
            jg, jn = jst.remove_edges(jg, jnp.asarray(drop))
            tg, tn = tst.remove_edges(tg, torch.from_numpy(drop))
            assert int(tn) == int(jn) and tn.dtype == torch.int32
            count -= int(tn)
        assert_graph_equal(tg, jg, f"step{step}")
        np.testing.assert_array_equal(tg.peel_weights().numpy(),
                                      np.asarray(jg.peel_weights()))
        assert float(tg.f_total()) == float(jg.f_total())


def test_append_drops_out_of_capacity_lanes_without_clamping():
    """Lanes past capacity are dropped (JAX mode="drop"), not clamped onto
    the last slot."""
    g = tst.device_graph_from_coo(4, np.array([0, 1]), np.array([1, 2]),
                                  n_capacity=4, e_capacity=4, device="cpu")
    bs = torch.tensor([2, 3, 0, 1], dtype=torch.int32)
    g2 = tst.append_edges(g, torch.tensor(2, dtype=torch.int32), bs, bs + 0,
                          torch.full((4,), 7.0))
    assert g2.src.tolist() == [0, 1, 2, 3]
    assert g2.c.tolist() == [1.0, 1.0, 7.0, 7.0]
    assert g.src.tolist() == [0, 1, 3, 3]  # the input graph is untouched


def _batch(seed, B, n):
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, 6, B).astype(np.int32)  # many same-destination runs
    src = rng.integers(0, n, B).astype(np.int32)
    raw = rng.lognormal(2.0, 1.0, B).astype(np.float32)
    valid = rng.random(B) < 0.8
    deg = rng.integers(0, 9, n).astype(np.int32)
    return deg, src, dst, raw, valid


@pytest.mark.parametrize("name", ["DG", "DW", "FD"])
def test_batch_weights_match_reference(name):
    """DG/DW weights and every new degree vector are exact; FD weights to
    2 float32 ulps (the frameworks' ``log`` differ in the last bit)."""
    deg, src, dst, raw, valid = _batch(3, 64, 12)
    jw, jdeg = jsem.resolve(name).batch_weights(
        *[jnp.asarray(x) for x in (deg, src, dst, raw, valid)])
    tw, tdeg = tsem.resolve(name).batch_weights(
        *[torch.from_numpy(x) for x in (deg, src, dst, raw, valid)])
    assert tw.dtype == torch.float32 and tdeg.dtype == torch.int32
    np.testing.assert_array_equal(tdeg.numpy(), np.asarray(jdeg))
    if name == "FD":
        np.testing.assert_array_max_ulp(tw.numpy(), np.asarray(jw), maxulp=2)
    else:
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


def test_semantics_numpy_half_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.lognormal(0.0, 3.0, 1000)
    np.testing.assert_array_equal(tsem.quantize_susp_array(x),
                                  jsem.quantize_susp_array(x))
    assert tsem.quantize_susp(0.1) == jsem.quantize_susp(0.1)
    assert set(jsem.available()) >= set(tsem.available()) >= {"DG", "DW", "FD"}
    src, dst = rng.integers(0, 50, 400), rng.integers(0, 50, 400)
    raw = rng.lognormal(2.0, 1.0, 400)
    for name in ("DG", "DW", "FD"):
        jw, jdeg = jsem.resolve(name).seed_base(src, dst, raw, 50)
        tw, tdeg = tsem.resolve(name).seed_base(src, dst, raw, 50)
        assert tw.tobytes() == jw.tobytes() and tdeg.tobytes() == jdeg.tobytes()
    with pytest.raises(KeyError, match="DG/DW/FD"):
        tsem.resolve("nope")


def test_xp_shim_runs_numpy_style_hooks_on_tensors():
    """The README's time-decayed hook, written once against ``xp``."""
    def hook(xp, src, dst, raw, deg, t):
        return xp.maximum(raw, 1e-12) * 2.0 ** (-(4.0 - t) / 2.0)

    raw = np.array([0.0, 1.5, 3.0], np.float32)
    t = np.array([0.0, 2.0, 4.0], np.float32)
    got = hook(tsem._xp, None, None, torch.from_numpy(raw), None, torch.from_numpy(t))
    want = hook(jnp, None, None, jnp.asarray(raw), None, jnp.asarray(t))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_port_imports_neither_jax_nor_repro():
    """Every module of ``repro_torch``, every example twin
    (``examples/torch_*.py``) and ``chip_smoke.py`` import in a fresh
    interpreter without pulling in ``jax`` or anything of ``repro``."""
    code = (
        "import importlib, importlib.util, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "for n in ('repro_torch.core.reference', 'repro_torch.core.spade',\n"
        "          'repro_torch.core.metrics', 'repro_torch.serve.service',\n"
        "          'repro_torch.configs.spade_grab', 'repro_torch._warnings',\n"
        "          'repro_torch.dist.graph', 'repro_torch.dist.spawn',\n"
        "          'repro_torch.dist.compression', 'repro_torch.train.optimizer',\n"
        "          'repro_torch.train.train_step', 'repro_torch.ft.checkpoint',\n"
        "          'repro_torch.ft.elastic', 'repro_torch.pytree',\n"
        "          'repro_torch.models.two_tower', 'repro_torch.graphstore.sampler',\n"
        "          'repro_torch.dist.sharding', 'repro_torch.launch.mesh',\n"
        "          'repro_torch.launch.cells', 'repro_torch.launch.dryrun',\n"
        "          'repro_torch.launch.train', 'repro_torch.core.device_metrics',\n"
        "          'repro_torch.serve.device_service', 'repro_torch.data'):\n"
        "    assert n in names, n\n"
        f"files = sorted(__import__('glob').glob({str(ROOT / 'examples' / 'torch_*.py')!r}))\n"
        f"files.append({str(ROOT / 'chip_smoke.py')!r})\n"
        "for f in files:\n"
        "    spec = importlib.util.spec_from_file_location('_twin', f)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "assert len(names) >= 72 and len(files) == 8, (names, files)\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
