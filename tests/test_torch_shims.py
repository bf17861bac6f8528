"""The port's deprecated shims (``repro_torch.core.device_metrics``,
``repro_torch.serve.device_service``): each warns with
``SpadeDeprecationWarning`` and gives what the semantics objects and
``SpadeService`` give (exactly: the same operations), and the weights
match the JAX package's shims on the same numpy inputs (float32 at rtol
1e-6: ``log`` is evaluated by another library)."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import device_metrics as jdm  # noqa: E402
from repro_torch._warnings import SpadeDeprecationWarning  # noqa: E402
from repro_torch.core import device_metrics as tdm  # noqa: E402
from repro_torch.core import semantics  # noqa: E402
from repro_torch.core import xp  # noqa: E402
from repro_torch.graphstore.generators import make_transaction_stream  # noqa: E402
from repro_torch.serve import EngineSpec, SpadeService, run_device_service  # noqa: E402

TIMING = {"mean_tick_seconds", "mean_us_per_edge", "tick_seconds"}


def _inputs():
    rng = np.random.default_rng(0)
    n, m = 50, 200
    return (rng.integers(0, n, m), rng.integers(0, n, m),
            rng.lognormal(3, 1, m).astype(np.float32), n)


@pytest.mark.parametrize("metric", ["DG", "DW", "FD"])
def test_seed_base_weights_shim(metric):
    src, dst, amt, n = _inputs()
    with pytest.warns(SpadeDeprecationWarning, match="seed_base"):
        w, deg = tdm.seed_base_weights(metric, src, dst, amt, n)
    want_w, want_deg = semantics.resolve(metric).seed_base(src, dst, amt, n)
    assert np.array_equal(w, want_w) and np.array_equal(deg, want_deg)
    with pytest.warns(DeprecationWarning):
        jw, jdeg = jdm.seed_base_weights(metric, src, dst, amt, n)
    assert np.array_equal(w, jw) and np.array_equal(deg, jdeg)
    with pytest.raises(ValueError, match="C = 5.0"), pytest.warns(SpadeDeprecationWarning):
        tdm.seed_base_weights(metric, src, dst, amt, n, C=4.0)


def test_weight_shims_match_semantics_and_jax():
    _, dst, amt, n = _inputs()
    a = torch.from_numpy(amt - 30.0)  # some amounts below 0: DW clamps
    deg = torch.from_numpy(np.arange(200, dtype=np.int32) % 7)
    cases = [
        (tdm.dg_weights, (a,), semantics.DG.esusp(xp, None, None, a, None, None),
         jdm.dg_weights, (jnp.asarray(a.numpy()),)),
        (tdm.dw_weights, (a,), semantics.DW.esusp(xp, None, None, a, None, None),
         jdm.dw_weights, (jnp.asarray(a.numpy()),)),
        (tdm.fd_weights, (deg,), semantics.FD.esusp(xp, None, None, None, deg, None),
         jdm.fd_weights, (jnp.asarray(deg.numpy()),)),
    ]
    for shim, args, want, jshim, jargs in cases:
        with pytest.warns(SpadeDeprecationWarning):
            got = shim(*args)
        assert torch.equal(got, want), shim.__name__
        with pytest.warns(DeprecationWarning):
            jgot = np.asarray(jshim(*jargs))
        np.testing.assert_allclose(got.numpy(), jgot, rtol=1e-6, err_msg=shim.__name__)

    in_deg = torch.from_numpy(np.arange(n, dtype=np.int32) % 3)
    d = torch.from_numpy(dst.astype(np.int32))
    valid = torch.from_numpy(np.arange(200) % 5 != 0)
    with pytest.warns(SpadeDeprecationWarning, match="batch_weights"):
        w, new_deg = tdm.fd_batch_weights(in_deg, d, valid)
    want_w, want_deg = semantics.FD.batch_weights(in_deg, d, d, torch.zeros(200), valid)
    assert torch.equal(w, want_w) and torch.equal(new_deg, want_deg)
    with pytest.warns(DeprecationWarning):
        jw, jdeg = jdm.fd_batch_weights(jnp.asarray(in_deg.numpy()), jnp.asarray(d.numpy()),
                                        jnp.asarray(valid.numpy()))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6)
    assert np.array_equal(new_deg.numpy(), np.asarray(jdeg))


def test_run_device_service_shim_warns_and_matches_facade():
    s = make_transaction_stream(n=600, m=3000, seed=4)
    kw = dict(batch_edges=256, refresh_every=3, workset=True)
    with pytest.warns(SpadeDeprecationWarning, match="SpadeService"):
        old = run_device_service(s, "DW", device="cpu", **kw)
    new = SpadeService("DW", EngineSpec(predictive=False, device="cpu", **kw)).run(s)
    for f in dataclasses.fields(new):
        if f.name not in TIMING:
            assert getattr(old, f.name) == getattr(new, f.name), f.name
    assert old.n_ticks > 0 and old.n_workset_ticks + old.n_fallback_ticks == old.n_ticks
