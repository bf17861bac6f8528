"""The port's LM cells (``repro_torch.launch.cells``: train, prefill and
decode of the five LMs, and the four ``long_500k`` skips) against the JAX
package's at smoke size on the CPU; the other families' cells are in
``tests/test_torch_cells.py``, whose helpers this file shares.

Input arrays equal; the step's outputs with the reference's weights
swapped in through :mod:`repro_torch.convert`.  Tolerances: logits and
KV caches at rtol and atol 1e-4 (float32, as ``tests/test_torch_lm.py``);
a train step's loss and ``grad_norm`` at rtol 1e-5 and its parameters as
``tests/test_torch_cells.py`` says.  MoE routing is recorded in both
packages and compared as in ``tests/test_torch_lm.py``: the same experts
but on near-ties; a sequence routed differently is left out of the
output checks (and a train step needs none).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import Skip  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from test_torch_cells import (build_pair, cells_of, check_inputs, run_train_step,  # noqa: E402
                              torch_leaves)
from test_torch_lm import _rerouted_rows, routing  # noqa: E402,F401

TOL = 1e-4
LM_CELLS = cells_of(("lm",))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close_rows(got, want, keep, axis, what):
    """``got`` against ``want`` on the rows (sequences) in ``keep``, along
    the batch ``axis``."""
    got, want = np.take(got, keep, axis=axis), np.take(np.asarray(want), keep, axis=axis)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=what)


@pytest.mark.parametrize("arch,shape", LM_CELLS, ids=[f"{a}-{s}" for a, s in LM_CELLS])
def test_lm_cell_matches_jax(arch, shape, routing):
    j, t = build_pair(arch, shape)
    if isinstance(t, Skip):
        assert isinstance(j, type(j)) and t.reason == j.reason
        return
    check_inputs(j, t)
    cfg = tconfigs.get_smoke_config(arch)
    what = f"{arch} {shape}"
    if t.step_name == "train_step":
        run_train_step(j, t, cfg, what)
        # a layer routes twice in both packages: the forward, and its
        # rematerialisation in the backward
        calls = {k: list(v) for k, v in routing.items()}
        n = len(calls["torch"])
        assert len(calls["jax"]) == n and n in (0, 2 * cfg.n_layers), what
        for i in range(0, n, cfg.n_layers):
            for k in routing:
                routing[k][:] = calls[k][i:i + cfg.n_layers]
            B = t.args[1]["tokens"].shape[0]
            assert not _rerouted_rows(routing, cfg, "float32", B, what)
        return
    model = lm_params_from_numpy(jax.tree.map(np.asarray, j.args[0]), cfg, "cpu")
    logits, cache = t.fn(model, *t.args[1:])
    j_logits, j_cache = jax.jit(j.fn)(*j.args)
    B = logits.shape[0]
    keep = sorted(set(range(B)) - _rerouted_rows(routing, cfg, "float32", B, what))
    assert keep, f"{what}: every sequence rerouted"
    _close_rows(logits.numpy(), j_logits, keep, 0, f"{what} logits")
    for name in ("k", "v"):  # [L, B, W, Hkv, Dh]
        _close_rows(getattr(cache, name).numpy(), getattr(j_cache, name), keep, 1,
                    f"{what} cache {name}")
    assert set(torch_leaves(cache)) == {("k",), ("v",)}
