"""The port's cell matrix (``repro_torch.launch.cells``) against the JAX
package's (``repro.launch.cells``) at smoke size on the CPU: the GNN,
recsys and Spade cells here, the LM cells in ``tests/test_torch_cells_lm.py``.

For every ``(arch, shape)`` of ``all_cells()``: ``build_cell(...,
concrete=True, smoke=True)`` in both packages gives input arrays that are
equal (one numpy Generator drawn in the reference's order), and the port's
step, with the reference's weights swapped in through
:mod:`repro_torch.convert`, gives the reference's outputs.

Tolerances, and why:

* Inputs: array-equal.  The Spade cells' graphs and the state that
  ``init_state`` peels from them: bit for bit (integer weights, so every
  float32 sum is exact), and so are their steps' outputs.
* A train step (GNN, recsys): loss and ``grad_norm`` at rtol 1e-5 (XLA
  and torch sum in another order); the parameters within 1 % of a step
  (``lr / 100``; lr is 3e-6 at step 1 of AdamConfig's warmup) plus 2 ulps
  of the parameter (the update's own rounding), but for at most 2
  elements of a leaf or 0.1 % of them, each within ``2 lr``
  (Adam's first step moves an element by about ``lr * sign(g)``: a
  last-bit difference flips the sign of a ``g`` near 0).
* Scores and top-k: rtol 1e-5, atol 1e-6; the top-k indices equal.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import Skip as JSkip  # noqa: E402
from repro.configs import all_cells as j_all_cells  # noqa: E402
from repro.configs import arch_shapes as j_arch_shapes  # noqa: E402
from repro.launch import cells as jcells  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import ARCH_FAMILY, Skip, all_cells, arch_shapes  # noqa: E402
from repro_torch.convert import train_state_from_numpy, train_state_to_numpy  # noqa: E402
from repro_torch.convert import two_tower_params_from_numpy  # noqa: E402
from repro_torch.launch.cells import build_cell  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
STEP_TOL = 1e-2  # of lr
ODD_SHARE = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cells_of(families) -> list[tuple[str, str]]:
    return [(a, s) for a, s, _ in all_cells() if ARCH_FAMILY[a] in families]


def _key(entry):
    for attr in ("key", "name", "idx"):
        if hasattr(entry, attr):
            return getattr(entry, attr)
    raise TypeError(entry)


def jax_leaves(tree) -> dict:
    """``{path: numpy array}`` of a JAX tree, a path a tuple of dict keys,
    field names and indices."""
    return {tuple(_key(e) for e in p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def torch_leaves(tree, path: tuple = ()) -> dict:
    """``{path: numpy array}`` of the tensors of a tree of the port (dicts,
    NamedTuples and dataclasses by key or field, sequences by index)."""
    if isinstance(tree, torch.Tensor):
        return {path: tree.detach().cpu().numpy()}
    if isinstance(tree, np.ndarray):
        return {path: tree}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = tree._asdict().items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    elif dataclasses.is_dataclass(tree):
        items = ((f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree))
    else:
        return {}
    out = {}
    for k, v in items:
        out.update(torch_leaves(v, path + (k,)))
    return out


def assert_equal_trees(got: dict, want: dict, what: str) -> None:
    assert got.keys() == want.keys(), (what, sorted(got.keys() ^ want.keys()))
    for p, w in want.items():
        g = got[p]
        assert g.shape == w.shape and g.dtype == w.dtype, (what, p, g.dtype, w.dtype)
        assert np.array_equal(g, w), (what, p)


def assert_close_trees(got: dict, want: dict, what: str, rtol=RTOL, atol=ATOL) -> None:
    assert got.keys() == want.keys(), (what, sorted(got.keys() ^ want.keys()))
    for p, w in want.items():
        np.testing.assert_allclose(got[p], w, rtol=rtol, atol=atol, err_msg=f"{what} {p}")


def assert_params_close(got: dict, want: dict, lr: float, what: str) -> None:
    """Within 1 % of a step, but for a few elements (module docstring)."""
    assert got.keys() == want.keys(), what
    for p, w in want.items():
        d = np.abs(got[p].astype(np.float64) - w)
        odd = int((d > STEP_TOL * lr + 2 * np.spacing(np.abs(w))).sum())
        assert odd <= max(2, ODD_SHARE * d.size), f"{what} {p}: {odd} of {d.size}"
        assert float(d.max()) <= 2 * lr, f"{what} {p}: {d.max()}"


def build_pair(arch: str, shape: str, seed: int = 0):
    """Both packages' smoke cells (the port's on the CPU)."""
    j = jcells.build_cell(arch, shape, concrete=True, smoke=True, seed=seed)
    t = build_cell(arch, shape, concrete=True, smoke=True, seed=seed, device="cpu")
    return j, t


def data_args(cell) -> tuple:
    """The arguments that are data, not weights: all of a Spade cell's,
    all but the first of a model cell's."""
    return tuple(cell.args) if cell.family == "spade" else tuple(cell.args[1:])


def check_inputs(j, t) -> None:
    assert (t.family, t.step_name) == (j.family, j.step_name)
    assert t.model_flops == j.model_flops
    assert_equal_trees(torch_leaves(data_args(t)), jax_leaves(data_args(j)), "inputs")


def run_train_step(j, t, cfg, what: str):
    """Both packages' train step from the reference's state; the port's
    state, metrics and the reference's, as numpy."""
    state_np = jax.tree.map(np.asarray, j.args[0])
    t_state = train_state_from_numpy(state_np, cfg, "cpu")
    t_state, m_t = t.fn(t_state, *t.args[1:])
    j_state, m_j = jax.jit(j.fn)(*j.args)
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=RTOL, err_msg=f"{what} {k}")
    assert int(t_state.step) == int(j_state.step) == 1
    lr = float(m_j["lr"])
    assert_params_close(torch_leaves(train_state_to_numpy(t_state).params),
                        jax_leaves(j_state.params), lr, what)
    return t_state, m_t, m_j


def test_arch_shapes_and_skips_equal_jax():
    assert [(a, s) for a, s, _ in all_cells()] == [(a, s) for a, s, _ in j_all_cells()]
    assert len(all_cells()) == 42
    assert len(all_cells(include_spade=False)) == 40
    for arch in tconfigs.ARCHS:
        got, want = arch_shapes(arch), j_arch_shapes(arch)
        assert got.keys() == want.keys(), arch
        for name, spec in want.items():
            if isinstance(spec, JSkip):
                assert isinstance(got[name], Skip) and got[name].reason == spec.reason
                assert isinstance(build_cell(arch, name), Skip)
            else:
                assert dataclasses.asdict(got[name]) == dataclasses.asdict(spec), (arch, name)
    assert sum(isinstance(s, Skip) for _, _, s in all_cells()) == 4


@pytest.mark.parametrize("arch,shape", cells_of(("gnn",)),
                         ids=[f"{a}-{s}" for a, s in cells_of(("gnn",))])
def test_gnn_cell_matches_jax(arch, shape):
    j, t = build_pair(arch, shape)
    check_inputs(j, t)
    run_train_step(j, t, tconfigs.get_smoke_config(arch), f"{arch} {shape}")


@pytest.mark.parametrize("shape", list(tconfigs.RECSYS_SHAPES))
def test_recsys_cell_matches_jax(shape):
    arch = "two-tower-retrieval"
    cfg = tconfigs.get_smoke_config(arch)
    j, t = build_pair(arch, shape)
    check_inputs(j, t)
    what = f"{arch} {shape}"
    if t.step_name == "train_step":
        _, m_t, m_j = run_train_step(j, t, cfg, what)
        assert float(m_t["in_batch_acc"]) == float(m_j["in_batch_acc"])
        return
    params = two_tower_params_from_numpy(jax.tree.map(np.asarray, j.args[0]), cfg, "cpu")
    with torch.no_grad():
        got = t.fn(params, *t.args[1:])
    want = jax.jit(j.fn)(*j.args)
    if t.step_name == "score_pairs":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_allclose(got.values.numpy(), np.asarray(want[0]), rtol=RTOL, atol=ATOL)
        assert np.array_equal(got.indices.numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("shape", list(tconfigs.SPADE_SHAPES))
def test_spade_cell_matches_jax(shape):
    """Bit for bit: the graph, the initial state and the step's result."""
    j, t = build_pair("spade-grab", shape)
    check_inputs(j, t)
    got, want = t.fn(*t.args), jax.jit(j.fn)(*j.args)
    if t.step_name == "bulk_peel":
        fields = ("level", "best_level", "best_g", "n_rounds", "delta")
        got = {(f,): getattr(got, f).numpy() for f in fields}
        want = {(f,): np.asarray(getattr(want, f)) for f in fields}
    else:
        got, want = torch_leaves(got), jax_leaves(want)
    assert_equal_trees(got, want, shape)
