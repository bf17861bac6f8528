"""The port's ``exact_peel`` (``core/peel.py``), ``csr_sort``
(``graphstore/structs.py``) and ``spade-grab`` config against the JAX
package's, on the same seeded numpy inputs (CPU).

``exact_peel`` is held against ``jax.jit(repro.core.peel.exact_peel)``
(every output field bit for bit on integer weights) and against the host
oracle's ``static_peel`` (order equal, ``delta`` bit for bit, ``best_g``
within rtol 1e-6 of ``detect``'s), with ties and with capacity padding, as
``tests/test_device_peel.py`` holds the reference's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_smoke_config as j_get_smoke_config  # noqa: E402
from repro.configs.base import SPADE_SHAPES as J_SPADE_SHAPES  # noqa: E402
from repro.core import peel as jpeel  # noqa: E402
from repro.graphstore import structs as jst  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import peel as tpeel  # noqa: E402
from repro_torch.core.reference import AdjGraph, detect, static_peel  # noqa: E402
from repro_torch.graphstore import structs as tst  # noqa: E402


def random_coo(rng, n, m, tied=False):
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    if tied:  # every edge 1, no priors: most peeling weights tie
        return src, dst, np.ones(src.shape[0], np.float32), np.zeros(n, np.float32)
    c = rng.integers(1, 6, src.shape[0]).astype(np.float32)
    a = rng.integers(0, 3, n).astype(np.float32)
    return src, dst, c, a


CASES = [(s, n, m, cap, tied) for s, (n, m, cap) in enumerate(
    [(24, 70, None), (24, 70, None), (15, 40, (32, 128)), (40, 150, (64, 256))])
    for tied in (False, True)]


@pytest.mark.parametrize("seed,n,m,cap,tied", CASES,
                         ids=[f"s{c[0]}-n{c[1]}-{'pad' if c[3] else 'nopad'}"
                              f"-{'tied' if c[4] else 'int'}" for c in CASES])
def test_exact_peel_matches_reference_and_oracle(seed, n, m, cap, tied):
    src, dst, c, a = random_coo(np.random.default_rng(seed), n, m, tied)
    V, E = cap or (None, None)
    got = tpeel.exact_peel(tst.device_graph_from_coo(n, src, dst, c, a, n_capacity=V,
                                                     e_capacity=E, device="cpu"))
    want = jax.jit(jpeel.exact_peel)(jst.device_graph_from_coo(n, src, dst, c, a,
                                                              n_capacity=V, e_capacity=E))
    for f in ("level", "best_level", "best_g", "n_rounds", "order", "delta"):
        x, y = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    host = static_peel(AdjGraph.from_arrays(n, src, dst, c, a))
    np.testing.assert_array_equal(got.order.numpy()[:n], host.order())
    assert (got.order.numpy()[n:] == -1).all()
    np.testing.assert_array_equal(got.delta.numpy()[:n].astype(np.float64), host.delta())
    _, g_host = detect(host)
    assert abs(float(got.best_g) - g_host) <= 1e-6 * g_host
    np.testing.assert_array_equal(got.community_mask().numpy(),
                                  np.asarray(want.community_mask()))


def test_exact_peel_ties_go_to_the_lowest_id():
    """A star 0-{1,2,3} and an edge 4-5, all weights 1, no priors: every
    leaf ties at weight 1.  1 leaves first, then 2; the centre is down to
    weight 1 and ties with 3, 4 and 5, so it leaves next; then 3 (weight
    0), 4 and 5."""
    src, dst = np.array([0, 0, 0, 4]), np.array([1, 2, 3, 5])
    g = tst.device_graph_from_coo(6, src, dst, n_capacity=8, e_capacity=8, device="cpu")
    res = tpeel.exact_peel(g)
    assert res.order.numpy().tolist() == [1, 2, 0, 3, 4, 5, -1, -1]
    assert res.delta.numpy().tolist() == [1, 1, 1, 0, 1, 0, 0, 0]
    assert static_peel(AdjGraph.from_arrays(6, src, dst, np.ones(4))).order().tolist() \
        == [1, 2, 0, 3, 4, 5]


def test_bulk_peels_carry_no_order():
    g = tst.device_graph_from_coo(3, np.array([0, 1]), np.array([1, 2]), device="cpu")
    assert tpeel.bulk_peel(g).order is None


@pytest.mark.parametrize("cap", [None, (64, 512)])
def test_csr_sort_matches_reference(cap):
    rng = np.random.default_rng(11)
    src, dst = rng.integers(0, 50, 300), rng.integers(0, 50, 300)
    c = rng.integers(1, 5, 300).astype(np.float32)
    V, E = cap or (None, None)
    got = tst.csr_sort(tst.device_graph_from_coo(50, src, dst, c, n_capacity=V,
                                                 e_capacity=E, device="cpu"))
    want = jst.csr_sort(jst.device_graph_from_coo(50, src, dst, c, n_capacity=V,
                                                  e_capacity=E))
    for f in ("src", "dst", "c", "edge_mask", "a", "vertex_mask"):
        x, y = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert (got.n_capacity, got.e_capacity) == (want.n_capacity, want.e_capacity)


def test_spade_grab_config_matches_jax():
    for get_t, get_j in ((tconfigs.get_config, j_get_config),
                         (tconfigs.get_smoke_config, j_get_smoke_config)):
        got, want = get_t("spade-grab"), get_j("spade-grab")
        assert type(got).__name__ == type(want).__name__ == "SpadeConfig"
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert tconfigs.ARCH_FAMILY["spade-grab"] == "spade"
    assert "spade-grab" in tconfigs.ARCHS
    assert tconfigs.SPADE_SHAPES.keys() == J_SPADE_SHAPES.keys()
    for name, spec in tconfigs.SPADE_SHAPES.items():  # the reference adds recsys fields
        want = dataclasses.asdict(J_SPADE_SHAPES[name])
        assert {k: want[k] for k in dataclasses.asdict(spec)} == dataclasses.asdict(spec)
