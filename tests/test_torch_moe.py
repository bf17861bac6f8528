"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's (``repro.models.moe``) on the CPU, on the same numpy inputs.

Cases: both MoE smoke configs' specs (mixtral's with ``virtual_split`` 2,
olmoe's with 8 experts), at T = 2 (one token block, capacity 1, so drops),
T = 64 (32 token blocks) and T = 30 (one block).  The reference takes the
virtual-expert leaves ``[E * vs, ...]``; the port the same weights folded
into whole experts (``repro_torch.convert.fold_experts``).

Routing: the chosen experts (``topi``, in order) must be equal, except on
near-tie tokens, whose adjacent top-(K+1) router logits (the reference's)
are closer than ``MARGIN``; such tokens are counted and logged.  The keep
mask must equal a plain per-block count over the reference's ``topi``
(every token then routed alike), or, after a near-tie flip, over the
port's own ``topi``.  Outputs are compared on the tokens whose ``topi``
and keep mask are the same in both packages.

Tolerances: float32 outputs at rtol = atol = 1e-5 and the aux loss at
1e-6 (one layer of float32 products summed in another order than XLA's).
bfloat16 at rtol = 2e-2 and atol = 2e-2 of the largest magnitude: both
round the expert products to bf16, but not at the same points (the
reference rounds ``silu``'s sigmoid and each add of its scatter-add).  The
router logits are float32 products of the same bf16 inputs in both, so
the margin is float32's in both dtypes.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_get_smoke_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import fold_experts, unfold_experts  # noqa: E402
from repro_torch.models import moe_ffn, router_aux_loss  # noqa: E402
from repro_torch.models.moe import moe_route  # noqa: E402

log = logging.getLogger(__name__)

MOE_ARCHS = ["mixtral-8x7b", "olmoe-1b-7b"]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
AUX_TOL = {"float32": 1e-6, "bfloat16": 2e-2}
MARGIN = 1e-5  # float32 router logits of the same inputs: ~1e-7 apart


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec(arch):
    spec = tconfigs.get_smoke_config(arch).moe
    assert dataclasses.asdict(spec) == dataclasses.asdict(j_get_smoke_config(arch).moe)
    return spec, tconfigs.get_smoke_config(arch).d_model


def _inputs(spec, D, T, seed):
    """x [T, D] and the reference's leaves (router [D, E], virtual experts)
    as float32 numpy, fan-in scaled."""
    rng = np.random.default_rng(seed)
    E, vs, F = spec.n_experts, spec.virtual_split, spec.d_ff_expert
    Ev, Fv = E * vs, F // vs
    x = rng.standard_normal((T, D)).astype(np.float32)
    p = {"router": rng.standard_normal((D, E)) / np.sqrt(D),
         "w_gate": rng.standard_normal((Ev, D, Fv)) / np.sqrt(D),
         "w_up": rng.standard_normal((Ev, D, Fv)) / np.sqrt(D),
         "w_down": rng.standard_normal((Ev, Fv, D)) / np.sqrt(F)}
    return x, {k: v.astype(np.float32) for k, v in p.items()}


def _both(a: np.ndarray, dtype: str):
    """The same values for both packages: a jnp array in ``dtype`` and the
    torch tensor of its bits."""
    j = jnp.asarray(a, dtype=dtype)
    if dtype == "bfloat16":
        return j, torch.from_numpy(np.asarray(j).view(np.uint16).copy()).view(torch.bfloat16)
    return j, torch.from_numpy(np.asarray(j).copy())


def _port_leaves(p_t: dict, vs: int) -> list:
    return [p_t["router"]] + [fold_experts(n, p_t[n], vs) for n in ("w_gate", "w_up", "w_down")]


def keep_mask(topi: np.ndarray, n_blocks: int, capacity: int, n_experts: int) -> np.ndarray:
    """The plain capacity rule: walk each block's assignments in token-major,
    k-minor order and keep one while its expert has fewer than ``capacity``
    kept in the block.  [n_blocks, A] bool."""
    assign = topi.reshape(n_blocks, -1)
    keep = np.zeros(assign.shape, bool)
    for b in range(n_blocks):
        used = np.zeros(n_experts, int)
        for a, e in enumerate(assign[b]):
            keep[b, a] = used[e] < capacity
            used[e] += 1
    return keep


def near_ties(logits: np.ndarray, K: int, margin: float) -> np.ndarray:
    """Tokens whose top-(K+1) router logits hold two closer than ``margin``."""
    top = -np.sort(-logits, axis=-1)[:, :K + 1]
    return (top[:, :-1] - top[:, 1:]).min(axis=-1) < margin


def routing_agreement(j_logits: np.ndarray, t_topi: np.ndarray, K: int,
                      margin: float, what: str) -> np.ndarray:
    """Check the rule above on one call's routing; returns the tokens whose
    ``topi`` is the same in both packages."""
    j_topi = np.argsort(-j_logits, axis=-1, kind="stable")[:, :K]
    same = (j_topi == t_topi).all(axis=-1)
    ties = near_ties(j_logits, K, margin)
    assert ties[~same].all(), f"{what}: topi differs on tokens that are not near-ties"
    log.info("%s: %d near-tie tokens (margin < %g), %d routed differently",
             what, int(ties.sum()), margin, int((~same).sum()))
    return same


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [2, 64, 30])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_matches_jax(arch, T, dtype):
    spec, D = _spec(arch)
    E, K = spec.n_experts, spec.top_k
    x, p = _inputs(spec, D, T, seed=T)
    x_j, x_t = _both(x, dtype)
    p_j, p_t = {}, {}
    for name, w in p.items():
        p_j[name], p_t[name] = _both(w, "float32" if name == "router" else dtype)
    j_out, j_aux = jmoe.moe_ffn(x_j, p_j, spec)
    t_out, t_aux = moe_ffn(x_t, *_port_leaves(p_t, spec.virtual_split), spec)
    assert t_out.dtype == x_t.dtype and tuple(t_out.shape) == (T, D)

    j_logits = np.asarray(x_j.astype(jnp.float32) @ p_j["router"])
    r = moe_route(x_t, p_t["router"], spec)
    TB = r.slot.shape[0]
    assert TB == (32 if T % 32 == 0 else 1)
    assert r.capacity == max(1, int(spec.capacity_factor * (T // TB) * K / E))
    t_topi = r.topi.numpy()
    same = routing_agreement(j_logits, t_topi, K, MARGIN, f"{arch} T={T} {dtype}")
    j_topi = np.argsort(-j_logits, axis=-1, kind="stable")[:, :K]
    j_keep = keep_mask(j_topi, TB, r.capacity, E)
    # the port's keep mask is the plain rule over its own routing
    np.testing.assert_array_equal(r.keep.numpy(), keep_mask(t_topi, TB, r.capacity, E))
    alike = same & (r.keep.numpy() == j_keep).reshape(T, K).all(axis=-1)
    if same.all():
        np.testing.assert_array_equal(r.keep.numpy(), j_keep)
    assert alike.any()

    got = t_out.float().numpy()[alike]
    want = np.asarray(j_out, dtype=np.float32)[alike]
    atol = TOL[dtype] * float(np.abs(want).max()) if dtype == "bfloat16" else TOL[dtype]
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=atol)
    np.testing.assert_allclose(float(t_aux), float(j_aux), rtol=AUX_TOL[dtype],
                               atol=AUX_TOL[dtype])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_router_aux_loss_matches_jax(arch):
    spec, _ = _spec(arch)
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((64, spec.n_experts)).astype(np.float32)
    topi = np.argsort(-logits, axis=-1)[:, :spec.top_k].astype(np.int32)
    want = float(jmoe.router_aux_loss(jnp.asarray(logits), jnp.asarray(topi), spec.n_experts))
    got = router_aux_loss(torch.from_numpy(logits), torch.from_numpy(topi).long(),
                          spec.n_experts)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_duplicate_token_is_dropped(arch):
    """T = 2, two equal rows: one block of capacity 1, so every expert the
    second row picks is taken by the first, and its output is exactly 0."""
    spec, D = _spec(arch)
    x, p = _inputs(spec, D, 1, seed=3)
    x = np.repeat(x, 2, axis=0)
    j_out, _ = jmoe.moe_ffn(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, spec)
    p_t = {k: torch.from_numpy(v) for k, v in p.items()}
    t_out, _ = moe_ffn(torch.from_numpy(x), *_port_leaves(p_t, spec.virtual_split), spec)
    r = moe_route(torch.from_numpy(x), p_t["router"], spec)
    assert r.capacity == 1 and r.keep.tolist() == [[True] * spec.top_k + [False] * spec.top_k]
    j_out = np.asarray(j_out)
    assert (j_out[1] == 0).all() and (t_out[1] == 0).all()
    assert (j_out[0] != 0).any()
    np.testing.assert_allclose(t_out[0].numpy(), j_out[0], rtol=1e-5, atol=1e-5)


def test_virtual_split_fold_round_trip():
    """Folding mixtral's virtual experts into whole ones and back gives the
    reference's leaves bit for bit; the folded layer computes what the
    split layer does, in float32."""
    arch = "mixtral-8x7b"
    spec, D = _spec(arch)
    vs = spec.virtual_split
    assert vs == 2 and tconfigs.get_config(arch).moe.virtual_split == 2
    x, p = _inputs(spec, D, 64, seed=4)
    for name in ("w_gate", "w_up", "w_down"):
        _, t = _both(p[name], "bfloat16")
        folded = fold_experts(name, t, vs)
        assert folded.shape[0] == spec.n_experts
        assert torch.equal(unfold_experts(name, folded, vs).view(torch.int16),
                           t.view(torch.int16)), name
    # expert e's columns are its virtual experts' side by side
    wg = torch.from_numpy(p["w_gate"])
    Fv = spec.d_ff_expert // vs
    assert torch.equal(fold_experts("w_gate", wg, vs)[1, :, Fv:], wg[1 * vs + 1])
    assert torch.equal(fold_experts("w_down", torch.from_numpy(p["w_down"]), vs)[1, Fv:],
                       torch.from_numpy(p["w_down"])[1 * vs + 1])
    j_out, _ = jmoe.moe_ffn(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, spec)
    p_t = {k: torch.from_numpy(v) for k, v in p.items()}
    t_out, _ = moe_ffn(torch.from_numpy(x), *_port_leaves(p_t, vs), spec)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=1e-5, atol=1e-5)
