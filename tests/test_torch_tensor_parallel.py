"""The port's dense LM serving path run sharded on a ``DeviceMesh``
(``repro_torch.launch.cells.shard_cell``: DTensor weights and inputs
placed by the cells' logical axes) on the CPU, against the port unsharded
and against ``repro``'s unsharded functions.

One :func:`repro_torch.dist.spawn` of four ``gloo`` ranks on a ``(data 2,
model 2)`` mesh runs both of the reference's attention layouts: the
sequence-sharded prefill of ``qwen3-14b-smoke`` (4 q heads: ``n_heads %
16 != 0``) and the head-sharded one of a smoke config with 16 q heads over
4 kv heads.  Each rank runs ``prefill`` through ``shard_cell``, three
``decode_step``s on the sharded cache (flash-decode over its slot shards)
and ``lm_loss`` over vocabulary-sharded logits.  On a ``(data 1, model
1)`` mesh (rank 0's own one-rank group, in the same spawn) the sharded
run gives the unsharded one's bits: nothing is split, so decode and
``lm_loss`` take their plain versions on each rank.

Weights come from ``repro``'s ``init_lm_params`` (float32), carried across
with ``repro_torch.convert``; prompts, labels and the decode tokens (fed
in, not sampled, so every run sees the same) from numpy.  Tolerance: the
sharded run within ``TOL`` of the row's largest magnitude (a logits row,
a cache row over the head dim) of the port's unsharded run, and within
``JAX_TOL`` of it of ``repro``'s: the ranks add their partial products
and softmax sums in another order (measured up to 1.8e-6 of the row
scale against the port, 2.0e-6 against ``repro``).

Spawned ranks import this file for its rank functions only: the ``if``
below keeps ``jax`` and ``repro`` out of them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import multiprocessing
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.dist import spawn  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

if multiprocessing.parent_process() is None:  # not in a spawned rank
    import jax

    from repro.configs import get_smoke_config as j_get_smoke_config
    from repro.models import transformer as jtf

# case -> (arch, config overrides): the sequence- and the head-sharded layout
CASES = {"seq": ("qwen3-14b", {}), "heads": ("internlm2-20b", {"n_heads": 16, "n_kv_heads": 4})}
B, S, N_DECODE = 2, 32, 3
TOL = 1e-5
JAX_TOL = 1e-5
TIMEOUT = 240


def _cfg(case: str, get=tconfigs.get_smoke_config):
    arch, over = CASES[case]
    return dataclasses.replace(get(arch), **over)


def _inputs(cfg, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            "decode": rng.integers(0, cfg.vocab, (N_DECODE, B)).astype(np.int32)}


def _run(case: str, model, inp: dict, env=None) -> dict:
    """prefill, N_DECODE decode steps on the fed tokens and lm_loss, as
    numpy arrays; on ``env``'s mesh through ``shard_cell`` when given."""
    from repro_torch.dist.sharding import place, use_axis_env
    from repro_torch.launch.cells import build_cell, shard_cell

    tokens = torch.from_numpy(inp["tokens"])
    labels = torch.from_numpy(inp["labels"])
    dec = [torch.from_numpy(t) for t in inp["decode"]]
    pos = [torch.full((B,), S + i, dtype=torch.int32) for i in range(N_DECODE)]
    fn = ttf.prefill
    if env is not None:
        cell = build_cell(CASES[case][0], "prefill_32k", smoke=True)
        cell = shard_cell(dataclasses.replace(cell, args=(model, tokens)), env)
        fn, (model, tokens) = cell.fn, cell.args
        with use_axis_env(env):
            labels = place(labels, "batch", None)
            dec = [place(t, "batch") for t in dec]
            pos = [place(p, "batch") for p in pos]
    # copies: decode writes the cache in place
    whole = lambda t: (t.full_tensor() if env is not None else t).numpy().copy()
    out = {}
    with torch.no_grad(), (use_axis_env(env) if env is not None else contextlib.nullcontext()):
        logits, cache = fn(model, tokens)
        out["prefill"] = whole(logits)
        out["cache_k"], out["cache_v"] = whole(cache.k), whole(cache.v)
        for i in range(N_DECODE):
            logits, cache = ttf.decode_step(model, cache, dec[i], pos[i])
            out[f"decode{i}"] = whole(logits)
        out["cache_k_after"] = whole(cache.k)
        loss, aux = ttf.lm_loss(model, tokens, labels)
        out["loss"] = whole(loss)
    return out


def tp_rank(mesh, path: str) -> dict:
    """A rank: each case sharded on ``mesh``, the weights and inputs read
    from ``path`` (a pickle: a large argument would hold up the next
    rank's start until this one has read it); on the 4-rank mesh also the
    all-to-all form of a gather against DTensor's all-gather."""
    from torch.distributed.tensor import Replicate

    from repro_torch.dist import sharding

    torch.set_num_threads(1)  # the ranks share the host's cores
    with open(path, "rb") as f:
        params, inputs = pickle.load(f)
    out = {"four": {}, "one": {}}
    # every rank's own (data 1, model 1) mesh: a one-rank group each
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    rank = dist.get_rank()
    own = [dist.new_group([r]) for r in range(dist.get_world_size())][rank]
    one = DeviceMesh.from_group([own, own], "cpu", mesh=torch.tensor([[rank]]),
                                mesh_dim_names=("data", "model"))
    for name, m in (("four", mesh), ("one", one)):
        if name == "one" and rank:
            continue
        for case in CASES:
            model = lm_params_from_numpy(params[case], _cfg(case), device="cpu")
            out[name][case] = _run(case, model, inputs[case], sharding.AxisEnv(m))
    env = sharding.AxisEnv(mesh)
    with sharding.use_axis_env(env):
        x = sharding.place(torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8),
                           "batch", None, "model")
        out["layers"] = _layers_last_dim_sharded()
    got = sharding._gather_by_all_to_all(x, 1)
    out["gather"] = (tuple(got.placements) == (x.placements[0], Replicate())
                     and torch.equal(got.full_tensor(), x.full_tensor()))
    return out


def _layers_last_dim_sharded() -> dict:
    """``rms_norm``, ``apply_rope`` and ``swiglu`` on DTensors whose last
    dim is sharded on the model dim, against the same on plain tensors:
    the largest error over the largest magnitude."""
    from repro_torch.dist.sharding import place
    from repro_torch.models import layers

    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 6, 3, 8, generator=g)
    scale = torch.rand(8, generator=g) + 0.5
    w_gate, w_up, w_down = (torch.randn(a, b, generator=g) for a, b in ((8, 12), (8, 12), (12, 8)))
    cos, sin = layers.rope_angles(torch.arange(6), 8, 1e4)
    xs = place(x, "batch", None, None, "model")
    rep = lambda t: place(t, *(None,) * t.dim())
    pairs = {
        "rms_norm": (layers.rms_norm(xs, rep(scale)), layers.rms_norm(x, scale)),
        "apply_rope": (layers.apply_rope(xs, cos[None, :, None], sin[None, :, None]),
                       layers.apply_rope(x, cos[None, :, None], sin[None, :, None])),
        "swiglu": (layers.swiglu(xs, rep(w_gate), rep(w_up), rep(w_down)),
                   layers.swiglu(x, w_gate, w_up, w_down)),
    }
    return {k: float((a.full_tensor() - b).abs().max() / b.abs().max())
            for k, (a, b) in pairs.items()}


def _row_close(got, want, tol: float, what: str) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max(axis=-1, keepdims=True)
    err = np.abs(got - want)
    assert (err <= tol * scale).all(), (
        f"{what}: max err {err.max():.3g}, {float((err / np.maximum(scale, 1e-30)).max()):.3g} "
        f"of the row scale (tolerance {tol})")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's weights and inputs per case, the port's and
    ``repro``'s unsharded runs, and the ranks' sharded runs on (2, 2) and
    (1, 1) meshes."""
    params, inputs, port, ref = {}, {}, {}, {}
    for case in CASES:
        cfg, jcfg = _cfg(case), _cfg(case, j_get_smoke_config)
        params[case] = jax.tree.map(np.asarray, jtf.init_lm_params(jax.random.PRNGKey(0), jcfg))
        inputs[case] = inp = _inputs(cfg)
        port[case] = _run(case, lm_params_from_numpy(params[case], cfg, device="cpu"), inp)
        jp = jax.tree.map(jax.numpy.asarray, params[case])
        logits, cache = jtf.prefill(jp, inp["tokens"], jcfg)
        r = {"prefill": logits, "cache_k": cache.k, "cache_v": cache.v}
        for i in range(N_DECODE):
            logits, cache = jtf.decode_step(jp, cache, inp["decode"][i],
                                            np.full((B,), S + i, np.int32), jcfg)
            r[f"decode{i}"] = logits
        r["cache_k_after"] = cache.k
        r["loss"] = jtf.lm_loss(jp, inp["tokens"], inp["labels"], jcfg)[0]
        ref[case] = {k: np.asarray(v) for k, v in r.items()}
    path = tmp_path_factory.mktemp("tp") / "inputs.pkl"
    path.write_bytes(pickle.dumps((params, inputs)))
    ranks = spawn(tp_rank, 4, device="cpu", args=(str(path),), timeout=TIMEOUT,
                  mesh_shape={"data": 2, "model": 2})
    return {"port": port, "ref": ref, "four": [r["four"] for r in ranks],
            "one": ranks[0]["one"], "gather": [r["gather"] for r in ranks],
            "layers": [r["layers"] for r in ranks]}


def test_flash_attention_q_offset_is_the_full_sequence_sliced():
    """``q_offset`` puts query i at position ``i + q_offset``: a block of
    the queries over the whole k and v gives those rows of the full
    sequence's attention, causal and windowed, GQA, ragged blocks."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 8, 100, 16, generator=g)
    k, v = torch.randn(2, 2, 100, 16, generator=g), torch.randn(2, 2, 100, 16, generator=g)
    for window in (None, 24):
        full = fa_ref.attention_ref(q, k, v, window=window)
        for off in (0, 37, 64, 99):
            part = q[:, :, off:]
            got = fa_ref.flash_attention_ref(part, k, v, window=window, q_offset=off,
                                             block_q=16, block_k=32)
            dense = fa_ref.attention_ref(part, k, v, window=window, q_offset=off)
            torch.testing.assert_close(got, full[:, :, off:], atol=1e-6, rtol=1e-5)
            assert torch.equal(dense, full[:, :, off:]), (window, off)
            dq, dk, dv = fa_ref.flash_attention_bwd_ref(part, k, v, torch.ones_like(part),
                                                        window=window, q_offset=off,
                                                        block_q=16)
            qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
            fa_ref.attention_ref(qa, ka, va, window=window)[:, :, off:].sum().backward()
            torch.testing.assert_close(dq, qa.grad[:, :, off:], atol=1e-5, rtol=1e-4)
            torch.testing.assert_close(dk, ka.grad, atol=1e-5, rtol=1e-4)
            torch.testing.assert_close(dv, va.grad, atol=1e-5, rtol=1e-4)


def test_local_kv_heads_of_a_head_shard():
    """A rank's q heads [h0, h0 + n) read kv head ``h // G``: whole groups
    slice the kv heads, heads inside one group take that kv head, and
    heads across a group boundary one kv head each."""
    k = torch.arange(2 * 3 * 4 * 5, dtype=torch.float32).reshape(2, 3, 4, 5)
    v = -k
    for h0, n, G in ((4, 4, 2), (8, 4, 4), (1, 2, 4), (3, 3, 2), (2, 4, 3)):
        kl, vl = tattn._local_kv_heads(k, v, h0, n, G)
        heads = torch.arange(h0, h0 + n) // G
        g_l = n // kl.shape[2]
        assert n % kl.shape[2] == 0
        assert torch.equal(kl[:, :, torch.arange(n) // g_l], k[:, :, heads]), (h0, n, G)
        assert torch.equal(vl[:, :, torch.arange(n) // g_l], v[:, :, heads]), (h0, n, G)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_lm_matches_unsharded_and_jax(runs, case):
    """Four ranks on (data 2, model 2): prefill's logits and KV cache, three
    decode steps' logits and the cache they wrote, and ``lm_loss``, on every
    rank, within TOL of the port unsharded and JAX_TOL of ``repro``."""
    port, ref = runs["port"][case], runs["ref"][case]
    for r, ranks in enumerate(runs["four"]):
        got = ranks[case]
        assert set(got) == set(port)
        for key in port:
            _row_close(got[key], port[key], TOL, f"rank {r} {case} {key} vs the port")
            _row_close(got[key], ref[key], JAX_TOL, f"rank {r} {case} {key} vs repro")


@pytest.mark.parametrize("case", list(CASES))
def test_one_rank_mesh_is_bit_identical(runs, case):
    """One rank on (data 1, model 1): prefill's logits and cache, every
    decode step's logits and the cache they wrote, and ``lm_loss``, the
    unsharded run's bits."""
    got, port = runs["one"][case], runs["port"][case]
    assert set(got) == set(port)
    for key in port:
        assert np.array_equal(got[key], port[key]), (case, key)


def test_gather_by_all_to_all_is_an_all_gather(runs):
    """The all-to-all that stands in for gloo's missing all-gather on CUDA
    gives DTensor's all-gather's values and placements (checked on the
    CPU's gloo, which has both)."""
    assert all(runs["gather"])


def test_layers_with_the_last_dim_sharded(runs):
    """``rms_norm`` all-reduces its sum of squares over a sharded hidden
    dim, ``apply_rope`` gathers a sharded head dim (its halves pair across
    shards) and ``swiglu`` all-reduces its products' partial sums: each
    within float32 reordering of the plain tensors' result."""
    for errs in runs["layers"]:
        assert set(errs) == {"rms_norm", "apply_rope", "swiglu"}
        assert max(errs.values()) < 1e-6, errs


@pytest.mark.parametrize("arch,shape,item", [("two-tower-retrieval", s, "D.4") for s in
                                             ("serve_p99", "serve_bulk", "retrieval_cand",
                                              "train_batch")])
def test_shard_cell_names_the_slice_of_other_cells(arch, shape, item):
    """Every family's cells run sharded now, the two-tower cells (ROADMAP
    D.4) the last: ``shard_cell`` of a meta two-tower cell with no env
    gets past any refusal to placing its arguments, which needs a mesh."""
    from repro_torch.launch.cells import build_cell, shard_cell

    with pytest.raises(ValueError, match="no active AxisEnv"):
        shard_cell(build_cell(arch, shape), None)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mixtral-8x7b"])
def test_shard_cell_runs_the_moe_train_cells(arch):
    """The MoE train cells run sharded (``tests/test_torch_moe_fsdp.py``
    trains them): ``shard_cell`` of the meta cell with no env gets past
    any refusal to placing the state, which needs a mesh."""
    from repro_torch.launch.cells import build_cell, shard_cell

    cell = build_cell(arch, "train_4k")
    with pytest.raises(ValueError, match="no active AxisEnv"):
        shard_cell(cell, None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_gives_the_bits_of_at(dtype):
    """``layers.matmul`` (the decode step's products: 2-D operands through
    ``torch.mm``, which DTensor's sharding cache keeps under inference
    mode) gives ``@``'s bits, 2-D and batched, in and out of inference
    mode."""
    from repro_torch.models.layers import matmul

    g = torch.Generator().manual_seed(0)
    b = torch.randn(8, 3, generator=g).to(dtype)
    for a in (torch.randn(5, 8, generator=g), torch.randn(2, 5, 8, generator=g)):
        a = a.to(dtype)
        assert torch.equal(matmul(a, b), a @ b)
        with torch.inference_mode():
            assert torch.equal(matmul(a, b), a @ b)
