"""The Grab-like transaction stream, drawn on the device from ``--seed``.

The distribution is that of the port's ``make_transaction_stream``
(frozen in ``numpy_stream.py``): endpoints drawn by inverse CDF from a
Zipf-like popularity ``rank ** -alpha`` through two random relabellings,
lognormal amounts, standing dense blocks in the base graph, and the
paper's ``join`` case, a new actor (vertex ``n``) whose burst of
transactions with the first block's members is planted in one tick.

What differs, so that a run pays seconds and not minutes for it and can
last as long as it is asked to:

* everything is drawn with ``torch`` generators on the device, in a few
  large calls;
* the base graph is exactly ``int(background_edges * base_fraction)``
  background edges plus the blocks, for every seed (a self-loop is moved
  to the next destination rank instead of being dropped);
* the increments are an unbounded sequence of chunks of ``chunk_ticks``
  ticks, chunk ``k`` drawn from a generator keyed by ``(seed, k)``, so the
  same seed gives the same edges however many ticks a run consumes;
* no timestamps: the configured semantics read none.
"""

from __future__ import annotations

import hashlib

import torch

__all__ = ["key", "generator", "Stream"]


def key(seed: int, *parts) -> int:
    """A 63-bit generator seed from the run's seed and a purpose."""
    digest = hashlib.blake2b(repr((int(seed),) + parts).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def generator(device, seed: int, *parts) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(key(seed, *parts))


def _lognormal(m: int, mu: float, sigma: float, gen, device) -> torch.Tensor:
    return torch.empty(m, dtype=torch.float32, device=device).log_normal_(mu, sigma, generator=gen)


class Stream:
    """The base graph and the increment chunks of one run.

    ``cfg`` is the configuration (its ``graph`` group), ``traffic`` the mix
    (``batch_edges``, ``chunk_ticks``, ``burst``); ``burst_at`` is the
    stream tick (counted from the first increment) that carries the burst.
    Endpoints are int32, amounts float32, all on ``device``.
    """

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, burst_at: int):
        gcfg = cfg["graph"]
        self.seed, self.device = int(seed), torch.device(device)
        self.n = int(gcfg["n_vertices"])
        self.n_vertices = self.n + 1  # the joining actor
        self.alpha = float(gcfg["zipf_alpha"])
        self.amount = gcfg["amount_lognormal"]
        self.batch = int(traffic["batch_edges"])
        self.chunk_ticks = int(traffic["chunk_ticks"])
        self.burst = traffic["burst"]
        self.burst_at = int(burst_at)
        gen = generator(self.device, seed, "graph")
        p = torch.arange(1, self.n + 1, dtype=torch.float64, device=self.device).pow_(-self.alpha)
        cdf = torch.cumsum(p, 0)
        self.cdf = cdf / cdf[-1]
        self.perm_s = torch.randperm(self.n, generator=gen, device=self.device).to(torch.int32)
        self.perm_d = torch.randperm(self.n, generator=gen, device=self.device).to(torch.int32)

        m_bg = int(int(gcfg["background_edges"]) * float(gcfg["base_fraction"]))
        src, dst = self._endpoints(m_bg, gen)
        amt = _lognormal(m_bg, self.amount["mu"], self.amount["sigma"], gen, self.device)
        blocks = gcfg["dense_blocks"]
        size, per = int(blocks["size"]), int(blocks["edges"])
        self.ring = None
        srcs, dsts, amts = [src], [dst], [amt]
        for _ in range(int(blocks["count"])):
            blk = torch.randperm(self.n, generator=gen, device=self.device)[:size].to(torch.int32)
            if self.ring is None:
                self.ring = blk
            i = torch.randint(0, size, (per,), generator=gen, device=self.device)
            j = torch.randint(0, size - 1, (per,), generator=gen, device=self.device)
            j = j + (j >= i).to(j.dtype)  # a pair of two distinct members
            srcs.append(blk[i])
            dsts.append(blk[j])
            amts.append(_lognormal(per, blocks["amount_lognormal"]["mu"],
                                   blocks["amount_lognormal"]["sigma"], gen, self.device))
        self.base_src = torch.cat(srcs)
        self.base_dst = torch.cat(dsts)
        self.base_amt = torch.cat(amts)
        self.chunks: dict[int, tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}

    def _endpoints(self, m: int, gen) -> tuple[torch.Tensor, torch.Tensor]:
        u = torch.rand(m, dtype=torch.float64, device=self.device, generator=gen)
        rs = torch.searchsorted(self.cdf, u, right=True).clamp_(max=self.n - 1)
        torch.rand(m, dtype=torch.float64, device=self.device, generator=gen, out=u)
        rd = torch.searchsorted(self.cdf, u, right=True).clamp_(max=self.n - 1)
        src, dst = self.perm_s[rs], self.perm_d[rd]
        nxt = self.perm_d[(rd + 1) % self.n]  # never dst, so never src where src == dst
        return src, torch.where(src == dst, nxt, dst)

    @property
    def base_edges(self) -> int:
        return self.base_src.shape[0]

    def chunk(self, k: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Chunk ``k``: ``(src, dst, amt)`` of shape ``[chunk_ticks, batch]``,
        drawn once and kept (the reference reads every tick that ran)."""
        if k not in self.chunks:
            gen = generator(self.device, self.seed, "chunk", k)
            m = self.chunk_ticks * self.batch
            src, dst = self._endpoints(m, gen)
            amt = _lognormal(m, self.amount["mu"], self.amount["sigma"], gen, self.device)
            src, dst, amt = (x.view(self.chunk_ticks, self.batch) for x in (src, dst, amt))
            row = self.burst_at - k * self.chunk_ticks
            if 0 <= row < self.chunk_ticks:
                self._plant_burst(src[row], dst[row], amt[row])
            self.chunks[k] = (src, dst, amt)
        return self.chunks[k]

    def _plant_burst(self, src, dst, amt) -> None:
        """The ``join`` case: the actor trades with random members of the
        first standing block, in both directions, at a seed-drawn offset of
        the tick."""
        gen = generator(self.device, self.seed, "burst")
        m = int(self.burst["edges"])
        off = int(torch.randint(0, self.batch - m + 1, (1,), generator=gen, device=self.device))
        member = self.ring[torch.randint(0, self.ring.shape[0], (m,), generator=gen,
                                         device=self.device)]
        actor = torch.full((m,), self.n, dtype=torch.int32, device=self.device)
        flip = torch.rand(m, generator=gen, device=self.device) < 0.5
        lanes = slice(off, off + m)
        src[lanes] = torch.where(flip, member, actor)
        dst[lanes] = torch.where(flip, actor, member)
        amt[lanes] = _lognormal(m, self.burst["amount_lognormal"]["mu"],
                                self.burst["amount_lognormal"]["sigma"], gen, self.device)

    def tick(self, t: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Stream tick ``t``'s batch (views of its chunk)."""
        src, dst, amt = self.chunk(t // self.chunk_ticks)
        r = t % self.chunk_ticks
        return src[r], dst[r], amt[r]

    def ticks(self, t0: int, t1: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Ticks ``t0 <= t < t1`` concatenated in stream order."""
        parts = [self.tick(t) for t in range(t0, t1)]
        return tuple(torch.cat([p[i] for p in parts]) for i in range(3))
