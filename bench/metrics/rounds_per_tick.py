"""rounds_per_tick (layer: peel): peel rounds run over the window, a tick,
counted as launches of the round's elementwise kernel K1
(``repro_torch.kernels.peel_round.ops.launches``; only CUDA launches
count, so a CPU run reads nothing)."""


def read(r):
    n = r.counters["k1_launches"]
    return n / r.counters["window_ticks"] if n else None
