"""host_reads_per_tick (layer: engine): device-to-host reads the engine
made over the window (``repro_torch.core.peel.HOST_READS``), a tick."""


def read(r):
    return r.counters["host_reads"] / r.counters["window_ticks"]
