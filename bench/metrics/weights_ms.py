"""weights_ms (layer: semantics): the mean over the window's ticks of the
device time between CUDA events recorded around each tick's
``batch_weights`` call, in ms (traced run)."""


def read(r):
    times = r.events_ms.get("weights")
    return sum(times) / len(times) if times else None
