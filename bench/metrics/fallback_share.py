"""fallback_share (layer: engine): the share of the window's ticks whose
``WorksetTickInfo.fallback`` says the engine peeled the whole buffer
rather than the gathered workset."""


def read(r):
    n = r.counters.get("workset_ticks", 0)
    return r.counters["fallback_ticks"] / n if n else None
