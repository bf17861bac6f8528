"""tick_p95_ms: the 95th percentile (nearest rank) of all the window's
tick latencies, in ms (host clock, from the hand-over of the batch to the
synchronised end of its maintenance)."""

import math


def read(r):
    ticks = sorted(r.ticks)
    return 1e3 * ticks[math.ceil(0.95 * len(ticks)) - 1]
