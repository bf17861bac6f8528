"""edges_per_s: every stream edge of the ticks completed in the window,
over the window's seconds (host clock; the window ends with the last
tick's synchronised end)."""


def read(r):
    return sum(r.tick_edges) / r.window_s
