"""setup_s: process start (the first line of bench/run.py) to the first
timed tick: imports, CUDA context, kernel load or build, the stream's
draw, the program's seeding, upload, start-up peel, window fill and
warm-up slides (host clock)."""


def read(r):
    return r.setup_s
