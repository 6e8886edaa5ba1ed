"""Process start to window start: the world's rendering or its read from
the cache, the kernels' build or cache hit, engine construction and the
warm-up sequence."""


def read(run):
    return run.setup_s
