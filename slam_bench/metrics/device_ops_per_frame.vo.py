"""Device activities (kernels, copies, fills) per tracked frame of the
traced sequence: the host's dispatch count."""


def read(run):
    t = run.trace
    return None if t is None or t.n_ops == 0 else t.n_ops / run.traced_seq.tracked
