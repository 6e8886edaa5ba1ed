"""Median host ms of the window's mapping steps, each one call of
``models.mapping.mapping_step_chunk`` on the host clock, over the
sequences that ran without the profiler (traced runs only)."""

import statistics


def read(run):
    return statistics.median(run.mapping_ms) if run.mapping_ms else None
