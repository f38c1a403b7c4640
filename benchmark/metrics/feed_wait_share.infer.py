"""Host feeder: the share of the window in which the dispatching thread
waited on an empty feed queue. Moves voxels_per_s."""

from benchmark.metrics._shared import window_spans


def read(r, summ):
    if r.window is None:
        return None
    t0, t1 = r.window
    return sum(window_spans(r, "wait")) / (t1 - t0)
