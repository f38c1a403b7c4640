"""Entry and dispatch: mean host ms from the entry call to its return (the
enqueue of a batch's forward), over the window. Moves voxels_per_s."""

from benchmark.metrics._shared import mean_ms


def read(r, summ):
    return mean_ms(r, "dispatch")
