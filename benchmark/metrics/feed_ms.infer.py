"""Host feeder: mean ms of a batch's collation (and, for `infer_u8`, its
encode) on a feeder thread, over the window. Moves voxels_per_s."""

from benchmark.metrics._shared import mean_ms


def read(r, summ):
    return mean_ms(r, "feed")
