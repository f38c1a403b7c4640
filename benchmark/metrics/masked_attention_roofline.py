"""Port kernels: the masked cross-attention's share of its roofline, in %:
the sum of its launches' bounds (`flops.attention_bound_s`, one launch a
round and level at the level's padded rows) over the device time of its
kernels (`mca_partial`, `mca_combine`) in the window. Nothing to read,
and no value, where no such kernel ran. Moves voxels_per_s."""

from benchmark import devtrace, flops
from benchmark.metrics._shared import card_peaks, per_forward_sum


def read(r, summ):
    peaks = card_peaks(summ)
    if not peaks:
        return None
    t = devtrace.kernel_seconds(summ, ("mca_partial", "mca_combine"))
    if t <= 0:
        return None
    b = per_forward_sum(r, lambda sh: flops.attention_bound_s(r.arch, sh,
                                                              peaks))
    return 100.0 * b / t
