"""Port kernels: the sparse conv's share of its roofline, in %: the sum of
the bounds of the forward's same-stride k^3 convs
(`flops.sparse_conv_bound_s`, counting the active pairs of each kernel
map) over the device time of the `sparse_conv_kernel*` launches in the
window. Nothing to read, and no value, where no such kernel ran. Moves
voxels_per_s."""

from benchmark import devtrace, flops
from benchmark.metrics._shared import card_peaks, per_forward_sum


def read(r, summ):
    peaks = card_peaks(summ)
    if not peaks:
        return None
    t = devtrace.kernel_seconds(summ, ("sparse_conv_kernel",))
    if t <= 0:
        return None
    b = per_forward_sum(r, lambda sh: flops.sparse_conv_bound_s(r.arch, sh,
                                                                peaks))
    return 100.0 * b / t
