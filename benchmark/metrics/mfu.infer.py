"""Model step: the window's sparse model FLOPs (`benchmark/flops.py`) over
the traced window times the card's peak in the cell's compute dtype
(bf16 989 TFLOP/s, fp32 67 TFLOP/s on an H100 SXM), in %. Moves
voxels_per_s."""

from benchmark import flops
from benchmark.metrics._shared import card_peaks, compute_dtype, \
    per_forward_sum


def read(r, summ):
    peaks = card_peaks(summ)
    if not peaks or not r.forwards:
        return None
    total = per_forward_sum(r, lambda sh: flops.forward_flops(r.arch, sh))
    return 100.0 * total / (summ["window_s"] * peaks[compute_dtype(r)])
