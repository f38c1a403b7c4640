"""Device: 1 - (union of the kernels' intervals / the traced window), over
the whole window. Moves voxels_per_s."""


def read(r, summ):
    if not summ or summ["busy_s"] <= 0:
        return None
    return 1.0 - summ["busy_s"] / summ["window_s"]
