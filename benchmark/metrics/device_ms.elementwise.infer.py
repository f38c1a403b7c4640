"""Library kernels: device ms a batch in PyTorch's elementwise and
reduction kernels (masks, norms, casts). Moves voxels_per_s."""


def read(r, summ):
    if not summ or not r.forwards:
        return None
    g = summ["by_group"]
    s = g.get("elementwise", 0.0) + g.get("reductions", 0.0)
    return 1e3 * s / len(r.forwards)
