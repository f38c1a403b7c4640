"""Library kernels: device ms a batch in cuDNN's convolutions and cuBLAS's
matmuls (the groups of `benchmark/peaks.py`). Moves voxels_per_s."""


def read(r, summ):
    if not summ or not r.forwards:
        return None
    g = summ["by_group"]
    s = g.get("convolutions (cuDNN)", 0.0) + g.get("matmuls (cuBLAS)", 0.0)
    return 1e3 * s / len(r.forwards)
