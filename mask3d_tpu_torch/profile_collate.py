"""The host collation, timed phase by phase (tools/profile_collate.py of the
JAX package).

Collates the bench's 8 synthetic scenes (`profile_forward.flagship_items`)
at bucket 65536, prints the batch's capacity and counts, then times, per
batch of 8 scenes and averaged over `reps` runs: the whole collation,
`voxelize_item` of each scene, the gather of each scene's kept rows,
`build_item_target` of each scene's labels and `encode_batch_u8` of the
collated batch. The collation runs on the bench's feeder threads beside
the card's forward, so its total says how many feeders keep a forward fed.

Host work only: the tool takes no `device` argument because it touches no
torch device at all, neither the CPU's tensors nor a card's. It builds and
loads none of the CUDA kernels (the C++ host library of `native.py` is the
one thing it builds), and runs the same on a machine with a card as on one
without.

Usage: python -m mask3d_tpu_torch.profile_collate [reps]   (default 8)
"""

from __future__ import annotations

import sys
import time

import numpy as np

from mask3d_tpu_torch.data.collate import VoxelizeCollate, \
    build_item_target, voxelize_item
from mask3d_tpu_torch.data.transfer import encode_batch_u8
from mask3d_tpu_torch.profile_forward import flagship_items

BUCKET = 65536  # the JAX tool's bucket, not the bench's 49152


# from tools/profile_collate.py:47 vox_all
def vox_all(items):
    """`voxelize_item` of each scene: [(coords, keep, dims)]."""
    return [voxelize_item(it["coordinates"]) for it in items]


# from tools/profile_collate.py:58 gather_all
def gather_all(items, keeps):
    """Each scene's kept rows: [(labels i32, features f32, raw_coordinates,
    raw_features, raw_labels)]."""
    return [(np.asarray(it["labels"])[k].astype(np.int32),
             np.asarray(it["features"])[k].astype(np.float32),
             np.asarray(it["raw_coordinates"])[k],
             np.asarray(it["raw_features"])[k],
             np.asarray(it["raw_labels"])[k])
            for it, k in zip(items, keeps)]


# from tools/profile_collate.py:72 targets_all
def targets_all(labelss):
    """`build_item_target` of each scene's kept labels, filtering the
    tool's instance ids -1 and 0."""
    return [build_item_target(lb, (), (-1, 0)) for lb in labelss]


# from tools/profile_collate.py:20 main
def main(reps: int = 8):
    """Print the capacity/counts line and the five phases' ms per batch;
    return ({label: ms}, the collated host batch)."""
    items = flagship_items(0)
    collate = VoxelizeCollate(point_bucket_multiple=BUCKET)

    # warm caches and imports
    host = collate(items)
    print(f"n_cap={host.device.coords.shape[1]} "
          f"counts={host.device.counts.tolist()}")
    times = {}

    # from tools/profile_collate.py:36 bench
    def bench(name, fn):
        t = time.perf_counter()
        for _ in range(reps):
            out = fn()
        dt = (time.perf_counter() - t) / reps * 1e3
        print(f"{name:<28s} {dt:8.2f} ms/batch")
        times[name] = dt
        return out

    bench("collate total", lambda: collate(items))
    keeps = [k for _, k, _ in bench("  voxelize_item x8",
                                    lambda: vox_all(items))]
    labelss = [g[0] for g in bench("  keep-gather x8",
                                   lambda: gather_all(items, keeps))]
    bench("  build_item_target x8", lambda: targets_all(labelss))
    dev = host.device
    bench("  encode_batch_u8",
          lambda: encode_batch_u8(dev.coords, dev.counts, dev.dims))
    return times, host


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
