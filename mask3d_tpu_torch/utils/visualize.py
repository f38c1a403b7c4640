"""Debug visualizations: point-cloud plots and gradient-flow checks; a copy
of mask3d_tpu/utils/visualize.py.

Matplotlib is imported inside each plotting function, so the module imports
where matplotlib is absent. `gradient_flow_stats` reads a model's
`named_parameters()` gradients, or a nested dict of gradients (tensors or
arrays) as the JAX version reads a pytree.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


# from mask3d_tpu/utils/visualize.py:16 plot_point_cloud
def plot_point_cloud(coords: np.ndarray, labels: Optional[np.ndarray] = None,
                     path: str = "pc.png", max_points: int = 50_000,
                     title: str = "", azim: float = -60, elev: float = 30):
    """3D scatter colored by label (instance or semantic)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if len(coords) > max_points:
        sel = np.random.default_rng(0).choice(
            len(coords), max_points, replace=False
        )
        coords = coords[sel]
        labels = labels[sel] if labels is not None else None
    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    c = labels if labels is not None else coords[:, 2]
    ax.scatter(coords[:, 0], coords[:, 1], coords[:, 2], c=c, s=1,
               cmap="tab20")
    ax.view_init(elev=elev, azim=azim)
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


# from mask3d_tpu/utils/visualize.py:44 plot_prediction_vs_gt
def plot_prediction_vs_gt(coords, gt_instance_ids, pred_instance_ids,
                          path: str = "pred_vs_gt.png"):
    """Side-by-side gt/pred instance colorings."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(14, 7))
    for i, (ids, name) in enumerate(
        [(gt_instance_ids, "ground truth"), (pred_instance_ids, "prediction")]
    ):
        ax = fig.add_subplot(1, 2, i + 1, projection="3d")
        ax.scatter(coords[:, 0], coords[:, 1], coords[:, 2], c=ids, s=1,
                   cmap="tab20")
        ax.set_title(name)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def _named_grads(grads, prefix=""):
    """(name, gradient) pairs: a module's parameters that hold a gradient,
    or the leaves of a nested dict, keys joined with '/'."""
    if hasattr(grads, "named_parameters"):
        for name, p in grads.named_parameters():
            if p.grad is not None:
                yield name, p.grad
        return
    for key in sorted(grads):  # a pytree's order: keys sorted per level
        g = grads[key]
        name = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(g, dict):
            yield from _named_grads(g, name)
        elif g is not None:
            yield name, g


def _as_numpy(g) -> np.ndarray:
    if not hasattr(g, "detach"):
        return np.asarray(g)
    g = g.detach().cpu()
    if g.is_floating_point() and g.element_size() < 4:  # numpy has no bf16
        g = g.float()
    return g.numpy()


# from mask3d_tpu/utils/visualize.py:66 gradient_flow_stats
def gradient_flow_stats(grads) -> Dict[str, Dict[str, float]]:
    """Per-parameter mean/max absolute gradient (gradflow_check.py analog)
    of an `nn.Module`'s parameters or a nested dict of gradients."""
    stats = {}
    for name, g in _named_grads(grads):
        a = np.abs(_as_numpy(g))
        stats[name] = {"mean_abs": float(a.mean()), "max_abs": float(a.max())}
    return stats


# from mask3d_tpu/utils/visualize.py:79 plot_gradient_flow
def plot_gradient_flow(grads, path: str = "gradflow.png"):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    stats = gradient_flow_stats(grads)
    names = list(stats.keys())
    means = [stats[n]["mean_abs"] for n in names]
    maxs = [stats[n]["max_abs"] for n in names]
    fig, ax = plt.subplots(figsize=(max(8, len(names) * 0.2), 5))
    x = np.arange(len(names))
    ax.bar(x, maxs, alpha=0.4, label="max |g|")
    ax.bar(x, means, alpha=0.8, label="mean |g|")
    ax.set_yscale("log")
    ax.set_xticks(x[:: max(1, len(names) // 40)])
    ax.set_xticklabels(
        [names[i] for i in x[:: max(1, len(names) // 40)]],
        rotation=90, fontsize=5,
    )
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


# from mask3d_tpu/utils/visualize.py:106 plot_floorplan
def plot_floorplan(room_polys, gt_polys=None, path: str = "floorplan.png",
                   image_size: int = 256):
    """Floorplan polygon plot (reference `RoomFormer/util/plot_utils.py` and
    `datasets_preprocess/.../visualize_floorplan.py` capability)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import Polygon as MplPolygon

    fig, ax = plt.subplots(figsize=(7, 7))
    for polys, color, label in (
        (gt_polys or [], "tab:green", "gt"),
        (room_polys, "tab:blue", "pred"),
    ):
        for i, p in enumerate(polys):
            ax.add_patch(
                MplPolygon(
                    np.asarray(p).reshape(-1, 2), closed=True, fill=False,
                    edgecolor=color, linewidth=1.5,
                    label=label if i == 0 else None,
                )
            )
    ax.set_xlim(0, image_size)
    ax.set_ylim(image_size, 0)
    ax.set_aspect("equal")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path
