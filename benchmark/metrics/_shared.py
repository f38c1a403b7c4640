"""What the per-layer metric readers share: the window's host spans, the
forwards of the traced window and their operations and bounds."""

from __future__ import annotations

import numpy as np

from benchmark import flops
from benchmark.peaks import peak


def window_spans(r, name):
    t0, t1 = r.window
    return r.spans.durations(name, t0, t1)


def mean_ms(r, name):
    d = window_spans(r, name)
    return float(np.mean(d)) * 1e3 if d else None


def card_peaks(summ):
    import torch

    return peak(torch.cuda.get_device_name(0)) if summ else None


def shapes(r):
    """Per unique batch, its scenes' level rows and active pairs."""
    if not hasattr(r, "_shapes"):
        r._shapes = [flops.batch_shapes(items, r.n_cap, r.arch, r.device)
                     for items in r.unique_batches()]
    return r._shapes


def per_forward_sum(r, fn):
    """Sum over the window's forwards of fn(shapes of its batch)."""
    sh = shapes(r)
    per_unique = {}
    total = 0.0
    for u in r.forwards:
        if u not in per_unique:
            per_unique[u] = fn(sh[u])
        total += per_unique[u]
    return total


def compute_dtype(r):
    ov = r.overrides()
    return "bf16" if "model.compute_dtype=bfloat16" in ov else "fp32"
