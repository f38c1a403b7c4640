"""Global split-timer: named wall-clock segments per item.

Rebuild of `mask3d/utils/measure_runtime.py` (M16): call
`notify_start_item()` at the start of a step, `add_timing(name)` after each
phase (records the time since the previous mark), `notify_end_item()` at the
end; `log_final_statistics()` prints mean/median/min/max/count per segment.

A copy of mask3d_tpu/utils/meter.py. Device work is asynchronous, so
callers wait for it (a host copy of the result, or
`torch.cuda.synchronize()`) before `add_timing` for the segment to mean
anything.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List

logger = logging.getLogger(__name__)

_timings: Dict[str, List[float]] = {}
_last_mark: float | None = None
_enabled = True


# from mask3d_tpu/utils/meter.py:27 reset
def reset():
    global _timings, _last_mark
    _timings = {}
    _last_mark = None


# from mask3d_tpu/utils/meter.py:33 set_enabled
def set_enabled(flag: bool):
    global _enabled
    _enabled = flag


# from mask3d_tpu/utils/meter.py:38 notify_start_item
def notify_start_item():
    global _last_mark
    _last_mark = time.perf_counter()


# from mask3d_tpu/utils/meter.py:43 add_timing
def add_timing(name: str):
    global _last_mark
    if not _enabled or _last_mark is None:
        return
    now = time.perf_counter()
    _timings.setdefault(name, []).append(now - _last_mark)
    _last_mark = now


# from mask3d_tpu/utils/meter.py:52 notify_end_item
def notify_end_item():
    global _last_mark
    _last_mark = None


# from mask3d_tpu/utils/meter.py:57 record
def record(name: str, seconds: float):
    """Record an externally measured duration under `name` (used by the
    prefix-difference model-phase timer, which cannot use the running
    mark because phases are measured by re-running jitted prefixes)."""
    if _enabled:
        _timings.setdefault(name, []).append(seconds)


# from mask3d_tpu/utils/meter.py:65 get_statistics
def get_statistics() -> Dict[str, dict]:
    import numpy as np

    stats = {}
    for name, vals in _timings.items():
        arr = np.asarray(vals)
        stats[name] = {
            "mean": float(arr.mean()),
            "median": float(np.median(arr)),
            "min": float(arr.min()),
            "max": float(arr.max()),
            "count": len(vals),
        }
    return stats


# from mask3d_tpu/utils/meter.py:81 log_final_statistics
def log_final_statistics():
    stats = get_statistics()
    if not stats:
        return
    width = max(len(k) for k in stats)
    logger.info("runtime statistics (seconds):")
    for name, s in stats.items():
        logger.info(
            f"  {name:<{width}}  mean={s['mean']:.4f}  "
            f"median={s['median']:.4f}  min={s['min']:.4f}  "
            f"max={s['max']:.4f}  n={s['count']}"
        )
