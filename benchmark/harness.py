"""The benchmark's machinery shared by every loop: the cell's files, the
program under test built with the benchmark's weights, host spans, the
device trace, the correctness comparison with the plain reference, and
the result line.

A cell is found by name: `BENCHMARK.json`'s workload entry names its
configuration (`benchmark/configs/<config>.json`) and its traffic
(`benchmark/traffic/<traffic>.json`); `benchmark/workloads/<name>.json`
holds the deployment (the loop, the entry, the program's overrides, the
control, the limits). A loop is `benchmark/loops/<loop>.py` and a
per-layer metric `benchmark/metrics/<metric>.py`, each found by its name.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import threading
import time
from contextlib import contextmanager, nullcontext
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mask3d_tpu")


def set_environment():
    """Before torch is imported: the build and kernel caches inside the
    checkout, and no library that loads JAX by itself."""
    import os

    cache = ROOT / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """Loaded modules whose whole top-level name is forbidden."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


class Spans:
    """Host spans of the run: (name, thread id, start, end) on the host's
    monotonic clock, and the same ends in wall-clock nanoseconds, the
    clock of the profiler's device events, so that the device trace can
    be read against them."""

    def __init__(self):
        self.items = []  # (name, thread, start, end) in perf_counter s
        self.wall = []  # (name, thread, start, end) in ns since the epoch
        self._lock = threading.Lock()

    def _add(self, name, t0, t1, w0, w1):
        tid = threading.get_ident()
        with self._lock:
            self.items.append((name, tid, t0, t1))
            self.wall.append((name, tid, w0, w1))

    @contextmanager
    def span(self, name: str):
        w0, t0 = time.time_ns(), time.perf_counter()
        yield
        self._add(name, t0, time.perf_counter(), w0, time.time_ns())

    def open(self, name: str):
        """A span left open until `close`."""
        return (name, time.perf_counter(), time.time_ns())

    def close(self, handle):
        name, t0, w0 = handle
        self._add(name, t0, time.perf_counter(), w0, time.time_ns())

    def durations(self, name: str, t0=None, t1=None) -> List[float]:
        return [e - s for n, _, s, e in self.items if n == name
                and (t0 is None or s >= t0) and (t1 is None or e <= t1)]


class Run:
    """One run of one cell: its files, its arguments and what it
    measured."""

    def __init__(self, name: str, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", manifest: Optional[Dict] = None,
                 files: Optional[Dict] = None, t_start: float = None):
        if seed < 0:
            raise ValueError("--seed is a whole number >= 0")
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.name = name
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.manifest = manifest or load_json(ROOT / "BENCHMARK.json")
        cells = {w["name"]: w for w in self.manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.entry = cells[name]
        files = files or {}
        configs = {c["name"]: c for c in self.manifest["configs"]}
        self.config = files.get("config") or load_json(
            ROOT / configs[self.entry["config"]]["file"])
        self.traffic = files.get("traffic") or load_json(
            BENCH / "traffic" / f"{self.entry['traffic']}.json")
        self.cell = files.get("cell") or load_json(
            BENCH / "workloads" / f"{name}.json")
        self.arch = self.config["architecture"]
        self.spans = Spans()
        # filled by the loop
        self.metrics: Dict[str, float] = {}
        self.attempted = 0
        self.failed = 0
        # (unique batch index, check.Outputs) of the sampled batches
        self.samples = []
        # the sampled forward running now (a unique batch index), and what
        # the model's hooks kept of each: (aux_pred_class, sampled_coords,
        # decoder_norm's outputs)
        self.tag = None
        self.rounds = {}
        self._embeds = []
        self.refs = {}  # unique batch -> the reference's outputs
        self.numbers = {}  # the numbers compared, once checked
        self.forwards: List[int] = []  # unique batch of each forward
        self.window = None  # (t0, t1) on the host's clock
        self.prof = None
        self.notes: List[str] = []
        self.memory_peak = 0
        self.t_first_dispatch = None
        # the control in the program's place (`--control 1`), or None
        self.control = None

    # -- the program under test -------------------------------------------

    def overrides(self, extra=()):
        return (list(self.config.get("overrides", []))
                + [f"data.point_bucket_multiple={self.traffic['bucket']}"]
                + list(self.cell.get("overrides", [])) + list(extra))

    def weights(self):
        from benchmark import weights

        if not hasattr(self, "_weights"):
            self._weights = weights.draw(self.arch, self.seed, self.device)
        return self._weights

    def build_program(self, extra=()):
        """(cfg, model) of the program with the benchmark's weights."""
        import mask3d_tpu_torch as mt
        from mask3d_tpu_torch.config import Config, apply_overrides

        cfg = apply_overrides(Config(), self.overrides(extra))
        model = mt.build_model(cfg, device=self.device, seed=0)
        model.load_state_dict(self.weights(), strict=True)
        model.decoder_norm.register_forward_hook(self._keep_embed)
        model.register_forward_hook(self._keep_rounds)
        return cfg, model

    def _keep_embed(self, module, args, out):
        """`decoder_norm`'s forward hook: the normalized queries of each
        mask-module call of the sampled forward that runs now."""
        if self.tag is not None:
            self._embeds.append(out)

    def _keep_rounds(self, module, args, out):
        """The model's forward hook: keeps the device tensors of every
        round's class logits and normalized queries and the query
        positions of the sampled forward that runs now (no copy, no
        sync)."""
        if self.tag is not None:
            self.rounds[self.tag] = (out.aux_pred_class, out.sampled_coords,
                                     self._embeds)
        self._embeds = []

    def kept(self, u: int, masks, counts):
        """The check's record of unique batch `u`'s sampled forward, on
        the host: its rounds and query positions from the hook and its
        `pred_masks` (`masks`, numpy)."""
        import torch

        from benchmark.check import Outputs

        rounds, xyz, embeds = self.rounds.pop(u)
        return (u, Outputs(rounds.float().cpu().numpy(), masks,
                           xyz.float().cpu().numpy(), counts,
                           torch.stack(embeds).float().cpu().numpy()))

    def unique_batches(self):
        from benchmark.traffic import scenes

        if not hasattr(self, "_unique"):
            self._unique = scenes.batches(self.traffic, self.seed)
        return self._unique

    def check_indices(self) -> List[int]:
        """The unique batches whose outputs the reference checks: two,
        drawn from the seed among the first 12 of the window."""
        u = int(self.traffic["unique_batches"])
        rng = np.random.default_rng([self.seed, 1])
        return sorted(int(i) for i in rng.choice(min(u, 12), size=min(2, u),
                                                 replace=False))

    # -- tracing ------------------------------------------------------------

    def profiler(self):
        """The device's activity (kernels, copies, sets) over the window;
        the host's operators are not recorded, so tracing slows the host
        no more than CUPTI's own cost a launch. Nothing on the CPU."""
        if not self.trace or self.device == "cpu":
            return nullcontext()
        import torch

        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        return self.prof


class PowerSampler:
    """`nvidia-smi` sampling the card's clocks and power beside the
    window, in a process stopped and waited for at the end."""

    QUERY = "clocks.sm,clocks.mem,power.draw,power.limit,temperature.gpu"

    def __init__(self, enabled: bool):
        self.proc = None
        self.out = ""
        if not enabled:
            return
        import shutil
        import subprocess

        exe = shutil.which("nvidia-smi")
        if exe:
            self.proc = subprocess.Popen(
                [exe, f"--query-gpu={self.QUERY}", "--id=0",
                 "--format=csv,noheader,nounits", "-lms", "500"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

    def stop(self) -> str:
        """One line: the median of each sampled column, and how many
        samples."""
        if self.proc is None:
            return "clocks/power: not sampled"
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        rows = []
        for line in out.strip().splitlines():
            try:
                rows.append([float(x) for x in line.split(",")])
            except ValueError:
                continue
        if not rows:
            return "clocks/power: no sample"
        med = np.median(np.asarray(rows), axis=0)
        names = self.QUERY.split(",")
        return ("clocks/power over the window (median of "
                f"{len(rows)} samples): "
                + ", ".join(f"{n} {v:g}" for n, v in zip(names, med)))


def card_power_limit() -> str:
    import shutil
    import subprocess

    exe = shutil.which("nvidia-smi")
    if not exe:
        return "unknown"
    res = subprocess.run([exe, "--query-gpu=power.limit", "--id=0",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30)
    return res.stdout.strip() or "unknown"


def setup_phases(r: Run) -> str:
    """The set-up's parts: from the process's start to the loop's first
    set-up span (interpreter, imports), each `setup.*` span, and the rest
    up to the first dispatch."""
    parts = [(n, s, e) for n, _, s, e in r.spans.items
             if n.startswith("setup.")]
    if not parts:
        return "none recorded"
    out = [("start", parts[0][1] - r.t_start)]
    out += [(n[len("setup."):], e - s) for n, s, e in parts]
    out.append(("rest", r.t_first_dispatch - parts[-1][2]))
    return ", ".join(f"{n} {v:.3f}" for n, v in out)


def selected(entries, cell: str):
    """The metrics of `entries` that this cell reports."""
    return [m for m in entries if "workloads" not in m
            or cell in m["workloads"]]


def check_outputs(r: Run, log=print) -> Dict:
    """The numbers compared: the sampled batches' outputs against the
    plain reference, once the window has closed and the program's state
    is freed; with `r.control` set, the control in the program's place.
    The reference's outputs are kept on the run for a second call."""
    import torch

    from benchmark import check

    if r.device != "cpu":
        torch.cuda.empty_cache()
    # the control: the reference in a lower precision in the program's place
    precision = r.control["precision"] if r.control else "fp32"
    unique = r.unique_batches()
    per_batch = []
    t_ref = time.perf_counter()
    for u, got in r.samples:
        if u not in r.refs:
            r.refs[u] = check.reference_batch(r, unique[u], r.n_cap)
        if precision != "fp32":
            got = check.as_program(check.reference_batch(
                r, unique[u], r.n_cap, precision), r.n_cap)
        per_batch.append(check.numbers(got, r.refs[u]))
    nums = check.merge(per_batch)
    log(f"reference ({precision} in the program's place) over "
        f"{len(r.samples)} batch(es) {[s[0] for s in r.samples]}: "
        f"{time.perf_counter() - t_ref:.1f} s")
    log("numbers: " + json.dumps(nums))
    return nums


def execute(r: Run, log=print) -> Dict:
    """Runs the cell's loop, checks its outputs and returns the result
    line's object. `log` takes the lines for standard error."""
    import torch

    from benchmark import check

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    loop = load_module(BENCH / "loops" / f"{r.cell['loop']}.py",
                       f"bench_loop_{r.cell['loop']}")
    gpu = r.device != "cpu"
    power = PowerSampler(gpu)
    try:
        loop.run(r)
    finally:
        log(power.stop())
    for note in r.notes:
        log(note)
    setup_s = r.t_first_dispatch - r.t_start
    log(f"setup_s {setup_s:.3f}")
    log("setup phases (s): " + setup_phases(r))
    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded: {found}")

    summ = None
    if r.trace and r.prof is not None:
        from benchmark import devtrace as tr

        t_read = time.perf_counter()
        kernels = tr.read(r.prof)
        r.prof = None
        summ = tr.summary(kernels, r.spans.wall)
        log(f"trace: {len(kernels)} device operations, "
            f"{summ['inside']} inside the window, first at "
            f"{summ['first_us']:.1f} us past its start; read in "
            f"{time.perf_counter() - t_read:.1f} s")

    nums = r.numbers = check_outputs(r, log)
    correct, checks = check.judge(r.cell.get("limits", {}), nums)
    correct = correct and r.failed == 0 and r.attempted > 0

    units = {m["name"]: m["unit"] for m in
             r.manifest["end_to_end"] + r.manifest["per_layer"]}
    metrics = {}
    if not r.trace:
        values = dict(r.metrics, setup_s=setup_s)
        for m in selected(r.manifest["end_to_end"], r.name):
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": units[m["name"]]}
    else:
        for m in selected(r.manifest["per_layer"], r.name):
            path = BENCH / "metrics" / f"{m['name']}.py"
            mod = load_module(path, "bench_metric_" + m["name"].replace(
                ".", "_"))
            value = mod.read(r, summ)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
    device = {"platform": "gpu" if gpu else "cpu",
              "kind": torch.cuda.get_device_name(0) if gpu else "cpu",
              "count": 1, "memory_peak_bytes": int(r.memory_peak)}
    result = {"correct": bool(correct), "attempted": r.attempted,
              "failed": r.failed, "metrics": metrics, "device": device}
    if summ is not None:
        from benchmark import devtrace as tr

        device["busy_s"] = summ["busy_s"]
        device["window_s"] = summ["window_s"]
        result["breakdown"] = tr.breakdown(summ)
    result["checks"] = checks
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    return result
