"""The benchmark of mask3d_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1> [--control 0|1]

Loads the cell named in `BENCHMARK.json`, makes its weights and traffic
from `--seed`, sets up and warms up the program, measures for `--seconds`
and prints one JSON object as the last line of standard output: with
`--trace 0` the cell's end-to-end metrics, with `--trace 1` its per-layer
metrics read from a `torch.profiler` trace of the window, and in both
`correct`, judged against the plain reference once the window has closed
(`benchmark/check.py`); the numbers compared, each beside its limit, are
also the last lines of standard error. `--control 1` puts the cell's
control (its file's "control") in the program's place for the
comparison: a run that must come out not correct.

Runs on a CUDA card only: without one, or with fewer cards than the cell
asks for, it prints no result and exits 2. Build and kernel caches stay
in the checkout (`mask3d_tpu_torch/_build/`, the program's; Triton and
torch extension caches under `.bench_cache/`).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[0] = str(ROOT)  # not benchmark/: its modules are benchmark.*
    from benchmark import harness

    harness.set_environment()
    manifest_path = ROOT / "BENCHMARK.json"
    if not (ROOT / "mask3d_tpu_torch").is_dir():
        print("the program (mask3d_tpu_torch) is not beside the benchmark",
              file=sys.stderr)
        return 2
    with open(manifest_path) as f:
        manifest = json.load(f)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    # the host's own threads kept few: one intra-op thread (the feeders'
    # collation runs in the program's own pool)
    torch.set_num_threads(1)
    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run = harness.Run(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", manifest, t_start=T_START)
    if args.control:
        run.control = run.cell["control"]
    print(f"{args.workload} seed {args.seed} on "
          f"{torch.cuda.get_device_name(0)}, power limit "
          f"{harness.card_power_limit()}, torch {torch.__version__}",
          file=sys.stderr)

    def log(line):
        print(line, file=sys.stderr, flush=True)

    result = harness.execute(run, log)
    found = harness.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
