"""The readings that a cell's limits are set from: the numbers compared,
of sound runs and of the control, over many seeds in one process.

    python3 benchmark/readings.py --workload <cell> --seeds 11,12,...
        --controls 11,12,13 --seconds 3

Each seed is one run of the cell (`harness.execute`: its loop at the
cell's own load, with a window of `--seconds` that runs on until the
sampled batches have run, then the check); a seed in `--controls` is read
again with the cell's control in the program's place, against the same
reference outputs. One JSON line a reading on standard output:
{"seed", "control", "correct", "numbers"}.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path[0] = str(ROOT)
    from benchmark import harness, check

    harness.set_environment()
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    controls = {int(s) for s in args.controls.split(",") if s}

    def log(line):
        print(line, file=sys.stderr, flush=True)

    for seed in (int(s) for s in args.seeds.split(",")):
        r = harness.Run(args.workload, seed, args.seconds, False, "cuda")
        res = harness.execute(r, log)
        print(json.dumps({"seed": seed, "control": None,
                          "correct": res["correct"],
                          "numbers": r.numbers}), flush=True)
        if seed in controls:
            r.control = r.cell["control"]
            nums = harness.check_outputs(r, log)
            ok, _ = check.judge(r.cell.get("limits", {}), nums)
            print(json.dumps({"seed": seed,
                              "control": r.control["precision"],
                              "correct": ok, "numbers": nums}), flush=True)
        del r
        torch.cuda.empty_cache()
    found = harness.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
