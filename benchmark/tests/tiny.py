"""A tiny cell for the CPU tests: the harness's files at a size a test
run holds (Res16UNet14A, hidden 32, 3x2 rooms of 12, batches of 2)."""

import copy
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

ARCH = {
    "backbone": {"name": "Res16UNet14A", "block": "basic", "expansion": 1,
                 "init_dim": 32, "in_channels": 1, "conv1_kernel_size": 3,
                 "planes": [32, 64, 128, 256, 128, 128, 96, 96],
                 "layers": [1, 1, 1, 1, 1, 1, 1, 1]},
    "decoder": {"hidden_dim": 32, "dim_feedforward": 64, "num_queries": 8,
                "num_heads": 4, "num_decoders": 2, "hlevels": [0, 1, 2, 3],
                "num_classes": 1, "gauss_scale": 1.0},
    "level_cap_ratios": [0.5, 0.25, 0.125, 0.0625],
}
CONFIG = {
    "name": "tiny",
    "overrides": ["model.hidden_dim=32", "model.dim_feedforward=64",
                  "model.num_queries=8", "model.num_heads=4",
                  "model.num_decoders=2", "model.backbone=Res16UNet14A",
                  "model.conv1_kernel_size=3"],
    "architecture": ARCH,
}
TRAFFIC = {"scene": "rooms",
           "params": {"num_rooms_x": 3, "num_rooms_y": 2, "room_size": 12,
                      "height": 6, "jitter": 0.3, "dropout": 0.5},
           "batch_size": 2, "unique_batches": 3, "bucket": 1024,
           "targets": False}
CELLS = {
    "tiny-pipelined": {"loop": "pipelined_batches", "entry": "infer",
                       "overrides": ["model.backbone_impl=gather"],
                       "feeders": 2, "in_flight": 2},
    "tiny-u8": {"loop": "pipelined_batches", "entry": "infer_u8",
                "overrides": ["model.backbone_impl=dense"],
                "feeders": 1, "in_flight": 2},
    "tiny-client": {"loop": "single_client", "entry": "infer",
                    "overrides": ["model.backbone_impl=gather"]},
}
# the tiny model's fp32 gaps to the reference are ~1e-6 (`mask_fit`,
# `embed_r1`), its TF32 ones 3e-3 or more, its fp8 ones 0.1 or more
# (measured): the limits between them
LIMITS = {"voxels": 0.0, "pad": 0.0, "fps": 0.0, "mask_fit": 1e-3,
          "embed_r1": 1e-3}


def manifest():
    """BENCHMARK.json with the tiny config and cells added."""
    with open(ROOT / "BENCHMARK.json") as f:
        m = json.load(f)
    m = copy.deepcopy(m)
    m["configs"].append({"name": "tiny", "source": "test", "file": "x",
                         "reduced": [], "why": "test"})
    for name in CELLS:
        m["workloads"].append({"name": name, "config": "tiny",
                               "traffic": "tiny", "chips": 1, "why": "t"})
        for metric in m["end_to_end"] + m["per_layer"]:
            if "workloads" in metric:
                metric["workloads"].append(name)
    return m


def run(name, seed=5, seconds=1.0, trace=False, limits=LIMITS):
    from benchmark import harness

    cell = dict(CELLS[name], limits=limits)
    return harness.Run(name, seed, seconds, trace, "cpu", manifest(),
                       files={"config": CONFIG, "traffic": TRAFFIC,
                              "cell": cell})
