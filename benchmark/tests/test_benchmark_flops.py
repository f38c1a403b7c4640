"""The FLOP and bound arithmetic on shapes worked out by hand."""

import numpy as np
import pytest

from benchmark import flops
from benchmark.peaks import PEAKS

H100 = PEAKS["NVIDIA H100 80GB HBM3"]


def test_pairs_of_two_neighbours():
    # two voxels side by side in x: each sees itself and the other
    sh = flops.scene_shapes(np.array([[0, 0, 0], [1, 0, 0]], np.float32),
                            8, [0.5, 0.5, 0.5, 0.5], "cpu")
    assert sh["rows"] == [2, 1, 1, 1, 1]
    assert sh["pairs3"] == [4, 1, 1, 1, 1]
    assert sh["pairs5"] == 4
    assert sh["caps"] == [8, 8, 8, 8, 8]


def test_backbone_flops_by_hand():
    bb = {"block": "basic", "expansion": 1, "init_dim": 2, "in_channels": 1,
          "conv1_kernel_size": 3, "planes": [2] * 8, "layers": [1] * 8}
    sh = {"rows": [2, 1, 1, 1, 1], "pairs3": [4, 1, 1, 1, 1], "pairs5": 4}
    # stem 2*4*1*2 = 16; each down conv 2*n_fine*2*2 (n 2,1,1,1) = 16+8*3;
    # each block at level l: two 3^3 convs 2*pairs*2*2 (pairs 1) = 16;
    # each transposed conv 2*n_fine*2*2 (n_fine 1,1,1,2) = 8*3+16; the
    # decoder blocks take 4 channels in (2 + skip 2): conv1 2*p*4*2,
    # conv2 2*p*2*2, downsample 2*n*4*2, at levels 3,2,1 (p 1, n 1) and
    # level 0 (p 4, n 2)
    enc = 16 + (16 + 8 * 3) + 4 * 16
    dec = (8 * 3 + 16) + 3 * (16 + 8 + 16) + (64 + 32 + 32)
    assert flops.backbone_flops(bb, sh) == enc + dec


def test_attention_bound_matches_the_kernel_table():
    # PERF.md's kernel table, row 1: S = 24576, B = 8, Q = 25, D = 128:
    # 0.0616 ms (bytes); the flagship forward's 12 launches 0.3470 ms
    dec = {"num_queries": 25, "hidden_dim": 128, "num_decoders": 1,
           "hlevels": [3]}
    caps = [49152, 24576, 12288, 6144, 3072]
    shapes = [{"caps": caps}] * 8
    one = flops.attention_bound_s({"decoder": dec}, shapes, H100)
    assert one * 1e3 == pytest.approx(0.0616, abs=5e-4)
    dec.update(num_decoders=3, hlevels=[0, 1, 2, 3])
    assert flops.attention_bound_s({"decoder": dec}, shapes, H100) * 1e3 \
        == pytest.approx(0.3470, abs=5e-4)


def test_sparse_conv_bound_matches_chip_smoke():
    """`chip_smoke.py`'s L0 96->96 launch bound, f32 rows: 0.1061 ms."""
    from benchmark.peaks import bound_s

    b, n, k, c = 8, 49152, 27, 96
    n_ok = int(0.231 * b * n * k)
    nbytes = b * n * k * 5 + b * n * c * 4 + k * c * c * 2 + b * n * c * 4
    t = bound_s(nbytes, 2.0 * n_ok * c * c, H100["bf16"],
                H100["hbm_bytes_per_s"])
    assert t * 1e3 == pytest.approx(0.1061, abs=5e-4)


def test_sparse_conv_launches_of_the_two_backbones():
    """47 launches a Res16UNet34C forward, 41 a Res16UNet101 one (the
    counts the card saw, PERF.md's kernel table row 4)."""
    import json
    from pathlib import Path

    root = Path(__file__).resolve().parents[1] / "configs"
    shapes = [{"caps": [64] * 5, "pairs3": [0] * 5, "pairs5": 0}]
    peaks = {"hbm_bytes_per_s": 1.0, "bf16": 1.0}
    r34c = json.loads((root / "mask3d-res16unet34c.json").read_text())[
        "architecture"]
    # Res16UNet101: the same zoo's bottleneck blocks, x4 expansion
    r101 = dict(r34c, backbone=dict(
        r34c["backbone"], name="Res16UNet101", block="bottleneck",
        expansion=4, planes=[32, 64, 128, 256, 256, 256, 256, 256],
        layers=[2, 3, 4, 23, 2, 2, 2, 2]))
    for arch, want in ((r34c, 47), (r101, 41)):
        # with no pairs every launch is bound by bytes >= its map's 64*K*5
        t = flops.sparse_conv_bound_s(arch, shapes, peaks)
        assert t > want * 64 * 27 * 5
        assert t < (want + 1) * 64 * 125 * 5 + 1e9
        launches = 1 + sum(
            arch["backbone"]["layers"]) * (
                1 if arch["backbone"]["block"] == "bottleneck" else 2)
        assert launches == want
