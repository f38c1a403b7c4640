"""Operations and bytes of a forward, from a batch's voxels.

Sparse model FLOPs, what the inputs need as MinkowskiEngine computes them
(not the dense grids that the `dense` path convolves):

- a same-stride k^3 conv: 2 x active (output, input) pairs x Cin x Cout;
- a stride-2 conv and its transpose: 2 x fine rows x Cin x Cout (each fine
  row is one pair with its parent);
- a 1x1 conv or a linear layer: 2 x rows x Cin x Cout;
- the decoder's masked cross-attention: 4 x Q x S x D a layer (S the
  level's voxels), with its Q/K/V/out projections, the attention-mask
  logits 2 x S x Q x D, self-attention, FFN and mask-embedding MLP over
  the Q queries, and the output masks 2 x N0 x Q x D.

Norms, activations and the positional encodings are not counted. The
shapes per level come from the plain reference's pyramid of each scene.

`attention_bound_s` and `sparse_conv_bound_s` are the per-launch
rooflines of the program's two kernels of `PERF.md`'s kernel table:
bytes read once and written once, against the HBM rate, or operations
against the peak of the kernel's arithmetic (f32 for the attention, bf16
tensor cores for the sparse conv), whichever is longer.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark.peaks import bound_s
from benchmark.reference.mask3d_plain import level_capacities, pyramid, \
    voxelize


def scene_shapes(points: np.ndarray, n_cap: int, ratios, device) -> Dict:
    """Rows of each level and active pairs of the 3^3 (every level) and
    5^3 (level 0) kernel maps of one scene."""
    coords, dims = voxelize(points)
    caps = level_capacities(n_cap, ratios)
    levels, _ = pyramid(coords, dims, caps, device)
    rows = [lv.n for lv in levels]
    pairs3 = [int((lv.neighbours(1) >= 0).sum()) for lv in levels]
    pairs5 = int((levels[0].neighbours(2) >= 0).sum())
    return {"rows": rows, "pairs3": pairs3, "pairs5": pairs5,
            "caps": [n_cap] + caps}


def backbone_flops(bb: Dict, sh: Dict) -> float:
    p, lay, e, c0 = bb["planes"], bb["layers"], bb["expansion"], \
        bb["init_dim"]
    n, pr3 = sh["rows"], sh["pairs3"]
    k1 = bb["conv1_kernel_size"]
    stem_pairs = sh["pairs5"] if k1 == 5 else pr3[0]
    total = 2.0 * stem_pairs * bb["in_channels"] * c0

    def stage(level, cin, planes, blocks):
        t = 0.0
        for i in range(blocks):
            ci = cin if i == 0 else planes * e
            if bb["block"] == "bottleneck":
                t += 2.0 * n[level] * ci * planes
                t += 2.0 * pr3[level] * planes * planes
                t += 2.0 * n[level] * planes * planes * e
            else:
                t += 2.0 * pr3[level] * ci * planes
                t += 2.0 * pr3[level] * planes * planes
            if ci != planes * e:
                t += 2.0 * n[level] * ci * planes * e
        return t

    enc_in = [c0, p[0] * e, p[1] * e, p[2] * e]
    for i in range(4):
        total += 2.0 * n[i] * enc_in[i] * enc_in[i]
        total += stage(i + 1, enc_in[i], p[i], lay[i])
    dec_in = [p[3] * e, p[4] * e, p[5] * e, p[6] * e]
    skips = [p[2] * e, p[1] * e, p[0] * e, c0]
    for i in range(4):
        fine = 3 - i
        total += 2.0 * n[fine] * dec_in[i] * p[4 + i]
        total += stage(fine, p[4 + i] + skips[i], p[4 + i], lay[4 + i])
    return total


def decoder_flops(bb: Dict, dec: Dict, sh: Dict) -> float:
    d, f, q = dec["hidden_dim"], dec["dim_feedforward"], dec["num_queries"]
    e = bb["expansion"]
    fm = [c * e for c in bb["planes"][3:8]]
    n = sh["rows"]
    nl = len(n)
    total = 2.0 * n[0] * fm[-1] * d  # mask_features_head
    total += 2.0 * 2 * 3 * d * d  # query position MLP (PE 3 -> D -> D)
    per_query_layers = (2 * 2 * q * d * d  # cross q, out
                        + 2 * 4 * q * d * d + 4 * q * q * d  # self-attn
                        + 2 * 2 * q * d * f  # FFN
                        + 2 * 2 * q * d * d + 2 * q * d * 2)  # mask module
    for h in dec["hlevels"]:
        s = n[nl - 1 - h]
        total += 2.0 * s * fm[h] * d + 2 * 2.0 * s * d * d  # squeeze, k, v
    for _ in range(dec["num_decoders"]):
        for h in dec["hlevels"]:
            s = n[nl - 1 - h]
            total += 2.0 * s * q * d + 4.0 * q * s * d + per_query_layers
    total += 2.0 * n[0] * q * d + 2 * 2 * q * d * d  # output masks
    return total


def forward_flops(arch: Dict, shapes: List[Dict]) -> float:
    """Sparse model FLOPs of one forward over the scenes of a batch."""
    return sum(backbone_flops(arch["backbone"], sh)
               + decoder_flops(arch["backbone"], arch["decoder"], sh)
               for sh in shapes)


def attention_bound_s(arch: Dict, shapes: List[Dict], peaks: Dict) -> float:
    """Sum of the masked-attention launches' bounds in one forward: one
    launch a (round, level) over the batch at the level's padded rows."""
    dec = arch["decoder"]
    b, q, d = len(shapes), dec["num_queries"], dec["hidden_dim"]
    caps = shapes[0]["caps"]
    nl = len(caps)
    total = 0.0
    for _ in range(dec["num_decoders"]):
        for h in dec["hlevels"]:
            s = caps[nl - 1 - h]
            nbytes = 4 * (2 * b * q * d + 2 * b * s * d) + b * q * s
            total += bound_s(nbytes, 4.0 * b * q * s * d, peaks["fp32"],
                             peaks["hbm_bytes_per_s"])
    return total


def sparse_conv_bound_s(arch: Dict, shapes: List[Dict], peaks: Dict,
                        in_bytes: int = 2) -> float:
    """Sum of the bounds of one forward's same-stride k^3 convs (k > 1),
    each a launch over the batch's padded rows at its level: the kernel
    map (i32 index and bool flag an entry), the input rows, the bf16
    weights and the f32 output rows in bytes, 2 x active pairs x Cin x Cout
    operations on the bf16 tensor cores."""
    bb = arch["backbone"]
    p, lay, e, c0 = bb["planes"], bb["layers"], bb["expansion"], \
        bb["init_dim"]
    b = len(shapes)
    caps = shapes[0]["caps"]
    pairs3 = [sum(sh["pairs3"][lv] for sh in shapes)
              for lv in range(len(caps))]
    pairs5 = sum(sh["pairs5"] for sh in shapes)
    launches = []  # (level, K, active pairs, Cin, Cout)
    k1 = bb["conv1_kernel_size"]
    launches.append((0, k1 ** 3, pairs5 if k1 == 5 else pairs3[0],
                     bb["in_channels"], c0))

    def stage(level, cin, planes, blocks):
        for i in range(blocks):
            ci = cin if i == 0 else planes * e
            if bb["block"] == "bottleneck":
                launches.append((level, 27, pairs3[level], planes, planes))
            else:
                launches.append((level, 27, pairs3[level], ci, planes))
                launches.append((level, 27, pairs3[level], planes, planes))

    enc_in = [c0, p[0] * e, p[1] * e, p[2] * e]
    for i in range(4):
        stage(i + 1, enc_in[i], p[i], lay[i])
    skips = [p[2] * e, p[1] * e, p[0] * e, c0]
    for i in range(4):
        stage(3 - i, p[4 + i] + skips[i], p[4 + i], lay[4 + i])
    total = 0.0
    for level, k, n_ok, cin, cout in launches:
        n = caps[level]
        nbytes = (b * n * k * 5 + b * n * cin * in_bytes + k * cin * cout * 2
                  + b * n * cout * 4)
        total += bound_s(nbytes, 2.0 * n_ok * cin * cout, peaks["bf16"],
                         peaks["hbm_bytes_per_s"])
    return total


def batch_shapes(items, n_cap: int, arch: Dict, device) -> List[Dict]:
    with torch.no_grad():
        return [scene_shapes(it["coordinates"], n_cap,
                             arch["level_cap_ratios"], device)
                for it in items]
