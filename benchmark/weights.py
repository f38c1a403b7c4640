"""Seeded random weights of a configuration, drawn on the device.

The benchmark, not the program, makes the weights: one normal draw on a
`torch.Generator` of the run's device fills every matrix (He-normal conv
kernels, std sqrt(2 / fan_in); Glorot-normal linear kernels, std
sqrt(2 / (fan_in + fan_out)); a unit-normal Fourier projection times
`gauss_scale`), and the norm gains are 1, every bias 0. The tensors are
named as the program's parameters, so the program takes them with a
strict `load_state_dict` (a layout it no longer has fails loudly) and the
plain reference reads them by the same names.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

# (name, shape, kind): kind "he" (fan_in = prod(shape[1:]) or, for a
# transposed conv, shape[0] * prod(shape[2:])), "glorot", "gauss", "one",
# "zero"
Spec = List[Tuple[str, Tuple[int, ...], str]]


def backbone_spec(bb: dict, prefix: str = "backbone.") -> Spec:
    planes, layers = bb["planes"], bb["layers"]
    e = bb["expansion"]
    c0 = bb["init_dim"]
    spec: Spec = []

    def conv(name, k, cin, cout, transpose=False):
        shape = (cin, cout) if transpose else (cout, cin)
        spec.append((f"{prefix}convs.{name}.weight", shape + (k, k, k),
                     "he_tr" if transpose else "he"))

    def norm(name, c):
        spec.append((f"{prefix}norms.{name}.weight", (c,), "one"))
        spec.append((f"{prefix}norms.{name}.bias", (c,), "zero"))

    def stage(s, cin, p, n):
        for i in range(n):
            name = f"block{s}_{i}"
            ci = cin if i == 0 else p * e
            if bb["block"] == "bottleneck":
                conv(f"{name}_conv1", 1, ci, p)
                conv(f"{name}_conv2", 3, p, p)
                conv(f"{name}_conv3", 1, p, p * e)
            else:
                conv(f"{name}_conv1", 3, ci, p)
                conv(f"{name}_conv2", 3, p, p)
            if ci != p * e:
                conv(f"{name}_downsample", 1, ci, p * e)
            norm(f"{name}_norm1", p)
            norm(f"{name}_norm2", p)
            if bb["block"] == "bottleneck":
                norm(f"{name}_norm3", p * e)
            if ci != p * e:
                norm(f"{name}_downsample_norm", p * e)

    conv("conv0p1s1", bb["conv1_kernel_size"], bb["in_channels"], c0)
    norm("bn0", c0)
    enc_in = [c0, planes[0] * e, planes[1] * e, planes[2] * e]
    for i in range(4):
        name = f"conv{i + 1}p{2 ** i}s2"
        conv(name, 2, enc_in[i], enc_in[i])
        norm(name.replace("conv", "bn"), enc_in[i])
        stage(i + 1, enc_in[i], planes[i], layers[i])
    dec_in = [planes[3] * e, planes[4] * e, planes[5] * e, planes[6] * e]
    skips = [planes[2] * e, planes[1] * e, planes[0] * e, c0]
    for i in range(4):
        name = f"convtr{i + 4}p{2 ** (4 - i)}s2"
        conv(name, 2, dec_in[i], planes[4 + i], transpose=True)
        norm(name.replace("convtr", "bntr"), planes[4 + i])
        stage(i + 5, planes[4 + i] + skips[i], planes[4 + i], layers[4 + i])
    return spec


def decoder_spec(bb: dict, dec: dict) -> Spec:
    d, f = dec["hidden_dim"], dec["dim_feedforward"]
    e = bb["expansion"]
    fm = [p * e for p in bb["planes"][3:8]]  # strides 16, 8, 4, 2, 1
    spec: Spec = []

    def lin(name, cin, cout):
        spec.append((f"{name}.weight", (cout, cin), "glorot"))
        spec.append((f"{name}.bias", (cout,), "zero"))

    def ln(name):
        spec.append((f"{name}.weight", (d,), "one"))
        spec.append((f"{name}.bias", (d,), "zero"))

    lin("mask_features_head", fm[-1], d)
    lin("query_proj_hidden", d, d)
    lin("query_proj_out", d, d)
    for li, h in enumerate(dec["hlevels"]):
        key = f"0_{li}"
        for part in ("cross", "self_attn"):
            for m in ("q", "k", "v", "out"):
                lin(f"{part}.{key}.attn.{m}", d, d)
            ln(f"{part}.{key}.norm")
        lin(f"ffn.{key}.lin1", d, f)
        lin(f"ffn.{key}.lin2", f, d)
        ln(f"ffn.{key}.norm")
        lin(f"squeeze.{key}", fm[h], d)
    ln("decoder_norm")
    lin("mask_embed_hidden", d, d)
    lin("mask_embed_out", d, d)
    lin("class_embed_head", d, dec["num_classes"] + 1)
    spec.append(("gauss_B", (3, d // 2), "gauss"))
    return spec


def model_spec(arch: dict) -> Spec:
    return backbone_spec(arch["backbone"]) + decoder_spec(
        arch["backbone"], arch["decoder"])


def _numel(shape):
    n = 1
    for s in shape:
        n *= s
    return n


def draw(arch: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every tensor of `model_spec(arch)`, float32 on `device`, from one
    normal draw of a generator seeded with `seed`."""
    spec = model_spec(arch)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    drawn = [(n, s, k) for n, s, k in spec if k not in ("one", "zero")]
    total = sum(_numel(s) for _, s, _ in drawn)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    gauss_scale = float(arch["decoder"].get("gauss_scale", 1.0))
    for name, shape, kind in spec:
        if kind == "one":
            out[name] = torch.ones(shape, device=device)
            continue
        if kind == "zero":
            out[name] = torch.zeros(shape, device=device)
            continue
        n = _numel(shape)
        t = flat[at:at + n].view(shape)
        at += n
        if kind == "he":
            std = (2.0 / _numel(shape[1:])) ** 0.5
        elif kind == "he_tr":
            std = (2.0 / (shape[0] * _numel(shape[2:]))) ** 0.5
        elif kind == "glorot":
            std = (2.0 / (shape[0] + shape[1])) ** 0.5
        else:  # "gauss"
            std = gauss_scale
        out[name] = t * std
    return out
