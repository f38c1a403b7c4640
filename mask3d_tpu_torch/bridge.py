"""Carry trained weights across: the JAX package's Flax variables
`{"params": ..., "buffers": ...}` (nested dicts of numpy arrays) -> the
port's `state_dict`.

Layout conversions:
- backbone `<name>_kernel` [K, Cin, Cout] (C-order ravel of the kernel
  cube) -> [Cout, Cin, k, k, k]; transposed convs (`convtr*`) ->
  [Cin, Cout, 2, 2, 2], no flip (`F.conv_transpose3d` meets the
  out[2i+d] = in[i] @ w[d] contract as it is);
- backbone `<name>_scale`/`<name>_bias` -> `norms.<name>.weight/.bias`;
- Flax `Dense` kernels [in, out] -> `nn.Linear` weights [out, in];
- LayerNorm `scale` -> `weight`.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

# Flax sub-module name -> port sub-module name, inside a decoder layer
_LAYER_CHILDREN = {
    "MultiheadAttention_0": "attn", "LayerNorm_0": "norm",
    "Dense_0": "lin1", "Dense_1": "lin2",
}
_LAYER_PREFIX = {"cross": "cross", "self": "self_attn", "ffn": "ffn",
                 "squeeze": "squeeze"}


def flatten(tree, prefix=()):
    """(path, numpy leaf) pairs of a nested dict."""
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _backbone_leaf(name: str, arr: np.ndarray):
    m = re.fullmatch(r"(.+)_(kernel|scale|bias)", name)
    if m is None:
        raise KeyError(f"unmapped backbone leaf {name}")
    base, kind = m.groups()
    if kind == "scale":
        return f"backbone.norms.{base}.weight", arr
    if kind == "bias":
        return f"backbone.norms.{base}.bias", arr
    kvol, cin, cout = arr.shape
    k = round(kvol ** (1.0 / 3.0))
    if k ** 3 != kvol:
        raise ValueError(f"{name}: kernel volume {kvol} is not a cube")
    cube = arr.reshape(k, k, k, cin, cout)
    perm = (3, 4, 0, 1, 2) if base.startswith("convtr") else (4, 3, 0, 1, 2)
    return f"backbone.convs.{base}.weight", cube.transpose(perm)


def _param_leaf(path):
    """Port state_dict key and layout fn for one non-backbone leaf."""
    *mods, leaf = path
    out = []
    m = re.fullmatch(r"(cross|self|ffn|squeeze)_(\d+)_(\d+)", mods[0])
    if m:
        out = [_LAYER_PREFIX[m.group(1)], f"{m.group(2)}_{m.group(3)}"]
        for child in mods[1:]:
            if child not in _LAYER_CHILDREN and child not in (
                    "q", "k", "v", "out"):
                raise KeyError(f"unmapped leaf {'/'.join(path)}")
            out.append(_LAYER_CHILDREN.get(child, child))
    elif len(mods) == 1:
        out = [mods[0]]
    else:
        raise KeyError(f"unmapped leaf {'/'.join(path)}")
    if leaf == "kernel":
        return ".".join(out + ["weight"]), lambda a: a.T
    if leaf == "scale":
        return ".".join(out + ["weight"]), lambda a: a
    if leaf == "bias":
        return ".".join(out + ["bias"]), lambda a: a
    raise KeyError(f"unmapped leaf {'/'.join(path)}")


def map_leaf(col: str, path, arr):
    """Port state_dict key and value of one Flax leaf `path` of collection
    `col`; raises KeyError or ValueError on a leaf it cannot map."""
    if col == "buffers":
        if tuple(path) != ("gauss_B",):
            raise KeyError(f"unmapped buffer {'/'.join(path)}")
        key, val = "gauss_B", arr
    elif col != "params":
        raise KeyError(f"unexpected variable collection {col}")
    elif path[0] == "backbone":
        if len(path) != 2:
            raise KeyError(f"unmapped leaf {'/'.join(path)}")
        key, val = _backbone_leaf(path[1], arr)
    else:
        key, fn = _param_leaf(path)
        val = fn(arr)
    return key, torch.tensor(np.asarray(val, np.float32))


def from_flax(variables) -> Dict[str, torch.Tensor]:
    """Map every leaf of the Flax `params` and `buffers` trees to the
    port's state_dict names; raises on a leaf it cannot map or on an
    unknown collection."""
    sd = {}
    for col, tree in variables.items():
        if col not in ("params", "buffers"):
            raise KeyError(f"unexpected variable collection {col}")
        for path, arr in flatten(tree):
            key, val = map_leaf(col, path, arr)
            if key in sd:
                raise KeyError(f"two leaves map to {key}")
            sd[key] = val
    return sd


def load_flax(model: torch.nn.Module, variables) -> torch.nn.Module:
    """Load Flax variables into `model`; raises on any port parameter or
    buffer left unfilled and on any shape mismatch."""
    sd = from_flax(variables)
    own = model.state_dict()
    for k, v in sd.items():
        if k in own and tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(f"{k}: flax {tuple(v.shape)} vs port "
                             f"{tuple(own[k].shape)}")
    model.load_state_dict(sd, strict=True)
    return model
