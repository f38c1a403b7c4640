"""Carry trained weights across: the JAX package's Flax variables
`{"params": ..., "buffers": ...}` (nested dicts of numpy arrays) -> the
port's `state_dict` (`from_flax`), and back (`to_flax`).

Layout conversions:
- backbone `<name>_kernel` [K, Cin, Cout] (C-order ravel of the kernel
  cube) -> [Cout, Cin, k, k, k]; transposed convs (`convtr*`) ->
  [Cin, Cout, 2, 2, 2], no flip (`F.conv_transpose3d` meets the
  out[2i+d] = in[i] @ w[d] contract as it is);
- backbone `<name>_scale`/`<name>_bias` -> `norms.<name>.weight/.bias`;
- a squeeze-excitation gate's `<block>_se_fc{1,2}_kernel` [in, out] and
  `_bias` -> `se.<block>.fc{1,2}.weight` [out, in] and `.bias`;
- the ResUNet head's `final_conv2_bias` -> `convs.final_conv2.bias`;
- Flax `Dense` kernels [in, out] -> `nn.Linear` weights [out, in];
- LayerNorm `scale` -> `weight`;
- the decoder's raw parameters `query_feat`, `query_pos` and `level_embed`
  keep their names and layouts.

`backbone_from_flax` / `backbone_to_flax` do the same for a standalone
backbone's parameters (a ResUNet's, say), without the `backbone.` prefix.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch

# Flax sub-module name -> port sub-module name, inside a decoder layer
_LAYER_CHILDREN = {
    "MultiheadAttention_0": "attn", "LayerNorm_0": "norm",
    "Dense_0": "lin1", "Dense_1": "lin2",
}
_LAYER_PREFIX = {"cross": "cross", "self": "self_attn", "ffn": "ffn",
                 "squeeze": "squeeze"}
# the decoder's parameters that are no module's: learned queries and the
# level embedding
_RAW_PARAMS = ("query_feat", "query_pos", "level_embed")


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
    se = re.fullmatch(r"(.+)_se_(fc[12])", base)
    if se:
        key = f"backbone.se.{se.group(1)}.{se.group(2)}"
        if kind == "kernel" and arr.ndim == 2:
            return f"{key}.weight", arr.T
        if kind == "bias" and arr.ndim == 1:
            return f"{key}.bias", arr
        raise KeyError(f"unmapped backbone leaf {name} {arr.shape}")
    if kind == "bias" and base.startswith("final_conv"):
        return f"backbone.convs.{base}.bias", arr
    if kind == "scale":
        return f"backbone.norms.{base}.weight", arr
    if kind == "bias":
        return f"backbone.norms.{base}.bias", arr
    if arr.ndim != 3:
        raise KeyError(f"unmapped backbone leaf {name} {arr.shape}")
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
    if not mods and leaf in _RAW_PARAMS:
        return leaf, lambda a: a
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


_PORT_CHILDREN = {v: k for k, v in _LAYER_CHILDREN.items()}
_PORT_PREFIX = {v: k for k, v in _LAYER_PREFIX.items()}


def _flax_leaf(key: str, arr: np.ndarray) -> Tuple[str, tuple, np.ndarray]:
    """(collection, Flax path, Flax value) of one port state_dict entry:
    the layouts of `map_leaf` undone."""
    if key == "gauss_B":
        return "buffers", ("gauss_B",), arr
    parts = key.split(".")
    if key in _RAW_PARAMS:
        return "params", (key,), arr
    if parts[0] == "backbone":
        if len(parts) == 5 and parts[1] == "se" and parts[3] in ("fc1",
                                                                 "fc2"):
            leaf = {"weight": "kernel", "bias": "bias"}.get(parts[4])
            if leaf is None:
                raise KeyError(f"unmapped port key {key}")
            return "params", ("backbone", f"{parts[2]}_se_{parts[3]}_"
                              f"{leaf}"), arr.T if leaf == "kernel" else arr
        if len(parts) != 4 or parts[1] not in ("convs", "norms"):
            raise KeyError(f"unmapped port key {key}")
        name, kind = parts[2], parts[3]
        if parts[1] == "convs" and kind == "bias" and \
                name.startswith("final_conv"):
            return "params", ("backbone", f"{name}_bias"), arr
        if parts[1] == "norms":
            leaf = {"weight": "scale", "bias": "bias"}.get(kind)
            if leaf is None:
                raise KeyError(f"unmapped port key {key}")
            return "params", ("backbone", f"{name}_{leaf}"), arr
        if kind != "weight" or arr.ndim != 5:
            raise KeyError(f"unmapped port key {key}")
        perm = (2, 3, 4, 0, 1) if name.startswith("convtr") \
            else (2, 3, 4, 1, 0)
        cube = arr.transpose(perm)  # [k, k, k, Cin, Cout]
        k = cube.shape[0]
        return "params", ("backbone", f"{name}_kernel"), \
            cube.reshape(k ** 3, *cube.shape[3:])
    *mods, leaf = parts
    if len(mods) >= 2 and mods[0] in _PORT_PREFIX \
            and re.fullmatch(r"\d+_\d+", mods[1]):
        path = [f"{_PORT_PREFIX[mods[0]]}_{mods[1]}"] + [
            _PORT_CHILDREN.get(m, m) for m in mods[2:]]
    elif len(mods) == 1:
        path = list(mods)
    else:
        raise KeyError(f"unmapped port key {key}")
    if leaf == "weight":
        if arr.ndim == 2:
            return "params", (*path, "kernel"), arr.T
        return "params", (*path, "scale"), arr
    if leaf == "bias":
        return "params", (*path, "bias"), arr
    raise KeyError(f"unmapped port key {key}")


def to_flax(state_dict) -> Dict[str, dict]:
    """The exact inverse of `from_flax`: a port state_dict -> the Flax
    variables `{"params": ..., "buffers": ...}` as nested dicts of float32
    numpy arrays. Strict: a key it cannot map raises KeyError, and each
    leaf must map back through `map_leaf` to its own key, shape and value
    (ValueError otherwise)."""
    out: Dict[str, dict] = {"params": {}, "buffers": {}}
    for key, val in state_dict.items():
        arr = np.asarray(val.detach().cpu().numpy() if torch.is_tensor(val)
                         else val, np.float32)
        col, path, flax_val = _flax_leaf(key, arr)
        flax_val = np.ascontiguousarray(flax_val)
        back_key, back = map_leaf(col, path, flax_val)
        if back_key != key or tuple(back.shape) != arr.shape or \
                not np.array_equal(back.numpy(), arr):
            raise ValueError(f"{key} -> {col}/{'/'.join(path)} "
                             f"{flax_val.shape} maps back to {back_key} "
                             f"{tuple(back.shape)}")
        node = out[col]
        for name in path[:-1]:
            node = node.setdefault(name, {})
        if path[-1] in node:
            raise KeyError(f"two port keys map to {col}/{'/'.join(path)}")
        node[path[-1]] = flax_val
    return out


def backbone_from_flax(params) -> Dict[str, torch.Tensor]:
    """A standalone backbone's Flax `params` (a Res16UNet's or a
    ResUNet's, leaves at the top) -> its state_dict."""
    sd = from_flax({"params": {"backbone": params}})
    return {k[len("backbone."):]: v for k, v in sd.items()}


def backbone_to_flax(state_dict) -> Dict[str, np.ndarray]:
    """The inverse of `backbone_from_flax`."""
    return to_flax({f"backbone.{k}": v for k, v in state_dict.items()}
                   )["params"]["backbone"]
