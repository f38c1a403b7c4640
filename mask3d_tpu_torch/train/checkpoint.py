"""Checkpoints: save, the last-epoch / best-metric policy, and restore
with tolerant key matching (mask3d_tpu/train/checkpoint.py).

The port writes its own files: `torch.save` of the model's `state_dict`,
the optimizer's and the scheduler's, the step, the generator's state and
the epoch, written atomically (a temporary file, fsync, `os.replace`),
plus the JAX package's `.meta.json` sidecar. Every reader also takes the
JAX package's files, `flax.serialization.to_bytes(TrainState)`: a msgpack
map whose array leaves are msgpack ext types. The port carries its own
msgpack decoder (`msgpack_restore`), since neither flax nor msgpack is a
dependency of the port; the decoded `{"params", "buffers"}` tree goes
through `bridge` to the port's `state_dict` names. A JAX file that holds
a whole `TrainState` also resumes: optax's Adam moments and counts become
the port's optimizer and schedule state (`load_checkpoint`). The other
way, `save_flax_checkpoint` writes a port state as the JAX package's own
file (`msgpack_serialize`, the inverse of `msgpack_restore`, and
`bridge.to_flax`), which its `load_checkpoint` reads; `cli train` keeps
writing the port's format. In the tolerant readers a missing key keeps the fresh init, a key
of another shape keeps the init, an excess key (or a leaf `bridge` cannot
map) is dropped, each with a warning.
"""

from __future__ import annotations

import json
import logging
import os
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from mask3d_tpu_torch import bridge

logger = logging.getLogger(__name__)

PORT_FORMAT = "mask3d_tpu_torch/1"  # the "format" entry of the port's files
_ZIP_MAGIC = b"PK\x03\x04"  # torch.save's zip container

# flax.serialization's msgpack ext codes
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"
# from mask3d_tpu/train/checkpoint.py:39 save_checkpoint (flax's
# serialization.MAX_CHUNK_SIZE: a larger leaf is written in chunks)
MAX_CHUNK_SIZE = 2**30


class _Reader:
    """Decoder of the msgpack subset flax writes: maps, arrays, str/bin,
    ints, floats, nil/bool and ext types (big-endian, as the format is)."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        scalars = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I",
                   0xCF: "Q", 0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in scalars:
            return self.unpack(scalars[b])
        sizes = {0: "B", 1: "H", 2: "I"}
        if 0xC4 <= b <= 0xC6:  # bin 8/16/32
            return bytes(self.take(self.unpack(sizes[b - 0xC4])))
        if 0xD9 <= b <= 0xDB:  # str 8/16/32
            return str(self.take(self.unpack(sizes[b - 0xD9])), "utf-8")
        if b in (0xDC, 0xDD):
            return self.array(self.unpack("H" if b == 0xDC else "I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack("H" if b == 0xDE else "I"))
        if 0xC7 <= b <= 0xC9:  # ext 8/16/32
            n = self.unpack(sizes[b - 0xC7])
            return self.ext(self.unpack("b"), n)
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            return self.ext(self.unpack("b"), 1 << (b - 0xD4))
        raise ValueError(f"msgpack type byte 0x{b:02x} not supported")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def ext(self, code: int, n: int):
        payload = bytes(self.take(n))
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            arr = _ndarray_from_bytes(payload)
            return arr[()] if code == _EXT_NPSCALAR else arr
        if code == _EXT_COMPLEX:
            re, im = _Reader(payload).obj()
            return complex(re, im)
        raise ValueError(f"msgpack ext type {code} not supported")


def _ndarray_from_bytes(payload: bytes) -> np.ndarray:
    """flax's ndarray encoding: msgpack (shape, dtype name, C-order
    bytes). bfloat16, which numpy lacks, widens exactly to float32."""
    shape, name, buf = _Reader(payload).obj()
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)


def _unchunk(tree):
    """Leaves over 2**30 bytes are written as {"__msgpack_chunked_array__",
    "shape": {"0": ...}, "chunks": {"0": ...}}; join them back."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)]
                      for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes):
    """`flax.serialization.msgpack_restore`: bytes -> nested dicts with
    numpy array leaves."""
    reader = _Reader(data)
    tree = reader.obj()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk(tree)


class _Writer:
    """Encoder of the msgpack subset `_Reader` decodes, as flax's
    `msgpack.packb(..., default=_msgpack_ext_pack)` writes it: maps with
    str keys, lists, str, bytes, bool, None, ints, floats, and numpy arrays
    as ext type 1 (numpy scalars as ext type 3)."""

    def __init__(self):
        self.parts = []

    def put(self, fmt: str, *vals):
        self.parts.append(struct.pack(">" + fmt, *vals))

    def sized(self, n: int, fix: int, fix_max: int, codes: tuple):
        """A header of length `n`: the fixed form up to `fix_max`, else the
        8/16/32-bit forms `codes` (None where the form does not exist)."""
        if fix is not None and n <= fix_max:
            self.put("B", fix | n)
            return
        for code, fmt, top in zip(codes, ("B", "H", "I"),
                                  (0xFF, 0xFFFF, 0xFFFFFFFF)):
            if code is not None and n <= top:
                self.put("B" + fmt, code, n)
                return
        raise ValueError(f"msgpack object of length {n} too long")

    def obj(self, x):
        if x is None or isinstance(x, bool):
            self.put("B", {None: 0xC0, False: 0xC2, True: 0xC3}[x])
        elif isinstance(x, int):
            self.int(x)
        elif isinstance(x, float):
            self.put("Bd", 0xCB, x)
        elif isinstance(x, str):
            b = x.encode("utf-8")
            self.sized(len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB))
            self.parts.append(b)
        elif isinstance(x, (bytes, bytearray, memoryview)):
            self.sized(len(x), None, 0, (0xC4, 0xC5, 0xC6))
            self.parts.append(bytes(x))
        elif isinstance(x, dict):
            self.sized(len(x), 0x80, 15, (None, 0xDE, 0xDF))
            for k, v in x.items():
                self.obj(k)
                self.obj(v)
        elif isinstance(x, (list, tuple)):
            self.sized(len(x), 0x90, 15, (None, 0xDC, 0xDD))
            for v in x:
                self.obj(v)
        elif isinstance(x, np.ndarray):
            self.ext(_EXT_NDARRAY, _ndarray_to_bytes(x))
        elif isinstance(x, np.generic):
            self.ext(_EXT_NPSCALAR, _ndarray_to_bytes(np.asarray(x)))
        else:
            raise TypeError(f"msgpack cannot encode {type(x).__name__}")

    def int(self, x: int):
        if 0 <= x <= 0x7F or -32 <= x < 0:
            self.put("b" if x < 0 else "B", x)
            return
        forms = ((0xCC, "B", 0, 0xFF), (0xCD, "H", 0, 0xFFFF),
                 (0xCE, "I", 0, 0xFFFFFFFF), (0xCF, "Q", 0, 2**64 - 1),
                 (0xD0, "b", -2**7, 2**7 - 1), (0xD1, "h", -2**15, 2**15 - 1),
                 (0xD2, "i", -2**31, 2**31 - 1), (0xD3, "q", -2**63, 2**63 - 1))
        for code, fmt, lo, hi in forms:
            if lo <= x <= hi:
                self.put("B" + fmt, code, x)
                return
        raise ValueError(f"integer {x} out of msgpack's range")

    def ext(self, code: int, payload: bytes):
        n = len(payload)
        fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixed:
            self.put("Bb", fixed[n], code)
        else:
            self.sized(n, None, 0, (0xC7, 0xC8, 0xC9))
            self.put("b", code)
        self.parts.append(payload)


def _ndarray_to_bytes(arr: np.ndarray) -> bytes:
    """flax's ndarray encoding: msgpack (shape, dtype name, C-order
    bytes)."""
    w = _Writer()
    w.obj([list(arr.shape), arr.dtype.name, arr.tobytes("C")])
    return b"".join(w.parts)


def _chunk(tree):
    """Leaves over MAX_CHUNK_SIZE bytes as flax writes them: {_CHUNKED:
    True, "shape": {"0": ...}, "chunks": {"0": flat slice, ...}}."""
    if isinstance(tree, dict):
        return {k: _chunk(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.nbytes > MAX_CHUNK_SIZE:
        size = max(1, int(MAX_CHUNK_SIZE / tree.dtype.itemsize))
        flat = tree.reshape(-1)
        return {_CHUNKED: True,
                "shape": {str(i): int(d) for i, d in enumerate(tree.shape)},
                "chunks": {str(i): flat[s:s + size] for i, s in
                           enumerate(range(0, flat.size, size))}}
    return tree


# from mask3d_tpu/train/checkpoint.py:39 save_checkpoint (flax's
# serialization.msgpack_serialize)
def msgpack_serialize(tree) -> bytes:
    """Nested dicts with numpy array leaves -> the bytes
    `flax.serialization.msgpack_restore` (and `msgpack_restore` here)
    reads back."""
    w = _Writer()
    w.obj(_chunk(tree))
    return b"".join(w.parts)


def _read(path: str):
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def _is_port_file(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(4) == _ZIP_MAGIC


def _read_port(path: str, device="cpu") -> dict:
    payload = torch.load(path, map_location=device, weights_only=True)
    if payload.get("format") != PORT_FORMAT:
        raise ValueError(f"{path}: not a {PORT_FORMAT} checkpoint")
    return payload


def _write_atomic(path: str, write):
    """`write(f)` into `path` through a temporary file, fsync and
    `os.replace`: a save cut short leaves the previous file whole."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _write_meta(path: str, epoch: int, metadata: Optional[dict]):
    meta = {"epoch": epoch, **(metadata or {})}
    _write_atomic(path + ".meta.json",
                  lambda f: f.write(json.dumps(meta).encode()))


# from mask3d_tpu/train/checkpoint.py:39 save_checkpoint
def save_checkpoint(path: str, state, epoch: int = 0,
                    metadata: Optional[dict] = None):
    """Write `state` (a `train.loop.TrainState`; the baseline's has no
    scheduler and no generator) to `path` and the
    `{"epoch", **metadata}` sidecar to `path.meta.json`, each atomically:
    a save cut short leaves the previous file whole."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {
        "format": PORT_FORMAT, "epoch": epoch, "step": state.step,
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "scheduler": (state.scheduler.state_dict()
                      if state.scheduler is not None else None),
        "generator": (state.generator.get_state()
                      if state.generator is not None else None),
    }
    _write_atomic(path, lambda f: torch.save(payload, f))
    _write_meta(path, epoch, metadata)


def _adam_state(state, frozen: bool):
    """optax's ScaleByAdamState of the port's optimizer: count, and mu / nu
    as Flax trees of the params (a frozen backbone's leaves empty, as
    `optax.multi_transform` masks them)."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    mu, nu, steps = {}, {}, set()
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            st = state.optimizer.state.get(p, {})
            mu[names[id(p)]] = st.get("exp_avg", torch.zeros_like(p))
            nu[names[id(p)]] = st.get("exp_avg_sq", torch.zeros_like(p))
            steps.add(int(st["step"]) if "step" in st else 0)
    if len(steps) > 1:
        raise ValueError(f"parameters at different Adam steps {steps}; "
                         f"optax keeps one count")
    params = bridge.to_flax(state.model.state_dict())["params"]
    trees = []
    for moments in (mu, nu):
        tree = bridge.to_flax(moments)["params"]
        if frozen:
            tree["backbone"] = {k: {} for k in params["backbone"]}
        trees.append(tree)
    return {"count": np.array(steps.pop() if steps else 0, np.int32),
            "mu": trees[0], "nu": trees[1]}


# from mask3d_tpu/train/loop.py:103 make_optimizer (the state it makes)
def _optax_tree(state, constant_lr: bool):
    """The flax state dict of the optax chain `make_optimizer` builds for
    the port's optimizer: adamw {"0": adam, "1": decay, "2": schedule},
    adam {"0": adam, "1": schedule}; the schedule's count, or nothing for a
    constant lr; with a frozen backbone inside `multi_transform`'s
    {"inner_states": {"train": {"inner_state": ...}, "frozen": ...}}.
    `_optax_state` reads it back."""
    frozen = not any(p.requires_grad
                     for p in state.model.backbone.parameters())
    sched = {} if constant_lr else {
        "count": np.array(state.scheduler.last_epoch, np.int32)}
    chain = {"0": _adam_state(state, frozen)}
    if isinstance(state.optimizer, torch.optim.AdamW):
        chain.update({"1": {}, "2": sched})
    elif isinstance(state.optimizer, torch.optim.Adam):
        chain["1"] = sched
    else:
        raise ValueError(f"{type(state.optimizer).__name__}: the JAX "
                         f"package's optimizers are optax adam and adamw")
    if frozen:
        return {"inner_states": {"train": {"inner_state": chain},
                                 "frozen": {"inner_state": {}}}}
    return chain


def save_flax_checkpoint(path: str, state, epoch: int = 0,
                         metadata: Optional[dict] = None,
                         constant_lr: bool = False):
    """Write the port's Mask3D `state` (a `train.loop.TrainState`) as the
    JAX package's `save_checkpoint` does: `flax.serialization.to_bytes` of
    its `TrainState` (`step`, `params`, `buffers`, `opt_state` and `rng`)
    and the `{"epoch", **metadata}` sidecar, each atomically. The JAX
    package's `load_checkpoint` reads it against `init_state`'s state of
    the same configuration; `constant_lr` for a `scheduler.name` the JAX
    package runs at a constant lr (its chain then keeps no schedule
    count). `rng` is `jax.random.PRNGKey` of the generator's seed: the
    JAX run samples its own memories from there."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    variables = bridge.to_flax(state.model.state_dict())
    seed = state.generator.initial_seed() if state.generator is not None \
        else 0
    tree = {
        "step": np.array(state.step, np.int32),
        "params": variables["params"],
        "buffers": variables["buffers"],
        "opt_state": _optax_tree(state, constant_lr),
        "rng": np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                        np.uint32),
    }
    data = msgpack_serialize(tree)
    _write_atomic(path, lambda f: f.write(data))
    _write_meta(path, epoch, metadata)


def _port_tree(source: dict, col: str, prefix: Tuple[str, ...] = ()
               ) -> Dict[str, torch.Tensor]:
    """Map a Flax subtree to port state_dict entries; a leaf `bridge`
    cannot map is dropped as excess, with a warning."""
    out = {}
    for path, arr in bridge.flatten(source, prefix):
        try:
            key, val = bridge.map_leaf(col, path, arr)
        except (KeyError, ValueError) as e:
            logger.warning(f"excessive key dropped: {'/'.join(path)} ({e})")
            continue
        out[key] = val
    return out


# from mask3d_tpu/train/checkpoint.py:74 load_params_tolerant
def load_params_tolerant(path: str, model: torch.nn.Module):
    """Restore `model`'s parameters (and the `gauss_B` buffer, where the
    checkpoint holds one) with missing/shape-mismatch/excess tolerance,
    from a file of the port or of the JAX package (a full TrainState or a
    bare params dict)."""
    if _is_port_file(path):
        source = _read_port(path)["model"]
    else:
        raw = _read(path)
        source = _port_tree(raw.get("params", raw), "params")
        if "params" in raw and "buffers" in raw:
            # The JAX package restores params only and keeps the buffers
            # of its own fresh init, which equal the checkpoint's under the
            # same seed; the port's init differs, so it restores them.
            source.update(_port_tree(raw["buffers"], "buffers"))
    merged = load_params_tolerant_from_dict(source, model.state_dict())
    for key in source:
        if key not in merged:
            logger.warning(f"excessive key dropped: {key}")
    model.load_state_dict(merged, strict=True)
    return model


# from mask3d_tpu/train/checkpoint.py:110 load_backbone_tolerant
def load_backbone_tolerant(path: str, model: torch.nn.Module):
    """Backbone-only restore: keys under the `backbone` subtree; everything
    else keeps the fresh init."""
    target = model.state_dict()
    backbone = {k: v for k, v in target.items()
                if k.startswith("backbone.")}
    if not backbone:
        logger.warning("target has no backbone subtree; nothing restored")
        return model
    if _is_port_file(path):
        mapped = {k: v for k, v in _read_port(path)["model"].items()
                  if k.startswith("backbone.")}
    else:
        source = _read(path)
        source = source.get("params", source)
        mapped = _port_tree(source.get("backbone", source), "params",
                            ("backbone",))
    target.update(load_params_tolerant_from_dict(mapped, backbone))
    model.load_state_dict(target, strict=True)
    return model


# from mask3d_tpu/train/checkpoint.py:129 load_params_tolerant_from_dict
def load_params_tolerant_from_dict(source: Dict[str, Any],
                                   target: Dict[str, torch.Tensor]):
    """Every key of `target`, from `source` where it holds that key at the
    same shape, else the target's own value (with a warning)."""
    out = {}
    for key, cur in target.items():
        if key not in source:
            logger.warning(f"{key} not in checkpoint; keeping init")
            out[key] = cur
        elif tuple(source[key].shape) != tuple(cur.shape):
            logger.warning(f"incorrect shape {key}: "
                           f"{tuple(source[key].shape)} vs "
                           f"{tuple(cur.shape)}; keeping init")
            out[key] = cur
        else:
            out[key] = source[key].to(dtype=cur.dtype)
    return out


def _optax_state(tree, path: str):
    """(Adam's {"count", "mu", "nu"}, the schedule's count or None) of the
    flax state dict of the optax chain the JAX package builds
    (train/loop.py:103-150): `adamw` = {"0": adam, "1": decay (empty),
    "2": schedule}, `adam` = {"0": adam, "1": schedule}, a constant lr
    without the schedule's count, and with `general.freeze_backbone` the
    chain inside {"inner_states": {"train": {"inner_state": ...},
    "frozen": ...}} (the frozen moments are empty)."""
    adam, counts = [], []

    def walk(node):
        if not isinstance(node, dict):
            return
        if {"count", "mu", "nu"} <= set(node):
            adam.append(node)
        elif set(node) == {"count"}:
            counts.append(int(node["count"]))
        else:
            for key in sorted(node):
                walk(node[key])

    walk(tree)
    if len(adam) != 1 or len(counts) > 1:
        raise ValueError(f"{path}: an optimizer state of {len(adam)} Adam "
                         f"states and {len(counts)} schedule counts; the "
                         f"port resumes optax adam/adamw chains")
    return adam[0], (counts[0] if counts else None)


# from mask3d_tpu/train/loop.py:103 make_optimizer (the state it makes)
def _resume_jax_state(raw: dict, state, path: str, seed: int):
    """Put a JAX TrainState's optimizer state into the port's `state`:
    optax's Adam `mu`/`nu` (through `bridge`'s layouts) and `count` become
    each trained parameter's `exp_avg`/`exp_avg_sq`/`step` (optax's update
    is `torch.optim.AdamW`'s and `Adam`'s, train/loop.py), the schedule's
    count the LambdaLR's step and the groups' lr, and `step` the state's
    step. The JAX rng key has no torch.Generator counterpart: the sampled
    memories' generator is reseeded from `seed` and the step."""
    if "opt_state" not in raw or "step" not in raw:
        raise ValueError(f"{path}: a JAX checkpoint without an optimizer "
                         f"state (params only) cannot be resumed; load its "
                         f"weights with general.checkpoint")
    adam, sched_count = _optax_state(raw["opt_state"], path)
    count = int(adam["count"])
    mu = _port_tree(adam["mu"], "params")
    nu = _port_tree(adam["nu"], "params")
    names = {id(p): n for n, p in state.model.named_parameters()}
    opt = state.optimizer
    for group in opt.param_groups:
        for p in group["params"]:
            name = names[id(p)]
            if name not in mu or name not in nu:
                raise ValueError(f"{path}: no Adam moments for {name}")
            opt.state[p] = {
                "step": torch.tensor(float(count)),
                "exp_avg": mu[name].to(p.device, p.dtype).reshape(p.shape),
                "exp_avg_sq": nu[name].to(p.device,
                                          p.dtype).reshape(p.shape)}
    sch = state.scheduler
    sch.last_epoch = count if sched_count is None else sched_count
    for group, base, lam in zip(opt.param_groups, sch.base_lrs,
                                sch.lr_lambdas):
        group["lr"] = base * lam(sch.last_epoch)
    sch._last_lr = [group["lr"] for group in opt.param_groups]
    state.step = int(raw["step"])
    state.generator.manual_seed(seed + state.step)
    logger.info(f"{path}: resumed the JAX run's optimizer state at step "
                f"{state.step} (Adam count {count}, schedule count "
                f"{sch.last_epoch}); its rng key has no torch.Generator "
                f"counterpart, so the sampled memories' generator is "
                f"reseeded from general.seed {seed} + step {state.step}")


# from mask3d_tpu/train/checkpoint.py:62 load_checkpoint
def load_checkpoint(path: str, model: torch.nn.Module, state=None,
                    seed: int = 0):
    """Strict restore of params and buffers (every port key filled, every
    shape equal) and the `.meta.json` sidecar: returns (model, meta). With
    `state` (the `TrainState` of `model`) a file of the port also restores
    the optimizer, the schedule, the step and the generator, and a whole
    JAX TrainState its optimizer state, schedule and step
    (`_resume_jax_state`; the generator from `seed` and the step). A file
    of neither format raises."""
    if _is_port_file(path):
        payload = _read_port(path, next(model.parameters()).device)
        model.load_state_dict(payload["model"], strict=True)
        if state is not None:
            state.optimizer.load_state_dict(payload["optimizer"])
            if state.scheduler is not None:
                state.scheduler.load_state_dict(payload["scheduler"])
            state.step = int(payload["step"])
            if state.generator is not None:
                # the file was mapped to the model's device; a generator's
                # state is a CPU byte tensor whatever its device
                state.generator.set_state(payload["generator"].cpu())
    else:
        raw = _read(path)
        if not isinstance(raw, dict) or "params" not in raw:
            raise ValueError(f"{path}: neither a port checkpoint nor a JAX "
                             f"package one (no params)")
        bridge.load_flax(model, {"params": raw["params"],
                                 "buffers": raw.get("buffers", {})})
        if state is not None:
            _resume_jax_state(raw, state, path, seed)
    return model, read_meta(path)


def read_meta(path: str) -> dict:
    """The `.meta.json` sidecar of a checkpoint of either package ({} where
    there is none)."""
    meta_path = path + ".meta.json"
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f)


# from mask3d_tpu/train/checkpoint.py:146 CheckpointManager
class CheckpointManager:
    """`last-epoch.ckpt` every epoch and `best_<metric>.ckpt` whenever a
    validation metric improves (the reference's callbacks); the run
    resumes from `last-epoch.ckpt`."""

    def __init__(self, directory: str,
                 best_metrics=("val_mean_ap_50", "val_mean_ap"),
                 write: bool = True):
        """`write=False` (a rank other than 0 under data parallelism) keeps
        the best values and writes nothing; every rank reads a resume."""
        self.directory = directory
        self.best_metrics = best_metrics
        self.best_values = {m: -np.inf for m in best_metrics}
        self.write = write
        if write:
            os.makedirs(directory, exist_ok=True)

    @property
    def last_path(self) -> str:
        return os.path.join(self.directory, "last-epoch.ckpt")

    def save_last(self, state, epoch: int, metrics: Optional[dict] = None):
        if self.write:
            save_checkpoint(self.last_path, state, epoch, metrics)

    def maybe_save_best(self, state, epoch: int, metrics: dict):
        for m in self.best_metrics:
            v = metrics.get(m)
            if v is not None and np.isfinite(v) and v > self.best_values[m]:
                self.best_values[m] = float(v)
                if self.write:
                    path = os.path.join(self.directory, f"best_{m}.ckpt")
                    save_checkpoint(path, state, epoch, {m: float(v)})
                    logger.info(f"new best {m}={v:.4f} at epoch {epoch}")

    def resume_path(self) -> Optional[str]:
        return self.last_path if os.path.exists(self.last_path) else None
