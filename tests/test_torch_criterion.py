"""The eval step's losses and the checkpoint reader against the JAX
package: the LSAP against JAX's device solver, `SetCriterion` on the
same numpy arrays, and a checkpoint that JAX's `save_checkpoint` wrote
read into the port."""

import logging
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mask3d_tpu.data.batch import Targets as JTargets
from mask3d_tpu.models.mask3d import Mask3DOutput as JOutput
from mask3d_tpu.ops.lsap import linear_sum_assignment as j_lsap
from mask3d_tpu.train import checkpoint as j_ckpt
from mask3d_tpu.train.criterion import SetCriterion as JCriterion
from mask3d_tpu_torch import bridge, build_model
from mask3d_tpu_torch.config import Config, apply_overrides
from mask3d_tpu_torch.data.batch import Targets
from mask3d_tpu_torch.models.mask3d import Mask3DOutput
from mask3d_tpu_torch.ops.lsap import linear_sum_assignment
from mask3d_tpu_torch.train import checkpoint as ckpt
from mask3d_tpu_torch.train.criterion import SetCriterion
from tests.torch_parity import SMALL_OVERRIDES, assert_scaled_close, \
    flax_to_numpy
from tests.torch_parity import (  # noqa: F401 (autouse fixture)
    one_torch_thread_a_module)


def _total(cost, col4row):
    """Total cost of an assignment on the padded square problem."""
    r, c = cost.shape[-2:]
    n = max(r, c)
    sq = np.full(cost.shape[:-2] + (n, n),
                 cost.max(axis=(-2, -1), keepdims=True) + np.float32(1))
    sq[..., :r, :c] = cost
    return np.take_along_axis(sq[..., :r, :], col4row[..., None],
                              -1)[..., 0].sum(-1)


@pytest.mark.parametrize("shape", [(25, 8), (8, 8), (8, 25), (1, 5),
                                   (5, 1)])
def test_lsap_matches_jax_device_solver(shape):
    """Random costs have a unique optimum on the real columns: the same
    total as JAX's Jonker-Volgenant and the same columns for the rows
    matched to real columns (rows left over for the padding columns tie)."""
    rng = np.random.default_rng(sum(shape))
    cost = rng.normal(size=(3, 4) + shape).astype(np.float32)
    got = linear_sum_assignment(torch.from_numpy(cost)).numpy()
    ref = np.asarray(j_lsap(jnp.asarray(cost), method="device"))
    assert got.shape == ref.shape == (3, 4, shape[0])
    assert got.dtype == np.int32
    real = ref < shape[1]
    assert np.array_equal(got < shape[1], real)
    assert np.array_equal(got[real], ref[real])
    assert real.sum() == np.prod(cost.shape[:2]) * min(shape)
    np.testing.assert_allclose(_total(cost, got), _total(cost, ref),
                               rtol=1e-6)


def test_lsap_ties_give_the_same_total():
    """Where the optimum is not unique (constant columns, as padded
    instances are), the totals agree and the assignment agrees on every
    row matched to a column that is not constant."""
    rng = np.random.default_rng(0)
    cost = rng.normal(size=(6, 25, 8)).astype(np.float32)
    cost[..., 5:] = 1e4  # three invalid instance columns
    got = linear_sum_assignment(torch.from_numpy(cost)).numpy()
    ref = np.asarray(j_lsap(jnp.asarray(cost), method="device"))
    np.testing.assert_allclose(_total(cost, got), _total(cost, ref),
                               rtol=1e-6)
    real = ref < 5
    assert np.array_equal(got[real], ref[real])
    assert np.array_equal(got < 5, real)


def _criterion_inputs(seed, n_levels=13, b=3, n=200, q=10, n_inst=8,
                      n_cls=3):
    rng = np.random.default_rng(seed)
    counts = np.array([n, n - 37, 61])[:b]
    point_valid = np.arange(n)[None] < counts[:, None]
    valid = np.zeros((b, n_inst), bool)
    for i, k in enumerate([5, 2, 0][:b]):  # the last item has no instance
        valid[i, :k] = True
    labels = np.where(valid, rng.integers(0, n_cls + 1, (b, n_inst)),
                      0).astype(np.int32)
    masks = (rng.random((b, n_inst, n)) < 0.3) & valid[..., None] \
        & point_valid[:, None]
    out = dict(
        aux_pred_class=rng.normal(size=(n_levels, b, q, n_cls + 2)
                                  ).astype(np.float32),
        aux_pred_masks=(3 * rng.normal(size=(n_levels, b, n, q))
                        ).astype(np.float32))
    tgt = dict(labels=labels, masks=masks, valid=valid,
               point_instance_ids=np.zeros((b, n), np.int32))
    return out, tgt, point_valid


@pytest.mark.parametrize("kw", [
    dict(num_classes=3),
    dict(num_classes=3, eos_coef=0.3, class_weights=[0.5, 2.0, 1.5],
         ignore_mask_idx=(0, 4)),
    dict(num_classes=3, cost_class=1.0, cost_mask=3.0, cost_dice=4.0,
         ignore_mask_idx=(-1,)),
], ids=["defaults", "weights_ignore", "costs"])
def test_set_criterion_matches_jax(kw):
    """Every loss key of 13 levels, with padded instances, an item with no
    instance and padded points, within 1e-4 * max(1, |ref|)."""
    out, tgt, pv = _criterion_inputs(1)
    ref = JCriterion(**kw)(
        JOutput(**{k: jnp.asarray(v) for k, v in out.items()},
                sampled_coords=None, backbone_feats=None),
        JTargets(**{k: jnp.asarray(v) for k, v in tgt.items()}),
        jnp.asarray(pv))
    got = SetCriterion(**kw)(
        Mask3DOutput(**{k: torch.from_numpy(v) for k, v in out.items()}),
        Targets(**{k: torch.from_numpy(v) for k, v in tgt.items()}),
        torch.from_numpy(pv))
    assert sorted(ref) == sorted(got)
    assert len(got) == 3 * 13 + 1
    for k in ref:
        assert_scaled_close(np.asarray(ref[k]), got[k], 1e-4, k)


def test_set_criterion_refuses_final_masks_only():
    out, tgt, pv = _criterion_inputs(2)
    with pytest.raises(ValueError, match="aux_masks=True"):
        SetCriterion()(
            Mask3DOutput(torch.from_numpy(out["aux_pred_class"]),
                         torch.from_numpy(out["aux_pred_masks"][-1:])),
            Targets(**{k: torch.from_numpy(v) for k, v in tgt.items()}),
            torch.from_numpy(pv))


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A checkpoint written by the JAX package's `save_checkpoint` from a
    small `init_state`, and its variables."""
    from mask3d_tpu.data import VoxelizeCollate
    from mask3d_tpu.train.loop import init_state
    from tests.test_e2e import small_config
    from tests.torch_parity import scene_items

    cfg = small_config()
    example = VoxelizeCollate(point_bucket_multiple=512)(
        scene_items(n=1)).device
    state, _, _, _ = init_state(cfg, example)
    path = str(tmp_path_factory.mktemp("ckpt") / "last-epoch.ckpt")
    j_ckpt.save_checkpoint(path, state, epoch=3, metadata={"val": 0.5})
    variables = flax_to_numpy({"params": state.params,
                               "buffers": state.buffers})
    return path, variables


def _port_model():
    return build_model(apply_overrides(Config(), SMALL_OVERRIDES),
                       device="cpu", seed=123)


def test_checkpoint_reader_restores_jax_state(jax_checkpoint):
    path, variables = jax_checkpoint
    want = bridge.from_flax(variables)
    model = ckpt.load_params_tolerant(path, _port_model())
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    strict, meta = ckpt.load_checkpoint(path, _port_model())
    assert meta == {"epoch": 3, "val": 0.5}
    for k, v in strict.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_checkpoint_tolerance_rules(jax_checkpoint, tmp_path, caplog):
    """A missing key and a key of another shape keep the init, an excess
    key and a leaf the bridge cannot map are dropped; each is named in a
    warning."""
    from flax import serialization

    path, variables = jax_checkpoint
    raw = serialization.msgpack_restore(open(path, "rb").read())
    params = raw["params"]
    del params["query_proj_out"]["bias"]  # missing
    params["mask_embed_out"]["kernel"] = np.zeros((3, 3), np.float32)
    params["backbone"]["conv99_kernel"] = np.zeros((27, 4, 4), np.float32)
    params["not_a_module"] = {"a": {"b": {"kernel": np.zeros(2)}}}
    bad = tmp_path / "edited.ckpt"
    bad.write_bytes(serialization.msgpack_serialize(raw))
    init = _port_model()
    before = {k: v.clone() for k, v in init.state_dict().items()}
    with caplog.at_level(logging.WARNING):
        got = ckpt.load_params_tolerant(str(bad), init).state_dict()
    log = caplog.text
    assert "query_proj_out.bias not in checkpoint; keeping init" in log
    assert "incorrect shape mask_embed_out.weight" in log
    assert "excessive key dropped: backbone.convs.conv99.weight" in log
    assert "excessive key dropped: not_a_module/a/b/kernel" in log
    want = bridge.from_flax(variables)
    for k in got:
        if k in ("query_proj_out.bias", "mask_embed_out.weight"):
            assert torch.equal(got[k], before[k]), k
        else:
            assert torch.equal(got[k], want[k]), k


def test_backbone_checkpoint_restores_the_backbone_only(jax_checkpoint,
                                                        caplog):
    path, variables = jax_checkpoint
    want = bridge.from_flax(variables)
    init = _port_model()
    before = {k: v.clone() for k, v in init.state_dict().items()}
    got = ckpt.load_backbone_tolerant(path, init).state_dict()
    n_backbone = 0
    for k, v in got.items():
        if k.startswith("backbone."):
            n_backbone += 1
            assert torch.equal(v, want[k]), k
        else:
            assert torch.equal(v, before[k]), k
    assert n_backbone > 10


def _pack(obj) -> bytes:
    """A hand-written msgpack encoder of the forms the decoder reads."""
    if obj is None:
        return b"\xc0"
    if isinstance(obj, bool):
        return b"\xc3" if obj else b"\xc2"
    if isinstance(obj, int):
        if 0 <= obj <= 0x7F:
            return bytes([obj])
        if -32 <= obj < 0:
            return struct.pack(">b", obj)
        return b"\xd1" + struct.pack(">h", obj)  # int16
    if isinstance(obj, float):
        return b"\xcb" + struct.pack(">d", obj)
    if isinstance(obj, str):
        raw = obj.encode()
        return b"\xd9" + bytes([len(raw)]) + raw  # str8
    if isinstance(obj, bytes):
        return b"\xc4" + bytes([len(obj)]) + obj  # bin8
    if isinstance(obj, (list, tuple)):
        return bytes([0x90 | len(obj)]) + b"".join(_pack(x) for x in obj)
    if isinstance(obj, dict):
        return bytes([0x80 | len(obj)]) + b"".join(
            _pack(k) + _pack(v) for k, v in obj.items())
    if isinstance(obj, np.ndarray):
        payload = _pack([list(obj.shape), obj.dtype.name.encode(),
                         obj.tobytes()])
        return b"\xc7" + bytes([len(payload), 1]) + payload  # ext8 code 1
    raise TypeError(type(obj))


def test_msgpack_decoder_reads_flax_forms():
    """Scalars, strings, bytes, nesting, an ndarray, a numpy scalar, a
    complex and a chunked array: the port's decoder reads what flax's
    reads."""
    from flax import serialization

    chunks = {"0": np.arange(4, dtype=np.float32),
              "1": np.arange(4, 6, dtype=np.float32)}
    scalar = _pack([[], b"int64", np.int64(-7).tobytes()])
    cplx = _pack([1.5, -2.0])
    data = (
        b"\x88"
        + _pack("w") + _pack({"__msgpack_chunked_array__": True,
                              "shape": {"0": 2, "1": 3}, "chunks": chunks})
        + _pack("a") + _pack(np.arange(6, dtype=np.int16).reshape(2, 3))
        + _pack("s") + b"\xc7" + bytes([len(scalar), 3]) + scalar
        + _pack("c") + b"\xc7" + bytes([len(cplx), 2]) + cplx
        + _pack("n") + _pack([None, True, False, -3, 300, 0.25])
        + _pack("t") + _pack("text")
        + _pack("b") + _pack(b"\x00\x01")
        + _pack("e") + _pack({})
    )
    got = ckpt.msgpack_restore(data)
    ref = serialization.msgpack_restore(data)
    assert sorted(got) == sorted(ref)
    assert np.array_equal(got["w"], np.arange(6, dtype=np.float32
                                              ).reshape(2, 3))
    for k in ("w", "a"):
        assert got[k].dtype == ref[k].dtype and np.array_equal(got[k],
                                                               ref[k])
    assert got["s"] == ref["s"] == -7 and got["c"] == ref["c"]
    for k in ("n", "t", "b", "e"):
        assert got[k] == ref[k], k
    with pytest.raises(ValueError):
        ckpt.msgpack_restore(data[:-1])
