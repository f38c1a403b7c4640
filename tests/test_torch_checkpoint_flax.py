"""The checkpoint writer: a port state written by `save_flax_checkpoint`
is read by the JAX package's `load_checkpoint` against `init_state`'s
TrainState (params, buffers, Adam moments and counts, step and the meta
equal to the port's, bit for bit), and by the port's own reader back to
the same state; `msgpack_serialize` writes flax's bytes; `bridge.to_flax`
inverts `from_flax`."""

import copy

import jax
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from mask3d_tpu.config import apply_overrides as j_apply
from mask3d_tpu.data import VoxelizeCollate as JCollate
from mask3d_tpu.train.checkpoint import load_checkpoint as j_load
from mask3d_tpu.train.loop import init_state as j_init
from mask3d_tpu_torch import bridge
from mask3d_tpu_torch.config import Config, apply_overrides
from mask3d_tpu_torch.train import checkpoint as ckpt
from mask3d_tpu_torch.train.loop import init_state
from tests.test_e2e import small_config
from tests.torch_parity import BUCKET, SMALL_OVERRIDES, flax_to_numpy, \
    scene_items
from tests.torch_parity import (  # noqa: F401 (autouse fixture)
    one_torch_thread_a_module)

# the JAX optimizer chains the writer covers: adamw with a schedule (the
# defaults), and adam at a constant lr with a frozen backbone
# (`optax.multi_transform`)
CASES = {"adamw": [],
         "adam_constant_frozen": ["optimizer.name=adam",
                                  "scheduler.name=constant",
                                  "general.freeze_backbone=true"]}


def _port_state(overrides, seed):
    """A port TrainState of small_config with seeded Adam moments at step
    3 of every trained parameter, the schedule at 3, the state at step 5."""
    cfg = apply_overrides(Config(), SMALL_OVERRIDES + overrides)
    state = init_state(cfg, seed=seed, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            state.optimizer.state[p] = {
                "step": torch.tensor(3.0),
                "exp_avg": torch.randn(p.shape, generator=gen),
                "exp_avg_sq": torch.rand(p.shape, generator=gen)}
    state.scheduler.last_epoch = 3
    state.step = 5
    return state


def _moments(state):
    names = {id(p): n for n, p in state.model.named_parameters()}
    return {names[id(p)]: state.optimizer.state[p]
            for g in state.optimizer.param_groups for p in g["params"]}


@pytest.mark.parametrize("case", list(CASES))
def test_jax_reads_the_port_checkpoint(case, tmp_path):
    overrides = CASES[case]
    host = JCollate(point_bucket_multiple=BUCKET)(scene_items(n=1))
    target = j_init(j_apply(small_config(), overrides), host.device)[0]
    state = _port_state(overrides, seed=11)
    path = str(tmp_path / "last-epoch.ckpt")
    ckpt.save_flax_checkpoint(path, state, epoch=4,
                              metadata={"val_mean_ap": 0.25},
                              constant_lr=case != "adamw")

    restored, meta = j_load(path, target)
    assert meta == {"epoch": 4, "val_mean_ap": 0.25}
    assert jax.tree_util.tree_structure(restored) == \
        jax.tree_util.tree_structure(target)
    for got, want in zip(jax.tree_util.tree_leaves(restored),
                         jax.tree_util.tree_leaves(target)):
        assert np.shape(got) == np.shape(want)
        assert np.asarray(got).dtype == np.asarray(want).dtype
    assert int(restored.step) == 5
    sd = bridge.from_flax(flax_to_numpy({"params": restored.params,
                                         "buffers": restored.buffers}))
    own = state.model.state_dict()
    assert sorted(sd) == sorted(own)
    for k, v in own.items():
        assert torch.equal(sd[k], v), k

    opt = serialization.to_state_dict(restored.opt_state)
    if case == "adamw":
        chain = opt
        assert int(chain["2"]["count"]) == 3 and chain["1"] == {}
    else:
        chain = opt["inner_states"]["train"]["inner_state"]
        assert chain["1"] == {}  # a constant lr keeps no count
        assert all(v == {} for v in chain["0"]["mu"]["backbone"].values())
    assert int(chain["0"]["count"]) == 3
    moments = _moments(state)
    for key, field in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        got = bridge.from_flax({"params": flax_to_numpy(chain["0"][key])})
        assert sorted(got) == sorted(moments)
        for name, st in moments.items():
            assert torch.equal(got[name], st[field]), (key, name)

    # the port's reader takes the file back to the same state
    other = _port_state(overrides, seed=12)
    _, meta = ckpt.load_checkpoint(path, other.model, other, seed=0)
    assert meta["epoch"] == 4 and other.step == 5
    for k, v in other.model.state_dict().items():
        assert torch.equal(v, own[k]), k
    got = _moments(other)
    for name, st in moments.items():
        for field in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(got[name][field], st[field]), (name, field)
        assert int(got[name]["step"]) == 3
    assert other.scheduler.last_epoch == 3


def test_msgpack_serialize_round_trips_through_flax(monkeypatch):
    """flax's `msgpack_restore` reads the encoder's bytes back to the same
    tree, chunked leaves included (the chunk limit lowered on both sides),
    and so does the port's reader, on them and on flax's own bytes."""
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((3, 70)).astype(np.float32),
            "b": {"c": np.array(7, np.int32), "d": {},
                  "e": rng.integers(0, 9, (5,), dtype=np.uint32)},
            "long_name_" * 4: np.zeros((0, 2), np.float32),
            "f": np.arange(40000, dtype=np.int64)}
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 256)
    monkeypatch.setattr(ckpt, "MAX_CHUNK_SIZE", 256)
    data = ckpt.msgpack_serialize(tree)
    raw = msgpack.unpackb(data, raw=False)  # the chunked form, as written
    assert raw["a"]["__msgpack_chunked_array__"] is True
    assert len(raw["f"]["chunks"]) == 40000 * 8 // 256
    # flax chunks in place: hand it a copy
    flax_data = serialization.msgpack_serialize(copy.deepcopy(tree))
    for back in (serialization.msgpack_restore(data),
                 ckpt.msgpack_restore(data),
                 ckpt.msgpack_restore(flax_data)):
        flat = dict(bridge.flatten(back))
        assert sorted(flat) == sorted(dict(bridge.flatten(tree)))
        for path, want in bridge.flatten(tree):
            np.testing.assert_array_equal(flat[path], want)
            assert flat[path].dtype == want.dtype


def test_to_flax_inverts_from_flax():
    """A JAX init's variables -> from_flax -> to_flax give them back,
    leaf for leaf; a key it cannot map raises."""
    from tests.test_torch_train_large import jax_variables_like

    variables, _, _ = jax_variables_like(small_config(), seed=4)
    variables = flax_to_numpy(variables)
    back = bridge.to_flax(bridge.from_flax(variables))
    want = dict(bridge.flatten(variables))
    got = dict(bridge.flatten(back))
    assert sorted(got) == sorted(want)
    for path, arr in want.items():
        assert got[path].dtype == np.float32
        np.testing.assert_array_equal(got[path], arr)
    with pytest.raises(KeyError):
        bridge.to_flax({"backbone.convs.conv0p1s1.bias": torch.zeros(3)})
