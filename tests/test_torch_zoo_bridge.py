"""The bridge on the bottleneck backbones' full parameter trees:
Res16UNet101's whole Mask3D tree (with learned queries, the level
embedding and a set of decoder layers a round), got from `jax.eval_shape`
(traced, never compiled), through `bridge.from_flax` into the port's model
and back through `to_flax`, leaf for leaf and shape for shape; and a
Res16UNet50 port state written by `save_flax_checkpoint` and read by the
JAX package's `load_checkpoint` against its `init_state`'s TrainState."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import serialization

from mask3d_tpu.config import apply_overrides as j_apply
from mask3d_tpu.data import VoxelizeCollate as JCollate
from mask3d_tpu.models.mask3d import Mask3D as JMask3D
from mask3d_tpu.train.checkpoint import load_checkpoint as j_load
from mask3d_tpu.train.loop import init_state as j_init
from mask3d_tpu_torch import bridge
from mask3d_tpu_torch.models.mask3d import Mask3D as TMask3D
from mask3d_tpu_torch.train import checkpoint as ckpt
from tests.test_e2e import small_config
from tests.test_torch_bottleneck import j_batch, scene
from tests.test_torch_checkpoint_flax import _moments, _port_state
from tests.torch_parity import BUCKET, flax_to_numpy, scene_items
from tests.torch_parity import (  # noqa: F401 (autouse fixture)
    one_torch_thread_a_module)

R101 = dict(backbone_name="Res16UNet101", non_parametric_queries=False,
            use_level_embed=True, shared_decoder=False, pre_norm=True)


def test_res16unet101_full_tree_round_trips():
    coords, counts, dims, grid = scene()
    model = JMask3D(**R101, backbone_impl="dense")
    shapes = jax.eval_shape(
        lambda c, n, d: model.init(
            {"params": jax.random.PRNGKey(0)}, j_batch(c, n, d, grid, "dense"),
            jnp.ones(c.shape[:2] + (1,)), c.astype(jnp.float32), True,
            grid_dims=grid),
        coords, counts, dims)
    rng = np.random.default_rng(0)  # uniform draws: distinct leaves, fast
    variables = jax.tree_util.tree_map(
        lambda x: rng.random(x.shape, dtype=np.float32), shapes)
    port = TMask3D(**R101)
    bridge.load_flax(port, variables)  # strict: every port leaf filled
    back = bridge.to_flax(port.state_dict())
    want, got = dict(bridge.flatten(variables)), dict(bridge.flatten(back))
    assert sorted(got) == sorted(want)
    for path, arr in want.items():
        assert got[path].shape == arr.shape, path
        np.testing.assert_array_equal(got[path], arr, err_msg=str(path))
    params = variables["params"]
    assert params["query_feat"].shape == params["query_pos"].shape == (
        25, 128)
    assert params["level_embed"].shape == (4, 128)
    assert "cross_2_3" in params and "squeeze_1_0" in params
    assert params["backbone"]["block4_22_conv3_kernel"].shape == (
        1, 256, 1024)
    assert params["mask_features_head"]["kernel"].shape == (1024, 128)


def test_jax_reads_a_res16unet50_port_checkpoint(tmp_path):
    """Params, buffers and the Adam moments equal to the port's, bit for
    bit; the tree and every shape equal to JAX's TrainState of the same
    configuration."""
    overrides = ["model.backbone=Res16UNet50"]
    host = JCollate(point_bucket_multiple=BUCKET)(scene_items(n=1))
    target = jax.eval_shape(lambda: j_init(
        j_apply(small_config(), overrides), host.device)[0])
    state = _port_state(overrides, seed=11)
    path = str(tmp_path / "last-epoch.ckpt")
    ckpt.save_flax_checkpoint(path, state, epoch=4)
    restored, meta = j_load(path, target)
    assert meta == {"epoch": 4}
    assert jax.tree_util.tree_structure(restored) == \
        jax.tree_util.tree_structure(target)
    for got, want in zip(jax.tree_util.tree_leaves(restored),
                         jax.tree_util.tree_leaves(target)):
        assert np.shape(got) == tuple(want.shape)
    sd = bridge.from_flax(flax_to_numpy({"params": restored.params,
                                         "buffers": restored.buffers}))
    own = state.model.state_dict()
    assert sorted(sd) == sorted(own)
    for name, value in own.items():
        assert torch.equal(sd[name], value), name
    chain = serialization.to_state_dict(restored.opt_state)["0"]
    for key, field in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        got = bridge.from_flax({"params": flax_to_numpy(chain[key])})
        for name, moments in _moments(state).items():
            assert torch.equal(got[name], moments[field]), (key, name)
