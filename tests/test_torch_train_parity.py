"""The train step against the JAX package beyond one small step:
`parity_config` (Res16UNet18A, two blocks a stage) one step's loss and
gradients, and three optimizer steps of small_config against JAX's
`make_train_step`, on the inputs and settings of test_torch_train_step."""

import numpy as np
import torch

from mask3d_tpu.config import apply_overrides as j_apply
from mask3d_tpu.data import VoxelizeCollate as JCollate
from mask3d_tpu.data import make_synthetic_scene as j_make
from mask3d_tpu.train.loop import init_state as j_init, make_train_step as \
    j_make_train_step
from mask3d_tpu_torch import bridge, collate
from mask3d_tpu_torch.config import Config, apply_overrides
from mask3d_tpu_torch.data.synthetic import make_synthetic_scene
from mask3d_tpu_torch.train.criterion import make_criterion
from mask3d_tpu_torch.train.loop import init_state, make_train_step
from tests.test_e2e import parity_config, small_config
from tests.test_torch_train_step import LOSS_RTOL, OVERRIDES, grad_errors, \
    host_lsap, jax_step, port_step, train_scenes
from tests.torch_parity import BUCKET, SMALL_OVERRIDES, flax_to_numpy
from tests.torch_parity import (  # noqa: F401 (autouse fixture)
    one_torch_thread_a_module)

# parity_config's stride-1 decoder stage (convtr7, stage 8, two blocks)
# holds InstanceNorms whose gradients amplify float32 rounding at init:
# measured 2.1e-3 at most there, 1.8e-5 on every decoder leaf
PARITY_GRAD_TOL = 1e-2
# three AdamW steps: Adam's first updates are +-lr on leaves whose gradient
# is rounding noise, which moves later losses slightly
STEPS_RTOL = 1e-4
# the flagship's AdamW lr and a decay that shows within three steps
STEPS_OVERRIDES = ["optimizer.lr=0.0001", "scheduler.gamma=0.9"]


def test_parity_config_step_matches_jax_grad(monkeypatch):
    host_lsap(monkeypatch)
    overrides = OVERRIDES + ["model.max_sample_size=true",
                             "model.backbone=Res16UNet18A"]
    cfg = j_apply(parity_config(), overrides)
    host = JCollate(point_bucket_multiple=BUCKET)(train_scenes(j_make))
    state, loss, losses, grads = jax_step(cfg, host)
    variables = flax_to_numpy({"params": state.params,
                               "buffers": state.buffers})
    p_state, p_losses = port_step(overrides, variables)
    assert abs(float(p_losses["loss"]) - loss) <= LOSS_RTOL * abs(loss)
    errs = grad_errors(p_state, grads)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= PARITY_GRAD_TOL, (worst, errs[worst])
    decoder = max(v for k, v in errs.items() if not k.startswith("backbone"))
    assert decoder <= 1e-4, decoder


def test_three_steps_match_make_train_step(monkeypatch):
    """The losses of three AdamW steps (small_config at the flagship's lr
    1e-4 with gamma 0.9, whole levels as memories) against the JAX
    package's jitted `make_train_step` on the same batch."""
    host_lsap(monkeypatch)
    overrides = OVERRIDES + STEPS_OVERRIDES + ["model.max_sample_size=true"]
    cfg = j_apply(small_config(), overrides)
    host = JCollate(point_bucket_multiple=BUCKET)(train_scenes(j_make))
    state, model, criterion, tx = j_init(cfg, host.device)
    variables = flax_to_numpy({"params": state.params,
                               "buffers": state.buffers})
    step = j_make_train_step(cfg, model, criterion, tx)
    ref = []
    for _ in range(3):
        state, losses, _ = step(state, host.device)
        ref.append(float(losses["loss"]))

    p_cfg = apply_overrides(Config(), SMALL_OVERRIDES + overrides)
    p_state = init_state(p_cfg, device="cpu")
    bridge.load_flax(p_state.model, variables)
    p_host = collate(train_scenes(make_synthetic_scene), device="cpu",
                     point_bucket_multiple=BUCKET)
    p_step = make_train_step(p_cfg, make_criterion(p_cfg), device="cpu")
    got = []
    with torch.backends.mkldnn.flags(enabled=False):
        for _ in range(3):
            got.append(float(p_step(p_state, p_host.device)[0]["loss"]))
    assert p_state.step == 3
    np.testing.assert_allclose(got, ref, rtol=STEPS_RTOL)
    assert ref[2] < ref[0]  # the steps train
