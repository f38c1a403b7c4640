"""One train step of the port against the JAX package on `small_config`:
the same Flax init bridged into the port, the same numpy batch, the loss
and every gradient leaf of `jax.value_and_grad` of JAX's own
`model.apply` + `SetCriterion` (its Pallas attention in interpret mode)
against the port's `make_train_step`, with the whole padded levels as
memories (`max_sample_size`) and with sampled memories drawn from the same
numpy uniforms on both sides.

Two settings make the comparison one of the model and not of its inputs'
conditioning:
- both sides solve the assignment with scipy (`matcher.lsap_method=host`
  in both packages, JAX's parity oracle): at init many queries tie, and
  which of two tied queries wins rests on the last bits of the costs,
  which the two frameworks round differently, so even the same solver on
  both sides could match them otherwise, which leaves the loss (measured
  1.7e-6 apart) but not the gradients alone; scipy on the host is what
  these tests were measured with;
- the port's CPU convolutions run PyTorch's own kernels
  (`torch.backends.mkldnn.flags(enabled=False)`): oneDNN's float32 conv
  backward put gradient leaves up to 6% from a float64 run of the port at
  init, PyTorch's own 1.2e-3 (measured)."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mask3d_tpu.train.criterion as j_criterion_mod
from mask3d_tpu.config import apply_overrides as j_apply
from mask3d_tpu.data import VoxelizeCollate as JCollate
from mask3d_tpu.data import make_synthetic_scene as j_make
from mask3d_tpu.ops.lsap import linear_sum_assignment as j_lsap
from mask3d_tpu.sparse import build_sparse_batch as j_build
from mask3d_tpu.train.loop import _sb_kwargs, init_state as j_init, \
    level_capacities as j_caps
from mask3d_tpu_torch import bridge, collate
from mask3d_tpu_torch.config import Config, apply_overrides
from mask3d_tpu_torch.data.synthetic import make_synthetic_scene
from mask3d_tpu_torch.train.criterion import make_criterion
from mask3d_tpu_torch.train.loop import init_state, make_train_step
from tests.test_e2e import small_config
from tests.torch_parity import BUCKET, SMALL_OVERRIDES, flax_to_numpy
from tests.torch_parity import (  # noqa: F401 (autouse fixture)
    one_torch_thread_a_module)

OVERRIDES = ["model.attention_pallas_tile=16",
             "trainer.train_split_metrics=false",
             "matcher.lsap_method=host"]
LOSS_RTOL = 1e-4
# ||g_port - g_jax|| / ||g_jax|| per leaf (leaves whose true gradient is 0,
# the K biases of the attention, against 1e-4 of the largest leaf norm):
# measured 2.2e-5 at most on small_config
GRAD_TOL = 1e-4


def train_scenes(make):
    """Two scenes of 3x2 rooms of 12 (one numpy generator each), on which
    small_config's gradients are well conditioned at init."""
    return [make(np.random.default_rng(3 + i), num_rooms_x=3, num_rooms_y=2,
                 room_size=12, height=6, jitter=0.0, dropout=0.5)
            for i in range(2)]


def host_lsap(monkeypatch):
    """JAX's criterion matched by scipy (its `host` method, which
    OVERRIDES also sets for the port; the costs are constants of the
    assignment, as the criterion treats them)."""
    monkeypatch.setattr(
        j_criterion_mod, "linear_sum_assignment",
        lambda cost, method="device": j_lsap(jax.lax.stop_gradient(cost),
                                             method="host"))


class Uniforms:
    """The sampled memories' uniforms, from numpy, handed out in call
    order to JAX's `jax.random.uniform` and to the port's `torch.rand`."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.drawn = []
        self.i = 0

    def jax(self, key, shape, *a, **k):
        self.drawn.append(self.rng.random(shape).astype(np.float32))
        return jnp.asarray(self.drawn[-1])

    def torch(self, size, *a, generator=None, device=None, **k):
        self.i += 1
        return torch.from_numpy(self.drawn[self.i - 1]).to(device)


def jax_step(cfg, host, uniforms=None):
    """(state, loss, losses, grads) of one `jax.value_and_grad` on the
    batch, in train mode (is_eval False)."""
    dev = host.device
    state, model, criterion, _ = j_init(cfg, dev)
    caps = j_caps(cfg, dev.coords.shape[1])

    def loss_fn(params):
        sb = j_build(dev.coords, dev.counts, dev.dims, caps,
                     **_sb_kwargs(cfg, dev.grid_dims))
        out = model.apply(
            {"params": params, "buffers": state.buffers}, sb, dev.feats,
            dev.coords.astype(jnp.float32), False, grid_dims=dev.grid_dims,
            rngs={"sample": jax.random.PRNGKey(0),
                  "queries": jax.random.PRNGKey(0)})
        losses = criterion(
            out, dev.target.with_label_offset(
                cfg.data.prediction_label_offset), sb.levels[0].valid)
        return losses["loss"], losses

    patch = (contextlib.nullcontext() if uniforms is None else
             pytest.MonkeyPatch.context())
    with patch as mp:
        if uniforms is not None:
            mp.setattr(jax.random, "uniform", uniforms.jax)
        (loss, losses), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(state.params)
    return state, float(loss), losses, grads


def port_step(overrides, variables, uniforms=None, extra=()):
    """(state, losses) after the port's `make_train_step` on the same
    batch; the gradients stay in `.grad`."""
    cfg = apply_overrides(Config(), SMALL_OVERRIDES + overrides + list(extra))
    state = init_state(cfg, device="cpu")
    bridge.load_flax(state.model, variables)
    host = collate(train_scenes(make_synthetic_scene), device="cpu",
                   point_bucket_multiple=BUCKET)
    step = make_train_step(cfg, make_criterion(cfg), device="cpu")
    with torch.backends.mkldnn.flags(enabled=False), \
            pytest.MonkeyPatch.context() as mp:
        if uniforms is not None:
            mp.setattr(torch, "rand", uniforms.torch)
        losses, _ = step(state, host.device)
    return state, losses


def grad_errors(state, jax_grads):
    """Per port parameter: ||g_port - g_jax|| / max(||g_jax||, 1e-4 of the
    largest leaf norm)."""
    ref = bridge.from_flax({"params": flax_to_numpy(jax_grads)})
    floor = 1e-4 * max(float(v.norm()) for v in ref.values())
    out = {}
    for k, p in state.model.named_parameters():
        r = ref[k].double()
        out[k] = float((p.grad.double() - r).norm()) / max(float(r.norm()),
                                                           floor)
    return out


@pytest.mark.parametrize("sampled", [False, True],
                         ids=["max_sample_size", "sampled"])
def test_train_step_matches_jax_grad(sampled, monkeypatch):
    """The loss within 1e-4 (relative), every loss entry within 1e-4 of
    max(1, |ref|), and every gradient leaf within GRAD_TOL; sampled:
    small_config's sample sizes [32, 64, 128, 256] on levels of 1024 ...
    128 rows, the same uniforms on both sides."""
    host_lsap(monkeypatch)
    overrides = OVERRIDES + ([] if sampled else ["model.max_sample_size=true"])
    cfg = j_apply(small_config(), overrides)
    host = JCollate(point_bucket_multiple=BUCKET)(train_scenes(j_make))
    uniforms = Uniforms(7) if sampled else None
    state, loss, losses, grads = jax_step(cfg, host, uniforms)
    if sampled:  # one draw per (decoder round, level), each [B, cap]
        assert len(uniforms.drawn) == cfg.model.num_decoders * 4
    variables = flax_to_numpy({"params": state.params,
                               "buffers": state.buffers})
    p_state, p_losses = port_step(overrides, variables, uniforms)
    if sampled:
        assert uniforms.i == len(uniforms.drawn)
    assert abs(float(p_losses["loss"]) - loss) <= LOSS_RTOL * abs(loss)
    for k, v in losses.items():
        ref = float(v)
        assert abs(float(p_losses[k]) - ref) <= 1e-4 * max(1.0, abs(ref)), k
    assert int(p_losses["batch_overflow"]) == 0
    errs = grad_errors(p_state, grads)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])


# small_config's levels 4 ... 1 hold 128, 256, 512 and 1024 rows: hlevels 0
# and 1 sample 32 and 64 of theirs, hlevel 2 takes its whole level, hlevel 3
# samples 256 (Config()'s sample sizes mix so on batches of about 3,200 to
# 25,600 points)
MIXED_SAMPLE_SIZES = "model.sample_sizes=[32,64,512,256,512]"


def test_train_step_mixes_sampled_and_full_levels(monkeypatch):
    """A round whose levels are sampled, then whole, then sampled again:
    the loss and losses as test_train_step_matches_jax_grad holds them and
    every gradient leaf within GRAD_TOL, the same uniforms on both sides
    (one draw per sampled level and round)."""
    host_lsap(monkeypatch)
    overrides = OVERRIDES + [MIXED_SAMPLE_SIZES]
    cfg = j_apply(small_config(), overrides)
    host = JCollate(point_bucket_multiple=BUCKET)(train_scenes(j_make))
    uniforms = Uniforms(11)
    state, loss, losses, grads = jax_step(cfg, host, uniforms)
    assert len(uniforms.drawn) == cfg.model.num_decoders * 3
    variables = flax_to_numpy({"params": state.params,
                               "buffers": state.buffers})
    p_state, p_losses = port_step(overrides, variables, uniforms)
    assert uniforms.i == len(uniforms.drawn)
    assert abs(float(p_losses["loss"]) - loss) <= LOSS_RTOL * abs(loss)
    for k, v in losses.items():
        ref = float(v)
        assert abs(float(p_losses[k]) - ref) <= 1e-4 * max(1.0, abs(ref)), k
    errs = grad_errors(p_state, grads)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])
