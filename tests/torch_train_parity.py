"""Shared inputs and gates of the port's large-path train-step tests
(tests/test_torch_train_bricked.py, test_torch_train_bf16.py): one step
of small_config at B=1 on the first of test_torch_train_step's scenes,
JAX's `jax.value_and_grad` against the port's `make_train_step` on JAX's
weights, with the sampled memories' uniforms and the matching shared.

The bf16 gate, per gradient leaf whose fp32 gradient is above the floor
of `test_torch_train_step.grad_errors` (the attention's K biases have a
true gradient of 0 and both sides return noise there): the mean and the
99.9% quantile of |port bf16 - JAX bf16| within BF16_NOISE times those of
JAX's own |JAX bf16 - JAX fp32|. Two independent draws of one rounding
noise differ by sqrt(2) times that noise on average, so the gate says
that the port's bf16 noise is no larger than JAX's own; on small_config
several backbone leaves' bf16 gradients are mostly noise (JAX's own
relative error 0.5-1.6 on bricked's level-0 norms)."""

import pytest
import torch

from mask3d_tpu.config import apply_overrides as j_apply
from mask3d_tpu.data import VoxelizeCollate as JCollate
from mask3d_tpu.data import make_synthetic_scene as j_make
from mask3d_tpu_torch import bridge, collate
from mask3d_tpu_torch.config import Config, apply_overrides
from mask3d_tpu_torch.data.synthetic import make_synthetic_scene
from mask3d_tpu_torch.train.criterion import make_criterion
from mask3d_tpu_torch.train.loop import init_state, make_train_step
from tests.test_e2e import small_config
from tests.test_torch_train_step import OVERRIDES, Uniforms, host_lsap, \
    jax_step, train_scenes
from tests.torch_parity import BUCKET, SMALL_OVERRIDES, flax_to_numpy

# the first train scene's level-0 grid is 40x24x8 (15 bricks of 8^3)
BRICKED = ["model.backbone_impl=bricked", "model.brick_dims=[8,8,8]",
           "model.brick_capacity=32"]
IMPLS = {"bricked": BRICKED, "gather": ["model.backbone_impl=gather"],
         "gather_pallas": ["model.backbone_impl=gather_pallas"]}
BF16 = ["model.compute_dtype=bfloat16"]
BF16_NOISE = 2.0 ** 0.5
FLOOR = 1e-4  # of the largest fp32 leaf norm (grad_errors' floor)


def one_scene(make):
    return train_scenes(make)[:1]


class Matching:
    """The assignments scipy returned to JAX's host LSAP, in call order,
    handed back to the port's: near-ties of an untrained model's costs
    fall on either side of a bf16 rounding, and one flipped pair changes
    the loss and every gradient, so the bf16 comparisons hold the matching
    fixed (in fp32 both sides find the same one)."""

    def __init__(self):
        self.calls = []
        self.i = 0

    def recording(self):
        import scipy.optimize

        real = scipy.optimize.linear_sum_assignment

        def lsa(x):
            out = real(x)
            self.calls.append((x.shape, out))
            return out
        return lsa

    def replaying(self, x):
        shape, out = self.calls[self.i]
        assert shape == x.shape, (shape, x.shape)
        self.i += 1
        return out


def jax_runs(names):
    """{name: (state, loss, losses, grads, uniforms, matching)} of JAX's
    B=1 value_and_grad for each (name, overrides), the sampled memories
    drawn from one set of numpy uniforms (seed 7), the host LSAP's
    assignments recorded."""
    import scipy.optimize

    host = JCollate(point_bucket_multiple=BUCKET)(one_scene(j_make))
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        host_lsap(mp)
        for name, ov in names:
            cfg = j_apply(small_config(), OVERRIDES + ov)
            uniforms, matching = Uniforms(7), Matching()
            mp.setattr(scipy.optimize, "linear_sum_assignment",
                       matching.recording())
            runs[name] = jax_step(cfg, host, uniforms) + (uniforms,
                                                         matching)
    return runs


def variables_of(run):
    state = run[0]
    return flax_to_numpy({"params": state.params, "buffers": state.buffers})


def port_grads(overrides, variables, uniforms=None, matching=None):
    """(state, losses) of the port's `make_train_step` on the first train
    scene (B=1) on JAX's weights, the gradients in `.grad`; `uniforms` and
    `matching` replay JAX's draws and assignments."""
    cfg = apply_overrides(Config(), SMALL_OVERRIDES + overrides)
    state = init_state(cfg, device="cpu")
    bridge.load_flax(state.model, variables)
    host = collate(one_scene(make_synthetic_scene), device="cpu",
                   point_bucket_multiple=BUCKET)
    step = make_train_step(cfg, make_criterion(cfg), device="cpu")
    with torch.backends.mkldnn.flags(enabled=False), \
            pytest.MonkeyPatch.context() as mp:
        if uniforms is not None:
            uniforms.i = 0
            mp.setattr(torch, "rand", uniforms.torch)
        if matching is not None:
            from mask3d_tpu_torch.ops import lsap

            matching.i = 0
            mp.setattr(lsap, "_scipy_lsa", matching.replaying)
        losses, _ = step(state, host.device)
    if uniforms is not None:
        assert uniforms.i == len(uniforms.drawn)
    if matching is not None:
        assert matching.i == len(matching.calls)
    return state, losses


def bf16_gap_ratios(got, jax16, jax32):
    """{leaf: (mean ratio, 99.9% quantile ratio)} of |got - jax16| against
    BF16_NOISE * |jax16 - jax32|, over the leaves of `jax32` (port
    state_dict names, float tensors) above FLOOR of its largest norm; a
    gate passes at <= 1."""
    floor = FLOOR * max(float(v.norm()) for v in jax32.values())
    out = {}
    for name, ref in jax32.items():
        if float(ref.norm()) <= floor:
            continue
        ours = (got[name].double() - jax16[name].double()).abs().flatten()
        gap = (jax16[name].double() - ref.double()).abs().flatten()
        out[name] = tuple(
            float(fn(ours)) / max(BF16_NOISE * float(fn(gap)), 1e-30)
            for fn in (torch.mean, lambda d: torch.quantile(d, 0.999)))
    return out


def assert_bf16_gap(ratios, what):
    """Every ratio <= 1; prints the worst three and the share of leaves
    where the port's difference exceeds JAX's gap itself."""
    worst = sorted(ratios.items(), key=lambda kv: -max(kv[1]))[:3]
    over = sum(max(r) * BF16_NOISE > 1.0 for r in ratios.values())
    print(f"{what}: worst (mean, q999) / ({BF16_NOISE:.3f} x JAX's gap) "
          f"{worst}; {over} of {len(ratios)} leaves above the gap itself")
    assert max(max(r) for r in ratios.values()) <= 1.0, worst


def grads_of(state):
    return {k: p.grad for k, p in state.model.named_parameters()}


def jax_grads(run):
    return bridge.from_flax({"params": flax_to_numpy(run[3])})

