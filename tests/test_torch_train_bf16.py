"""bf16 training on the gather impls against the JAX package
(tests/torch_train_parity.py): one `gather_pallas` train step of
small_config at B=1 (JAX's Pallas conv in interpret mode, its backward
JAX's per-offset formula) with each gradient leaf within JAX's own bf16
gap; and the bf16 `gather` backbone's parameter gradients for one
cotangent on its five feature maps against `jax.vjp` of JAX's, within
JAX's bf16 gap.

`gather` is held at the backbone: JAX's XLA sums the bf16 gather-conv
products in another order than the port (one output in 1e4 a bf16
rounding apart, tests/test_torch_large_scene.py), its maps drift a
quarter of JAX's own bf16 gap apart by the stride-1 map, and the
decoder's attention-mask thresholds turn those drifts into other masks:
the whole step's loss then differs by 1.1% with the matching held fixed
(measured), where `bricked` and `gather_pallas`, whose maps agree with
JAX's nearly bitwise, agree to 4e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mask3d_tpu_torch import bridge
from tests.test_torch_train_step import OVERRIDES, host_lsap
from tests.torch_parity import BUCKET, flax_to_numpy
from tests.torch_threads import one_torch_thread_a_module  # noqa: F401
from tests.torch_train_parity import BF16, IMPLS, assert_bf16_gap, \
    bf16_gap_ratios, grads_of, jax_grads, jax_runs, one_scene, \
    port_grads, variables_of


@pytest.fixture(scope="module")
def runs():
    return jax_runs([("fp32 gather", IMPLS["gather"]),
                     ("bf16 gather_pallas", IMPLS["gather_pallas"] + BF16)])


def test_bf16_gather_pallas_step_within_jax_bf16_gap(runs, monkeypatch):
    """A finite loss within 1e-3 of JAX's, every leaf within JAX's own
    bf16 gap (`bf16_gap_ratios`; fp32: JAX's gather)."""
    host_lsap(monkeypatch)
    _, loss, _, grads, uniforms, matching = runs["bf16 gather_pallas"]
    state, p_losses = port_grads(OVERRIDES + IMPLS["gather_pallas"] + BF16,
                                 variables_of(runs["fp32 gather"]),
                                 uniforms, matching)
    assert abs(float(p_losses["loss"]) - loss) <= 1e-3 * abs(loss)
    assert_bf16_gap(bf16_gap_ratios(grads_of(state), jax_grads(
        runs["bf16 gather_pallas"]), jax_grads(runs["fp32 gather"])),
        "bf16 gather_pallas gradients")


def test_bf16_gather_step_runs(runs, monkeypatch):
    """The bf16 `gather` step on the same weights, draws and matching: a
    finite loss and gradient (held to JAX at the backbone, below)."""
    host_lsap(monkeypatch)
    _, _, _, _, uniforms, matching = runs["bf16 gather_pallas"]
    state, p_losses = port_grads(OVERRIDES + IMPLS["gather"] + BF16,
                                 variables_of(runs["fp32 gather"]),
                                 uniforms, matching)
    assert np.isfinite(float(p_losses["loss"]))
    assert all(bool(torch.isfinite(g).all())
               for g in grads_of(state).values())


@pytest.fixture(scope="module")
def backbone_case(runs):
    """The train scene's sparse batches, the JAX step's backbone weights,
    the cotangents of the five maps (seeded normal on the valid rows), and
    `jax_vjp(impl, dtype)`: the port-named parameter gradients of JAX's
    backbone; with JAX's fp32 `gather` ones."""
    from mask3d_tpu.data import VoxelizeCollate as JCollate
    from mask3d_tpu.data import make_synthetic_scene as j_make
    from mask3d_tpu.models.backbone import BACKBONES as JB
    from mask3d_tpu.sparse import build_sparse_batch as j_build
    from mask3d_tpu_torch.sparse.context import build_sparse_batch as t_build

    dev = JCollate(point_bucket_multiple=BUCKET)(one_scene(j_make)).device
    caps = [max(8, int(dev.coords.shape[1] * r))
            for r in (0.5, 0.25, 0.125, 0.0625)]
    gd = dev.grid_dims
    sb = j_build(dev.coords, dev.counts, dev.dims, caps,
                 conv1_kernel_size=3, grid_dims=gd)
    params = variables_of(runs["fp32 gather"])["params"]["backbone"]
    rng = np.random.default_rng(5)
    valid = [np.asarray(sb.levels[4 - i].valid) for i in range(5)]
    cot = [(rng.standard_normal(v.shape + (c,)) * v[..., None]).astype(
        np.float32) for v, c in zip(valid, (256, 128, 128, 96, 96))]

    def jax_vjp(impl, dtype):
        jb = JB["Res16UNet14A"](in_channels=1, conv1_kernel_size=3,
                                impl=impl, compute_dtype=dtype)
        maps, vjp = jax.vjp(jax.jit(
            lambda p: jb.apply({"params": p}, dev.feats, sb)[1]), params)
        (g,) = vjp([jnp.asarray(c).astype(m.dtype)
                    for c, m in zip(cot, maps)])
        return bridge.from_flax({"params": {"backbone": flax_to_numpy(g)}})

    t = [torch.tensor(np.asarray(getattr(dev, f)))
         for f in ("coords", "counts", "dims")]
    return dict(
        jax_vjp=jax_vjp, ref32=jax_vjp("gather", None), cot=cot, gd=gd,
        params=params, feats=torch.tensor(np.asarray(dev.feats)),
        tsb=t_build(*t, caps, gd, conv1_kernel_size=3,
                    build_block_maps=True, build_pool_parents=True))


def test_bf16_gather_backbone_grads_within_jax_gap(backbone_case):
    """Res16UNet14A on the train scene with the JAX step's weights: the
    parameter gradients of sum(map * g) over the five maps in bf16 on
    `gather` against `jax.vjp` of JAX's, within JAX's bf16-vs-fp32 gap of
    the same vjp."""
    impl = "gather"
    from mask3d_tpu_torch.models.backbone import BACKBONES as TB

    c = backbone_case
    tb = TB["Res16UNet14A"](in_channels=1, conv1_kernel_size=3, impl=impl,
                            compute_dtype=torch.bfloat16)
    sd = bridge.from_flax({"params": {"backbone": c["params"]}})
    tb.load_state_dict({k[len("backbone."):]: v for k, v in sd.items()},
                       strict=True)
    maps = tb(c["feats"], c["tsb"], c["gd"])[1]
    sum((m.float() * torch.tensor(g)).sum()
        for m, g in zip(maps, c["cot"])).backward()
    got = {f"backbone.{k}": p.grad for k, p in tb.named_parameters()}
    assert_bf16_gap(bf16_gap_ratios(got, c["jax_vjp"](impl, jnp.bfloat16),
                                    c["ref32"]),
                    f"bf16 {impl} backbone gradients")
