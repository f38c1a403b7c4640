"""Shared inputs and checks of the PyTorch port's parity tests: the same
numpy-seeded inputs go through the JAX package and `mask3d_tpu_torch`, and
the outputs are compared as numpy arrays."""

import jax
import numpy as np
import torch

# autouse where imported: the modules that import it from here take it
from tests.torch_threads import one_torch_thread_a_module  # noqa: F401

# tests/test_e2e.py::small_config as an override list (the port shares the
# override grammar); test_torch_imports checks the two stay equal.
SMALL_OVERRIDES = [
    "model.hidden_dim=32",
    "model.dim_feedforward=64",
    "model.num_queries=8",
    "model.num_heads=4",
    "model.num_decoders=2",
    "model.backbone=Res16UNet14A",
    "model.conv1_kernel_size=3",
    "model.sample_sizes=[32,64,128,256,512]",
    "data.point_bucket_multiple=512",
    "optimizer.lr=0.002",
    "scheduler.gamma=1.0",
]
BUCKET = 512


def scene_items(seed=3, n=2, make=None):
    """Synthetic scenes of 3x2 rooms of 12 at bucket 512.

    Not the 2x1-room scenes of tests/test_e2e.py: their coarsest levels
    hold one or two occupied cells per item, where InstanceNorm amplifies
    float rounding (var ~ 0, scale 1/sqrt(eps)); there the JAX package's
    own jitted and eager backbones differ by 7e-3 (measured), so no port
    can be held to 1e-4. With 3x2 rooms both agree to ~3e-5.
    """
    if make is None:
        from mask3d_tpu.data import make_synthetic_scene as make
    rng = np.random.default_rng(seed)
    return [make(rng, num_rooms_x=3, num_rooms_y=2, room_size=12, height=6,
                 jitter=0.0, dropout=0.5) for _ in range(n)]


def flax_to_numpy(variables):
    return jax.tree_util.tree_map(np.asarray, dict(variables))


def scaled_err(ref, got):
    """max |got - ref| / max(1, std(ref))."""
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got.detach().cpu().numpy() if torch.is_tensor(got)
                     else got, np.float64)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    return float(np.abs(got - ref).max()) / max(1.0, float(ref.std()))


def assert_scaled_close(ref, got, tol=1e-4, what=""):
    err = scaled_err(ref, got)
    assert err <= tol, f"{what}: max|diff|/max(1,std) = {err:.3g} > {tol}"
