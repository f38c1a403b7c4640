"""Shared helpers of the RoomFormer parity tests: the JAX tests' tiny
configuration (tests/test_roomformer.py:157-166), seeded random Flax
parameters for it (every leaf drawn with numpy, so the sampling offsets,
attention weights and coordinate heads are not the initializers' zeros),
and the floorplan scenes in the Structured3D layout."""

import numpy as np

TINY = dict(d_model=32, n_heads=4, n_levels=4, n_points=2, enc_layers=1,
            dec_layers=2, num_polys=3, num_queries=12,
            backbone_channels=(8, 16, 32))


def random_flax_params(model, shape, seed=0):
    """Numpy leaves of `model.init`'s tree for an input of `shape`:
    kernels normal / sqrt(fan-in), biases 0.1 normal, norm scales 1 + 0.1
    normal, embeddings normal."""
    import jax
    import jax.numpy as jnp

    tree = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                          jnp.zeros(shape, jnp.float32))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        x = rng.normal(size=s.shape)
        if name == "scale":
            x = 1.0 + 0.1 * x
        elif name == "bias":
            x = 0.1 * x
        elif name == "kernel":
            parent = path[-2].key
            fan_in = (s.shape[0] if parent in ("query", "key", "value")
                      else int(np.prod(s.shape[:-1])))
            x = x / np.sqrt(fan_in)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def floorplan_targets(rng, b, pt, qp, n_valid):
    """Padded polygon targets of `collate_floorplan`'s layout: item i has
    n_valid[i] polygons of 3..qp random corners in [0.05, 0.95]."""
    coords = np.zeros((b, pt, 2 * qp), np.float32)
    labels = np.zeros((b, pt, qp), np.float32)
    lengths = np.zeros((b, pt), np.int32)
    valid = np.zeros((b, pt), bool)
    for i in range(b):
        for j in range(n_valid[i]):
            n = int(rng.integers(3, qp + 1))
            coords[i, j, :2 * n] = rng.uniform(0.05, 0.95, 2 * n)
            labels[i, j, :n] = 1.0
            lengths[i, j] = 2 * n
            valid[i, j] = True
    return {"coords": coords, "labels": labels, "lengths": lengths,
            "poly_valid": valid}
