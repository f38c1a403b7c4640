"""The port's autograd pieces against the JAX package on the same numpy
inputs: each kernel Function's gradients against `jax.vjp` of the JAX
kernel (its Pallas forward in interpret mode, its `custom_vjp` backward),
the sampled memory's row choice, and the optimizer with every scheduler
branch against optax."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mask3d_tpu.config import Config as JConfig, apply_overrides as j_apply
from mask3d_tpu.ops.pallas_attention import \
    masked_cross_attention as j_attention
from mask3d_tpu.sparse.pallas_conv import sparse_conv_pallas
from mask3d_tpu.sparse.pallas_gather import monotone_gather
from mask3d_tpu.train.loop import make_optimizer as j_make_optimizer
from mask3d_tpu_torch.config import Config, apply_overrides
from mask3d_tpu_torch.models.mask3d import sample_memory_idx
from mask3d_tpu_torch.ops.masked_attention import masked_cross_attention
from mask3d_tpu_torch.sparse.row_gather import row_gather
from mask3d_tpu_torch.sparse.sparse_conv import sparse_conv
from tests.torch_parity import (  # noqa: F401 (autouse fixture)
    one_torch_thread_a_module)

# f32 sums in another order on each side
GRAD_TOL = 1e-5


def _close(ref, got, tol=GRAD_TOL, what=""):
    ref = np.asarray(ref, np.float64)
    got = got.detach().double().numpy()
    assert ref.shape == got.shape, (what, ref.shape, got.shape)
    err = np.abs(got - ref).max() / max(1.0, np.abs(ref).max())
    assert err <= tol, f"{what}: max|diff|/max(1,max|ref|) = {err:.3g}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_gather_grad_matches_jax(dtype):
    """dsrc: an f32 scatter-add of the cotangent where ok, cast to src's
    dtype; many rows on one source row (the padding's clamp target) and
    rows that are not ok."""
    rng = np.random.default_rng(0)
    b, n, c, m = 2, 4096, 8, 512
    src = rng.normal(size=(b, n, c)).astype(np.float32)
    idx = np.cumsum(rng.integers(0, 6, size=(b, m)), axis=1).astype(np.int32)
    idx[:, -40:] = n - 1  # the padding rows' common source row
    ok = rng.random((b, m)) < 0.85
    g = rng.normal(size=(b, m, c)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    _, vjp = jax.vjp(lambda s: monotone_gather(s, idx, ok, 256, 2048),
                     jnp.asarray(src, jdt))
    ref = np.asarray(vjp(jnp.asarray(g, jnp.float32))[0].astype(jnp.float32))

    tdt = getattr(torch, dtype)
    s = torch.tensor(src).to(tdt).requires_grad_()
    out = row_gather(s, torch.tensor(idx), torch.tensor(ok))
    out.backward(torch.tensor(g).to(tdt))
    assert s.grad.dtype == tdt
    # the bf16 cotangent differs from JAX's f32 one by its rounding
    _close(ref, s.grad.float(), GRAD_TOL if dtype == "float32" else 1e-2,
           "dsrc")


@pytest.mark.parametrize("needs", ["qkv", "q", "kv"])
def test_attention_grad_matches_jax(needs):
    """(dq, dk, dv): the VJP of the one-shot form, with an all-blocked row
    and an open one; inputs that need no gradient get None."""
    rng = np.random.default_rng(11)
    b, nq, s, d, h = 2, 9, 128, 32, 4
    q, k, v = (rng.normal(size=shape).astype(np.float32)
               for shape in ((b, nq, d), (b, s, d), (b, s, d)))
    mask = rng.random((b, nq, s)) < 0.4
    mask[0, 2] = True
    mask[1, 0] = False
    g = rng.normal(size=(b, nq, d)).astype(np.float32)
    _, vjp = jax.vjp(
        lambda q_, k_, v_: j_attention(q_, k_, v_, mask, h, tile=32,
                                       interpret=True),
        *(jnp.asarray(x) for x in (q, k, v)))
    ref = vjp(jnp.asarray(g))

    ts = [torch.tensor(x).requires_grad_(name in needs)
          for x, name in zip((q, k, v), "qkv")]
    out = masked_cross_attention(*ts, torch.tensor(mask), h)
    out.backward(torch.tensor(g))
    for r, t, name in zip(ref, ts, "qkv"):
        if name in needs:
            _close(r, t.grad, what=f"d{name}")
        else:
            assert t.grad is None


def _kernel_map(coords, counts, cap):
    """3x3x3 neighbour rows (cube-ravel offset order) of each item's sorted
    voxels: idx i32[B, cap, 27], ok bool[B, cap, 27]."""
    offs = np.stack(np.meshgrid(*[np.arange(-1, 2)] * 3, indexing="ij"),
                    -1).reshape(27, 3)
    b = len(counts)
    idx = np.zeros((b, cap, 27), np.int32)
    ok = np.zeros((b, cap, 27), bool)
    for i in range(b):
        row = {tuple(c): j for j, c in enumerate(coords[i, :counts[i]])}
        for j in range(counts[i]):
            for k, o in enumerate(offs):
                r = row.get(tuple(coords[i, j] + o))
                if r is not None:
                    idx[i, j, k], ok[i, j, k] = r, True
    return idx, ok


def test_sparse_conv_grad_matches_jax():
    """(dF, dW) of the JAX package's per-offset backward, from the f32
    inputs (not the forward's bf16-rounded ones), on a voxel kernel map."""
    rng = np.random.default_rng(3)
    b, cap = 2, 256
    coords = np.zeros((b, cap, 3), np.int32)
    counts = np.zeros(b, np.int32)
    for i in range(b):
        pts = np.unique(np.stack([rng.integers(0, 12, 220),
                                  rng.integers(0, 12, 220),
                                  rng.integers(0, 4, 220)], 1), axis=0)
        coords[i, :len(pts)], counts[i] = pts, len(pts)
    idx, ok = _kernel_map(coords, counts, cap)
    valid = np.arange(cap)[None] < counts[:, None]
    feats = rng.normal(size=(b, cap, 8)).astype(np.float32) * valid[..., None]
    w = (rng.normal(size=(27, 8, 16)) * 0.1).astype(np.float32)
    g = rng.normal(size=(b, cap, 16)).astype(np.float32)
    _, vjp = jax.vjp(
        lambda f, w_: sparse_conv_pallas(f, w_, idx, ok, 64, 128),
        jnp.asarray(feats), jnp.asarray(w))
    ref_f, ref_w = vjp(jnp.asarray(g))

    f_t = torch.tensor(feats).requires_grad_()
    w_t = torch.tensor(w).requires_grad_()
    sparse_conv(f_t, w_t, torch.tensor(idx), torch.tensor(ok)).backward(
        torch.tensor(g))
    _close(ref_f, f_t.grad, what="dF")
    _close(ref_w, w_t.grad, what="dW")


@pytest.mark.parametrize("count,s", [(50, 20), (12, 20), (0, 20), (64, 64)])
def test_sample_memory_idx_matches_jax(count, s):
    """The rows JAX's expression (`mask3d.py:693-699`) takes for the same
    uniforms: the valid rows in the order of their draws, then the
    invalid ones in row order."""
    rng = np.random.default_rng(count)
    b, cap = 3, 64
    r = rng.random((b, cap)).astype(np.float32)
    valid = np.arange(cap)[None] < np.array([count, count // 2, 1])[:, None]
    ref = np.asarray(jnp.argsort(
        jnp.where(jnp.asarray(valid), jnp.asarray(r), 2.0), axis=-1)[:, :s])
    got = sample_memory_idx(torch.tensor(r), torch.tensor(valid), s)
    assert np.array_equal(got.numpy(), ref)


SCHEDULES = {
    "exponentiallr": ["scheduler.name=exponentiallr", "scheduler.gamma=0.9"],
    "onecyclelr": ["scheduler.name=onecyclelr", "scheduler.steps_per_epoch=2",
                   "trainer.max_epochs=2"],
    "steplr": ["scheduler.name=steplr", "scheduler.step_size=1",
               "scheduler.steps_per_epoch=2", "scheduler.gamma=0.5"],
    "lambdalr": ["scheduler.name=lambdalr", "scheduler.step_size=1",
                 "scheduler.steps_per_epoch=1", "scheduler.gamma=0.5"],
    "constant": ["scheduler.name=none"],
    "adam": ["optimizer.name=adam", "scheduler.gamma=0.9"],
    "freeze_backbone": ["general.freeze_backbone=true",
                        "scheduler.gamma=0.9"],
}


class _Tiny(torch.nn.Module):
    """A backbone and a head: what `make_optimizer` reads of a model."""

    def __init__(self):
        super().__init__()
        gen = torch.Generator().manual_seed(0)
        self.backbone = torch.nn.Linear(6, 5)
        self.head = torch.nn.Linear(5, 3)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=gen))


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_optimizer_matches_optax(name):
    """Five updates on the same random gradients: AdamW (or Adam) with the
    schedule against the JAX package's optax transformation; with
    `freeze_backbone` the backbone neither moves nor decays."""
    from mask3d_tpu_torch.train.loop import make_optimizer

    over = ["optimizer.lr=0.01", "optimizer.weight_decay=0.05"] + \
        SCHEDULES[name]
    cfg = apply_overrides(Config(), over)
    tx = j_make_optimizer(j_apply(JConfig(), over))
    model = _Tiny()
    start = {k: p.detach().clone() for k, p in model.named_parameters()}
    opt, sched = make_optimizer(cfg, model)

    def tree(flat):  # the label_fn of freeze_backbone keys on "backbone"
        out = {"backbone": {}, "head": {}}
        for k, v in flat.items():
            out[k.split(".")[0]][k] = v
        return out

    params = tree({k: jnp.asarray(v.numpy()) for k, v in start.items()})
    state = tx.init(params)
    rng = np.random.default_rng(5)
    for _ in range(5):
        grads = {k: rng.normal(size=p.shape).astype(np.float32)
                 for k, p in start.items()}
        updates, state = tx.update(
            tree({k: jnp.asarray(v) for k, v in grads.items()}), state,
            params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        for k, p in model.named_parameters():
            if p.requires_grad:
                p.grad = torch.tensor(grads[k])
        opt.step()
        sched.step()
    flat = {**params["backbone"], **params["head"]}
    for k, p in model.named_parameters():
        _close(flat[k], p, 1e-6, k)
        if name == "freeze_backbone" and k.startswith("backbone."):
            assert torch.equal(p, start[k]), k
