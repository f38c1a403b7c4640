"""The train path on the card (skipped without one): each kernel Function's
backward after its kernel forward against autograd of the plain path, and
one small train step on the card against the CPU. Imports nothing of the
JAX package, which the card's machine cannot import."""

import numpy as np
import pytest
import torch

SMALL = [  # tests/test_e2e.py::small_config (tests/torch_parity.py)
    "model.hidden_dim=32", "model.dim_feedforward=64",
    "model.num_queries=8", "model.num_heads=4", "model.num_decoders=2",
    "model.backbone=Res16UNet14A", "model.conv1_kernel_size=3",
    "model.sample_sizes=[32,64,128,256,512]",
    "data.point_bucket_multiple=512", "optimizer.lr=0.002",
    "scheduler.gamma=1.0",
]
# the card against its plain path: f32 sums in another order
FUNCTION_TOL = 1e-5


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _err(ref, got):
    ref, got = ref.double(), got.double()
    return float((got - ref).abs().max()) / max(1.0, float(ref.abs().max()))


def _grads(fn, inputs, g):
    """(output, grads) of fn at fresh leaves of `inputs`."""
    leaves = [x.detach().requires_grad_() for x in inputs]
    out = fn(*leaves)
    return out, torch.autograd.grad(out, leaves, g)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [200, 3072])
def test_attention_backward_on_the_card(s):
    """Kernel forward + the Function's backward against the plain forward
    and its autograd, at a train and an eval key length."""
    _need_card()
    from mask3d_tpu_torch import cuda_build
    from mask3d_tpu_torch.ops import masked_attention as ma

    gen = torch.Generator(device="cuda").manual_seed(s)
    b, nq, d, h = 8, 25, 128, 8
    q, k, v = (torch.randn(b, n, d, device="cuda", generator=gen)
               for n in (nq, s, s))
    mask = torch.rand(b, nq, s, device="cuda", generator=gen) < 0.4
    mask[0, 0] = True
    g = torch.randn(b, nq, d, device="cuda", generator=gen)
    before = ma.masked_cross_attention.launches
    out, grads = _grads(lambda *t: ma.masked_cross_attention(*t, mask, h),
                        (q, k, v), g)
    assert ma.masked_cross_attention.launches == before + 1
    with cuda_build.plain_versions():
        ref, ref_grads = _grads(
            lambda *t: ma.masked_cross_attention(*t, mask, h), (q, k, v), g)
    assert ma.masked_cross_attention.launches == before + 1
    assert _err(ref, out) <= 1e-4
    for r, x in zip(ref_grads, grads):
        assert _err(r, x) <= FUNCTION_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_gather_backward_on_the_card(dtype):
    """One valid row a source cell and the padding on one clamp target: the
    scatter-add equals autograd of the plain gather bitwise."""
    _need_card()
    from mask3d_tpu_torch import cuda_build
    from mask3d_tpu_torch.sparse import row_gather as rg

    gen = torch.Generator(device="cuda").manual_seed(1)
    b, n, m, c = 2, 5000, 3000, 96
    idx = torch.sort(torch.randperm(n, device="cuda", generator=gen)[:m])[0]
    idx = idx.to(torch.int32)[None].repeat(b, 1).contiguous()
    ok = torch.arange(m, device="cuda")[None] < torch.tensor(
        [[m - 100], [m - 700]], device="cuda")
    idx[~ok] = n - 1
    src = torch.randn(b, n, c, device="cuda", generator=gen).to(dtype)
    g = torch.randn(b, m, c, device="cuda", generator=gen).to(dtype)
    out, (dsrc,) = _grads(lambda t: rg.row_gather(t, idx, ok), (src,), g)
    with cuda_build.plain_versions():
        ref, (ref_dsrc,) = _grads(lambda t: rg.row_gather(t, idx, ok), (src,),
                                  g)
    assert torch.equal(out, ref)
    assert dsrc.dtype == dtype and torch.equal(dsrc, ref_dsrc)


@pytest.mark.cuda
def test_sparse_conv_backward_on_the_card():
    """dF and dW after the kernel forward against autograd of the fp32
    gather-conv (the JAX backward's formula, f32 inputs)."""
    _need_card()
    from mask3d_tpu_torch.sparse import ops
    from mask3d_tpu_torch.sparse import sparse_conv as sc

    gen = torch.Generator(device="cuda").manual_seed(2)
    b, n, k, cin, cout = 2, 4096, 27, 96, 64
    idx = torch.randint(0, n, (b, n, k), device="cuda", generator=gen,
                        dtype=torch.int32)
    ok = torch.rand(b, n, k, device="cuda", generator=gen) < 0.3
    feats = torch.randn(b, n, cin, device="cuda", generator=gen)
    w = torch.randn(k, cin, cout, device="cuda", generator=gen) / 30
    g = torch.randn(b, n, cout, device="cuda", generator=gen)
    before = sc.sparse_conv.launches
    _, (df, dw) = _grads(lambda f, ww: sc.sparse_conv(f, ww, idx, ok),
                         (feats, w), g)
    assert sc.sparse_conv.launches == before + 1
    _, (rf, rw) = _grads(lambda f, ww: ops.sparse_conv(f, ww, idx, ok),
                         (feats, w), g)
    assert _err(rf, df) <= FUNCTION_TOL
    assert _err(rw, dw) <= FUNCTION_TOL


@pytest.mark.cuda
def test_train_step_card_matches_cpu():
    """One small_config step with whole levels as memories: the loss within
    1e-4 and every gradient leaf within 1e-3 (relative norm) of the CPU's
    plain versions; the kernels launched."""
    _need_card()
    import mask3d_tpu_torch as mt
    from mask3d_tpu_torch.data.synthetic import make_synthetic_scene
    from mask3d_tpu_torch.ops import masked_attention as ma
    from mask3d_tpu_torch.sparse import row_gather as rg
    from mask3d_tpu_torch.train.criterion import make_criterion
    from mask3d_tpu_torch.train.loop import init_state, make_train_step

    cfg = mt.apply_overrides(mt.Config(), SMALL + [
        "model.max_sample_size=true", "trainer.train_split_metrics=false"])
    scenes = [make_synthetic_scene(np.random.default_rng(3 + i),
                                   num_rooms_x=3, num_rooms_y=2,
                                   room_size=12, height=6, jitter=0.0,
                                   dropout=0.5) for i in range(2)]
    host = mt.collate(scenes, device="cpu", point_bucket_multiple=512)
    out = {}
    for dev in ("cpu", "cuda"):
        state = init_state(cfg, device=dev)
        n_attn = ma.masked_cross_attention.launches
        n_gather = rg.row_gather.launches
        with torch.backends.mkldnn.flags(enabled=False):
            losses, _ = make_train_step(cfg, make_criterion(cfg), dev)(
                state, host.device)
        out[dev] = (float(losses["loss"]),
                    {k: p.grad.cpu().double()
                     for k, p in state.model.named_parameters()})
    assert ma.masked_cross_attention.launches == n_attn + 8
    assert rg.row_gather.launches == n_gather + 13
    (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    floor = 1e-4 * max(float(v.norm()) for v in gc.values())
    for k, ref in gc.items():
        err = float((gg[k] - ref).norm()) / max(float(ref.norm()), floor)
        assert err <= 1e-3, (k, err)
