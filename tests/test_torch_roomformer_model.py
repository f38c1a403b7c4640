"""The RoomFormer model: the port's forward on the JAX package's parameters
(carried by `load_flax`) against the JAX forward, at the tiny
configuration of tests/test_roomformer.py:157-166, and the port's own
initializers, padding and weight bridge."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mask3d_tpu.baseline import roomformer as jrf
from mask3d_tpu_torch.baseline import roomformer as trf
from tests.torch_roomformer import TINY, random_flax_params
from tests.torch_threads import one_torch_thread_a_module  # noqa: F401

FWD_TOL = 1e-4

# The JAX model builds `with_poly_refine=False` only at one decoder layer:
# at two its shared heads reuse a module name (flax NameInUseError).
CASES = {
    "default": (dict(), (2, 64, 64, 1)),
    "masked_attn": (dict(masked_attn=True), (2, 64, 64, 1)),
    "no_refine_semantic": (dict(with_poly_refine=False, semantic_classes=3,
                                dec_layers=1), (2, 64, 64, 1)),
    "non_square": (dict(), (2, 64, 48, 1)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax(case):
    kw, shape = CASES[case]
    cfg = {**TINY, **kw}
    jm = jrf.RoomFormer(**cfg)
    params = random_flax_params(jm, (1,) + shape[1:], seed=1)
    density = np.random.default_rng(2).random(shape).astype(np.float32)
    want = jax.jit(jm.apply)(params, jnp.asarray(density))
    model = trf.load_flax(trf.RoomFormer(**cfg), params)
    with torch.no_grad():
        got = model(torch.from_numpy(density))
    pairs = [("aux_logits", got.aux_logits, want.aux_logits),
             ("aux_coords", got.aux_coords, want.aux_coords)]
    if kw.get("semantic_classes"):
        pairs.append(("room_logits", got.room_logits, want.room_logits))
    for name, g, w in pairs:
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=FWD_TOL, err_msg=name)


def test_no_refine_shares_one_set_of_heads():
    """Without poly refinement every decoder layer reads the same heads:
    the output equals a refining model's whose per-layer heads are copies
    of that one set."""
    shared = trf.RoomFormer(**TINY, with_poly_refine=False,
                            generator=torch.Generator().manual_seed(3))
    refine = trf.RoomFormer(**TINY, generator=torch.Generator().manual_seed(4))
    assert len(shared.class_embed) == 1 and len(refine.class_embed) == 2
    sd = {k: v for k, v in shared.state_dict().items()}
    for k, v in shared.state_dict().items():
        for head in ("coords_mlp0", "coords_mlp1", "coords_embed",
                     "class_embed"):
            if k.startswith(head + ".0."):
                sd[k.replace(".0.", ".1.", 1)] = v
    refine.load_state_dict(sd, strict=True)
    with torch.no_grad():
        for p in shared.coords_embed[0].parameters():
            p.normal_(0, 0.1)  # heads that move the reference points
        refine.coords_embed[0].load_state_dict(
            shared.coords_embed[0].state_dict())
        refine.coords_embed[1].load_state_dict(
            shared.coords_embed[0].state_dict())
        density = torch.rand(1, 64, 64, 1,
                             generator=torch.Generator().manual_seed(5))
        a, b = shared(density), refine(density)
    assert torch.equal(a.aux_logits, b.aux_logits)
    assert torch.equal(a.aux_coords, b.aux_coords)


def test_load_flax_is_strict():
    jm = jrf.RoomFormer(**TINY)
    params = random_flax_params(jm, (1, 64, 64, 1))
    model = trf.RoomFormer(**TINY)
    trf.load_flax(model, params)
    bad = jax.tree_util.tree_map(lambda x: x, params)
    del bad["params"]["enc_0"]["LayerNorm_1"]
    with pytest.raises(KeyError, match="missing"):
        trf.load_flax(model, bad)
    bad = jax.tree_util.tree_map(lambda x: x, params)
    bad["params"]["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="unmapped"):
        trf.load_flax(model, bad)
    bad = jax.tree_util.tree_map(lambda x: x, params)
    k = bad["params"]["dec_0"]["Dense_0"]["kernel"]
    bad["params"]["dec_0"]["Dense_0"]["kernel"] = k[:-1]
    with pytest.raises(ValueError, match="ffn_out"):
        trf.load_flax(model, bad)
    # the outer FFN Dense, built first, is Dense_0: d_ffn -> d_model
    assert tuple(k.shape) == (512, TINY["d_model"])
    torch.testing.assert_close(model.decoder[0].ffn_out.weight,
                               torch.from_numpy(np.asarray(k).T))


@pytest.mark.parametrize("n,k,s,pads", [(256, 7, 2, (2, 3)),
                                        (128, 3, 2, (0, 1)),
                                        (63, 3, 2, (1, 1)),
                                        (64, 3, 1, (1, 1)),
                                        (64, 1, 2, (0, 0))])
def test_same_padding_is_flax_s(n, k, s, pads):
    """Flax pads total // 2 before and the rest after; the padded map
    gives ceil(n / s) outputs."""
    x = torch.zeros(1, 1, n, n)
    y = trf._same_pad(x, k, s)
    assert y.shape[-1] == n + sum(pads)
    assert (y.shape[-1] - k) // s + 1 == -(-n // s)
    flax_conv = jax.lax.conv_general_dilated(
        jnp.ones((1, n, n, 1)), jnp.ones((k, k, 1, 1)), (s, s), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    torch_conv = torch.nn.functional.conv2d(
        trf._same_pad(torch.ones(1, 1, n, n), k, s), torch.ones(1, 1, k, k),
        stride=s)
    np.testing.assert_array_equal(torch_conv[0, 0].numpy(),
                                  np.asarray(flax_conv)[0, ..., 0])


def test_init_weights_follow_the_jax_initializers():
    model = trf.RoomFormer(generator=torch.Generator().manual_seed(0))
    assert sum(p.numel() for p in model.parameters()) == 12_064_786
    for layer in list(model.encoder) + [m.cross_attn for m in model.decoder]:
        attn = getattr(layer, "attn", layer)
        assert not attn.sampling_offsets.weight.any()
        assert not attn.attn_weights.weight.any()
    assert not any(m.weight.any() for m in model.coords_embed)
    for head in model.class_embed:
        torch.testing.assert_close(head.bias, torch.tensor(
            [-np.log(0.99 / 0.01)], dtype=torch.float32))
    assert abs(float(model.tgt_embed.detach().std()) - 1.0) < 0.01
    w = model.decoder[0].ffn_in.weight  # xavier uniform
    bound = float(np.sqrt(6.0 / (w.shape[0] + w.shape[1])))
    wmax = float(w.detach().abs().max())
    assert 0.9 * bound < wmax <= bound
    stem = model.backbone.stem.weight  # lecun normal, truncated at 2 std
    std = np.sqrt(1.0 / 49) / .87962566103423978
    assert float(stem.detach().abs().max()) <= 2 * std + 1e-6
    a, b = (trf.RoomFormer(**TINY, generator=torch.Generator().manual_seed(0))
            for _ in range(2))
    assert all(torch.equal(x, y) for x, y in
               zip(a.state_dict().values(), b.state_dict().values()))


def test_sine_position_matches_jax():
    got = trf.sine_position_2d(7, 5, 32).numpy()
    want = np.asarray(jrf.sine_position_2d(7, 5, 32))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        trf.inverse_sigmoid(torch.tensor([0.0, 0.3, 1.0])).numpy(),
        np.asarray(jrf.inverse_sigmoid(jnp.asarray([0.0, 0.3, 1.0]))),
        rtol=1e-6)
