"""One train step of small_config at B=1 on `backbone_impl=bricked`
against the JAX package (tests/torch_train_parity.py): in fp32 the loss
and every gradient leaf against `jax.value_and_grad` of JAX's bricked and
of JAX's gather model (the same function), the sampled memories drawn from
the same numpy uniforms; in bf16 each leaf within JAX's own bf16 gap."""

import pytest

from tests.test_torch_train_step import LOSS_RTOL, OVERRIDES, grad_errors, \
    host_lsap
from tests.torch_train_parity import BF16, BRICKED, IMPLS, \
    assert_bf16_gap, bf16_gap_ratios, grads_of, jax_grads, jax_runs, \
    one_torch_thread, port_grads, variables_of  # noqa: F401 (fixture)

# per leaf ||g_port - g_jax|| / ||g_jax||: test_torch_train_step's bound,
# and test_torch_train_parity's where JAX's jitted bricked backbone is the
# reference: its level-0 norm leaves sit up to 5.4e-3 from JAX's own
# gather ones (measured), while the port's bricked, dense and gather all
# agree with JAX's gather to 1e-5
GRAD_TOL = 1e-4
JIT_BRICKED_TOL = 1e-2


@pytest.fixture(scope="module")
def runs():
    return jax_runs([("fp32 bricked", BRICKED),
                     ("fp32 gather", IMPLS["gather"]),
                     ("bf16 bricked", BRICKED + BF16)])


@pytest.mark.parametrize("ref", ["bricked", "gather"])
def test_bricked_step_matches_jax_grad(runs, ref, monkeypatch):
    """fp32 bricked: the loss within 1e-4, every loss entry within 1e-4 of
    max(1, |ref|), the decoder's leaves within GRAD_TOL of both, the
    backbone's within GRAD_TOL of JAX's gather and JIT_BRICKED_TOL of
    JAX's bricked."""
    host_lsap(monkeypatch)
    run = runs[f"fp32 {ref}"]
    _, loss, losses, grads, uniforms, _ = run
    assert len(uniforms.drawn) == 2 * 4  # decoders x levels
    state, p_losses = port_grads(OVERRIDES + BRICKED,
                                 variables_of(runs["fp32 bricked"]),
                                 uniforms)
    assert abs(float(p_losses["loss"]) - loss) <= LOSS_RTOL * abs(loss)
    for k, v in losses.items():
        r = float(v)
        assert abs(float(p_losses[k]) - r) <= 1e-4 * max(1.0, abs(r)), k
    assert int(p_losses["batch_overflow"]) == 0
    errs = grad_errors(state, grads)
    worst = max(errs, key=errs.get)
    decoder = max(v for k, v in errs.items() if not k.startswith("backbone"))
    assert decoder <= GRAD_TOL, decoder
    assert errs[worst] <= (GRAD_TOL if ref == "gather" else
                           JIT_BRICKED_TOL), (worst, errs[worst])


def test_bf16_bricked_step_within_jax_bf16_gap(runs, monkeypatch):
    """bf16 bricked: a finite loss within 1e-3 of JAX's, every leaf within
    JAX's own bf16 gap (`bf16_gap_ratios`; fp32: JAX's gather)."""
    host_lsap(monkeypatch)
    _, loss, _, grads, uniforms, matching = runs["bf16 bricked"]
    state, p_losses = port_grads(OVERRIDES + BRICKED + BF16,
                                 variables_of(runs["fp32 bricked"]),
                                 uniforms, matching)
    assert abs(float(p_losses["loss"]) - loss) <= 1e-3 * abs(loss)
    assert_bf16_gap(bf16_gap_ratios(grads_of(state), jax_grads(
        runs["bf16 bricked"]), jax_grads(runs["fp32 gather"])),
        "bf16 bricked gradients")
