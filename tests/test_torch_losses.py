"""The port's training losses (excel_tpu_torch.models.losses) against the
JAX package's: values and gradients on seeded inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from excel_tpu.models import losses as jl
from excel_tpu_torch.models import losses as pl
from torch_port_common import n, t

# fp32 log-softmax and sums over 2 x 24 x 24 pixels in another order
# (observed 1.1e-6), as the train step's losses are held
VALUE_RTOL = 1e-5
GRAD_ATOL = 1e-8


def _seg_inputs(seed: int, with_empty_fg: bool = False):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((2, 6, 24, 24)).astype(np.float32) * 3
    label = rng.integers(0, 6, (2, 24, 24)).astype(np.int32)
    label[rng.random((2, 24, 24)) < 0.2] = 255
    if with_empty_fg:
        label[label != 255] = 0
    return logits, label


@pytest.mark.parametrize("empty_fg", [False, True])
def test_seg_loss_matches_jax(empty_fg):
    """Value and gradient; with no foreground pixel the fg mean is 0 / 1e-6
    = 0, as in the reference."""
    logits, label = _seg_inputs(0, empty_fg)
    ref, ref_grad = jax.value_and_grad(jl.seg_loss)(
        jnp.asarray(logits), jnp.asarray(label))
    x = t(logits).requires_grad_()
    got = pl.seg_loss(x, t(label))
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=VALUE_RTOL)
    np.testing.assert_allclose(n(x.grad), np.asarray(ref_grad),
                               atol=GRAD_ATOL)


def test_aff_loss_matches_jax():
    rng = np.random.default_rng(1)
    inputs = 1 / (1 + np.exp(-rng.standard_normal((2, 16, 16)))).astype(
        np.float32)
    targets = rng.choice([0, 1, 255], size=(2, 16, 16)).astype(np.int32)
    ref, ref_grad = jax.value_and_grad(jl.aff_loss)(
        jnp.asarray(inputs), jnp.asarray(targets))
    x = t(inputs).requires_grad_()
    got = pl.aff_loss(x, t(targets))
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=VALUE_RTOL)
    np.testing.assert_allclose(n(x.grad), np.asarray(ref_grad),
                               atol=GRAD_ATOL)


def test_loss_denominators():
    """+1e-6 on each of the fg and bg pixel counts, +1 on each affinity
    count: one bg pixel of cross-entropy c gives c / (1 + 1e-6) / 2."""
    logits = torch.zeros((1, 2, 1, 2))
    label = torch.tensor([[[0, 255]]])
    c = float(np.log(2.0))
    assert float(pl.seg_loss(logits, label)) == pytest.approx(
        c / (1 + 1e-6) / 2, rel=1e-6)
    aff = torch.full((1, 1, 2), 0.25)
    tgt = torch.tensor([[[1, 0]]])
    assert float(pl.aff_loss(aff, tgt)) == pytest.approx(
        0.5 * 0.75 / 2 + 0.5 * 0.25 / 2, rel=1e-6)
