"""Port feature surgery, LAMs and similarity maps against the JAX
package's."""
import jax.numpy as jnp
import numpy as np
import pytest

from excel_tpu.models.excel import compute_lams as jax_compute_lams
from excel_tpu.ops.surgery import clip_feature_surgery as jax_surgery
from excel_tpu.ops.surgery import get_similarity_map as jax_similarity_map
from excel_tpu.ops.surgery import similarity_map_to_points as jax_points
from excel_tpu_torch.models.excel import compute_lams
from excel_tpu_torch.ops.surgery import (clip_feature_surgery,
                                         get_similarity_map,
                                         similarity_map_to_points)
from torch_port_common import n, t


def _inputs(seed):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((2, 17, 32)).astype(np.float32)
    img /= np.linalg.norm(img, axis=1, keepdims=True)
    txt = rng.standard_normal((8, 32)).astype(np.float32)
    txt /= np.linalg.norm(txt, axis=-1, keepdims=True)
    return img, txt


def test_clip_feature_surgery_matches():
    """Min-max normalised maps in [0, 1]; fp32 products in another order:
    2e-6 abs."""
    img, txt = _inputs(0)
    np.testing.assert_allclose(
        n(clip_feature_surgery(t(img), t(txt))),
        np.asarray(jax_surgery(jnp.asarray(img), jnp.asarray(txt))),
        atol=2e-6)


def test_compute_lams_matches():
    img, txt = _inputs(1)
    got = compute_lams({"projected": t(img)}, t(txt), 5)
    ref = jax_compute_lams({"projected": jnp.asarray(img)}, jnp.asarray(txt),
                           5)
    assert got.shape == (2, 16, 5)
    np.testing.assert_allclose(n(got), np.asarray(ref), atol=2e-6)


@pytest.mark.parametrize("shape", [(64, 48), (3, 5), (16, 16)])
def test_get_similarity_map_matches(shape):
    """Upsampled (16x at the reference's use), and shrunk, where
    `jax.image.resize` antialiases."""
    sm = np.random.default_rng(3).random((2, 16, 5), dtype=np.float32)
    ref = jax_similarity_map(jnp.asarray(sm), shape)
    got = get_similarity_map(t(sm), shape)
    assert got.shape == ref.shape
    np.testing.assert_allclose(n(got), np.asarray(ref), rtol=0, atol=1e-6)


@pytest.mark.parametrize("t_", [0.8, 0.3, 1.1])
def test_similarity_map_to_points_equal(t_):
    sm = np.random.default_rng(4).random(64, dtype=np.float32)
    ref = jax_points(sm, (120, 90), t=t_)
    for arg in (sm, t(sm)):
        points, labels = similarity_map_to_points(arg, (120, 90), t=t_)
        assert points == ref[0]
        np.testing.assert_array_equal(labels, ref[1])
        assert labels.dtype == np.uint8
