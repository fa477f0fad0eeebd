"""Port feature surgery and LAMs against the JAX package's."""
import jax.numpy as jnp
import numpy as np

from excel_tpu.models.excel import compute_lams as jax_compute_lams
from excel_tpu.ops.surgery import clip_feature_surgery as jax_surgery
from excel_tpu_torch.models.excel import compute_lams
from excel_tpu_torch.ops.surgery import clip_feature_surgery
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
