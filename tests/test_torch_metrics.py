"""Port confusion hist and scores against the JAX package's: exact."""
import jax.numpy as jnp
import numpy as np

from excel_tpu.utils import metrics as jm
from excel_tpu_torch.utils import metrics as pm
from torch_port_common import n, t


def test_update_hist_and_scores_exact():
    rng = np.random.default_rng(0)
    gt = rng.integers(0, 6, (3, 40, 50)).astype(np.int32)
    gt[:, 30:] = 255                                   # padded canvas rows
    pred = rng.integers(0, 6, (3, 40, 50)).astype(np.int32)
    jh = jm.update_hist(jm.init_hist(6), jnp.asarray(gt), jnp.asarray(pred),
                        6)
    ph = pm.update_hist(pm.init_hist(6), t(gt), t(pred), 6)
    np.testing.assert_array_equal(n(ph), np.asarray(jh))
    np.testing.assert_equal(pm.scores_from_hist(ph),
                            jm.scores_from_hist(np.asarray(jh)))
