"""The port's demo (excel_tpu_torch.cli.demo, counterpart of
tools/demo_pipeline.py) on the CPU at the tiny config: `run_demo`'s labels
against the JAX package's `training_free_step` (its plain route) on the
demo's own images and labels, one text bank and converted weights, and
`main` end to end."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from excel_tpu.config import tiny_config
from excel_tpu.engine.pipeline import training_free_step
from excel_tpu_torch.cli import demo
from excel_tpu_torch.config import tiny_config as port_tiny_config
from torch_port_common import LABEL_DIFF_SHARE, jax_clip_tree, port_params


def test_run_demo_matches_jax_training_free_step():
    jcfg, pcfg = tiny_config(), port_tiny_config()
    clip = jax_clip_tree(jcfg.clip, seed=0)
    images, cls = demo.synthetic_batch(4, pcfg.clip.image_size, pcfg.num_fg)
    assert cls.sum(axis=1).tolist() == [1.0] * 4      # class 0 alone
    text = demo.random_text_bank(pcfg.num_fg + 25, pcfg.clip.embed_dim)
    labels, first_s, steady_s = demo.run_demo(
        port_params(clip, pcfg.clip), images, cls, text, pcfg, "cpu")
    ref = np.asarray(training_free_step(
        jax.tree_util.tree_map(jnp.asarray, clip), jnp.asarray(images),
        jnp.asarray(cls), jnp.asarray(text.numpy()), jcfg))
    assert labels.shape == ref.shape == (4, 64, 64)
    assert labels.dtype == np.int32 and first_s > 0 and steady_s > 0
    assert set(np.unique(ref).tolist()) == {0, 1}      # both labels occur
    assert (labels != ref).sum() <= LABEL_DIFF_SHARE * ref.size


def test_random_text_bank_is_seeded_and_normalised():
    a, b = demo.random_text_bank(30, 32), demo.random_text_bank(30, 32)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(torch.linalg.norm(a, dim=-1),
                               torch.ones(30), rtol=0, atol=1e-6)
    images, cls = demo.synthetic_batch(2, 320, 20)
    # the JAX demo's images: noise below 64, the blob lifted by 150
    assert images[:, 80:220, 60:180].min() >= 150
    assert images[:, :80].max() < 64 and cls[0].nonzero()[0].tolist() == [
        0, 7, 14]


def test_main_runs_on_the_cpu_at_the_tiny_size(capsys):
    labels = demo.main(["--device", "cpu", "--tiny", "--image-size", "64"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "devices: cpu"
    assert out[1].startswith("first call (build + run): ")
    assert out[2] == "pseudo-label shape: (4, 64, 64)  dtype: int32"
    assert out[3].startswith("label histogram: {")
    assert out[-1] == "OK" and labels.shape == (4, 64, 64)
