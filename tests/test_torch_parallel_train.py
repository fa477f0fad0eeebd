"""The port's data-parallel train step (engine/train under a process group)
on the CPU: 2 gloo ranks of B=2 against one process of B=4, in each phase,
with the tiny config's dropout and without; without dropout also against
the JAX package's `train_step` on the same global batch (its mesh makes
the losses' divisors and attn_pred's mean global reductions). And a group
of one rank computes what one process without a group does, bit for bit.

One-class samples: random weights tie classes over whole regions, and an
ulp then decides them (ROADMAP §3)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from excel_tpu.config import tiny_config
from excel_tpu.engine import train as jtr
from excel_tpu.engine.checkpoint import save_head_npz
from excel_tpu.models.params import save_params_npz
from excel_tpu_torch.config import tiny_config as port_tiny_config
from excel_tpu_torch.engine import train as ptr
from excel_tpu_torch.engine.checkpoint import load_head_npz
from excel_tpu_torch.models.params import load_params_npz
from torch_parallel_common import (GRAD_RTOL_OF_MAX, LOSS_RTOL, PHASES,
                                   cfg_with_dropout, run_ranks, step_records)
from torch_port_common import (jax_clip_tree, jax_head_tree,
                               jax_interpret_cfg, train_batch)

RATES = (port_tiny_config().head.dropout, 0.0)


def _key(rate, phase):
    return f"{rate}_{int(phase[0])}_{int(phase[1])}"


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """The global batch of 4 one-class crops, the JAX package's CLIP and
    head, as files the ranks read."""
    d = str(tmp_path_factory.mktemp("parallel_train"))
    cfg = tiny_config()
    save_params_npz(os.path.join(d, "clip.npz"), jax_clip_tree(cfg.clip, 0))
    save_head_npz(os.path.join(d, "head.npz"), jax_head_tree(cfg, seed=1))
    images, cls, text = train_batch(cfg, 4, seed=3, max_classes=1)
    np.savez(os.path.join(d, "batch.npz"), images=images, cls=cls,
             text=text)
    return d


@pytest.fixture(scope="module")
def runs(data_dir):
    """(rank 0's records, rank 1's, one process's at the global batch)."""
    run_ranks(2, "step", data_dir, "-")
    ranks = [dict(np.load(os.path.join(data_dir, f"rank{r}_step.npz")))
             for r in range(2)]
    return ranks[0], ranks[1], step_records(data_dir)


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("phase", PHASES)
def test_ranks_hold_equal_heads(runs, phase, rate):
    r0, r1, _ = runs
    key = _key(rate, phase)
    np.testing.assert_array_equal(r0[key + "_grads"], r1[key + "_grads"])
    np.testing.assert_array_equal(r0[key + "_head"], r1[key + "_head"])


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("phase", PHASES)
def test_two_ranks_match_one_process(runs, phase, rate):
    """The ranks' loss shares sum to one process's losses at B=4, and the
    reduced gradients are its gradients (dropout draws included: each rank
    keeps its rows of the global draw)."""
    r0, r1, one = runs
    key = _key(rate, phase)
    np.testing.assert_allclose(r0[key + "_losses"] + r1[key + "_losses"],
                               one[key + "_losses"], rtol=LOSS_RTOL)
    g = one[key + "_grads"]
    np.testing.assert_allclose(r0[key + "_grads"], g, rtol=0,
                               atol=GRAD_RTOL_OF_MAX * np.abs(g).max())


@pytest.fixture(scope="module")
def jax_losses(data_dir):
    """{phase: (loss, seg_loss, diver_loss)} of the JAX package's step at
    the global batch, dropout off, full class stack (its attention kernels
    in interpret mode)."""
    cfg = cfg_with_dropout(jax_interpret_cfg(tiny_config()), 0.0)
    clip = jax_clip_tree(cfg.clip, 0)
    head = jax.tree_util.tree_map(jnp.asarray, jax_head_tree(cfg, seed=1))
    with np.load(os.path.join(data_dir, "batch.npz")) as d:
        images, cls, text = (jnp.asarray(d[k])
                             for k in ("images", "cls", "text"))
    out = {}
    for cal, seg in PHASES:
        fn = jtr.compiled_train_step(cfg, calibrated=cal, seg_affinity=seg,
                                     donate=False)
        _, m = fn(jtr.init_train_state(head, cfg.train), clip, images, cls,
                  text, jax.random.PRNGKey(0))
        out[cal, seg] = np.array([float(m[k]) for k in
                                  ("loss", "seg_loss", "diver_loss")])
    return out


@pytest.mark.parametrize("phase", PHASES)
def test_two_ranks_match_jax(runs, jax_losses, phase):
    r0, r1, _ = runs
    key = _key(0.0, phase)
    np.testing.assert_allclose(r0[key + "_losses"] + r1[key + "_losses"],
                               jax_losses[phase], rtol=LOSS_RTOL)


@pytest.mark.parametrize("phase", PHASES)
def test_per_rank_losses_would_miss(data_dir, runs, phase):
    """The batch splits so that the halves' fg/bg and pos/neg counts
    differ: the mean of losses each normalised by its own half's counts
    (a per-rank loss averaged as DDP averages) misses the global loss by
    more than the tolerance the ranks meet."""
    cfg = cfg_with_dropout(port_tiny_config(), 0.0)
    clip = load_params_npz(os.path.join(data_dir, "clip.npz"), cfg.clip,
                           "cpu")
    head = load_head_npz(os.path.join(data_dir, "head.npz"), cfg.head,
                         cfg.num_classes, "cpu")
    with np.load(os.path.join(data_dir, "batch.npz")) as d:
        images, cls, text = (torch.from_numpy(d[k])
                             for k in ("images", "cls", "text"))
    halves = [ptr.train_losses(head, clip, images[s], cls[s], text, None,
                               cfg, calibrated=phase[0],
                               seg_affinity=phase[1])
              for s in (slice(0, 2), slice(2, 4))]
    naive = np.array([[float(x.detach()) for x in h[:3]]
                      for h in halves]).mean(0)
    want = runs[2][_key(0.0, phase) + "_losses"]
    assert np.all(np.abs(naive - want) > LOSS_RTOL * np.abs(want)), (
        naive, want)


def test_group_of_one_equals_no_group(data_dir, runs):
    """A gloo group of one rank runs every collective of the step and
    computes one process's records bit for bit."""
    run_ranks(1, "step", data_dir, "gloo")
    got = np.load(os.path.join(data_dir, "rank0_step.npz"))
    one = runs[2]
    assert sorted(got.files) == sorted(one)
    for k in one:
        np.testing.assert_array_equal(got[k], one[k], err_msg=k)
