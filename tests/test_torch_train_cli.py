"""The port's train CLI (excel_tpu_torch.cli.train) against the JAX
package's (excel_tpu.cli.train) on the CPU: the tiny config on one 4-image
synthetic tree, the same CLIP weights file (written by the JAX package's
`save_params_npz`), the seeded --random-init text bank and the JAX CLI's
own initial head, 5 steps of batch 2 with a log every step, so that step 4
crosses `lvc_calibrate_iter`, then validation; then `--resume` to 7 steps
in both. Dropout is off on both sides (the config each CLI resolves is
patched; the two packages' dropout draws cannot agree).

As in tests/test_torch_train.py, each port step's pseudo-labels are
counted against the JAX step's own and then replaced by them (an ulp
upstream moves argmax ties of a random-weight model), so the losses, the
head and the validation compare on the same targets: the logged losses
within its LOSS_RTOL, the heads within its PARAM_ATOL under its Adam-noise
rule, the validation hists within tests/test_torch_cli.py's
MAX_DIFFERING_PIXELS. --tensorboard and --viz write their files."""
import argparse
import dataclasses
import glob
import os
import shutil

import jax
import numpy as np
import pytest
import torch

import excel_tpu.cli.train as jtrain
import excel_tpu.utils.tb as jtb
import excel_tpu_torch.cli.train as ptrain
import excel_tpu_torch.utils.tb as ptb
from excel_tpu.config import tiny_config
from excel_tpu.engine import evaluate as jev
from excel_tpu.engine import train as jtr
from excel_tpu.models.params import init_clip_params
from excel_tpu.models.params import save_params_npz as jax_save_params_npz
from excel_tpu_torch.cli.common import build_synthetic
from excel_tpu_torch.config import tiny_config as port_tiny_config
from excel_tpu_torch.data.png import read_png
from excel_tpu_torch.engine import evaluate as pev
from excel_tpu_torch.engine import train as ptr
from excel_tpu_torch.engine.checkpoint import load_head_npz
from test_torch_cli import MAX_DIFFERING_PIXELS
from test_torch_train import (ADAM_NOISE_GRAD, LOSS_RTOL, LR_RTOL,
                              MAX_DIFFERING_PSEUDO, MAX_EXCLUDED, PARAM_ATOL)
from torch_port_common import n, port_head

FIRST, RESUMED = 5, 7
# logged steps: every step of the first run, then the resumed run's mean
# of steps 6 and 7 (the port's float64 sum on the device against the JAX
# package's AverageMeter)
LOGGED = list(range(1, FIRST + 1)) + [RESUMED]


def _no_dropout(resolve):
    def resolved(args):
        cfg, clip, text = resolve(args)
        return dataclasses.replace(cfg, head=dataclasses.replace(
            cfg.head, dropout=0.0)), clip, text
    return resolved


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs' first and resumed runs: {package: {"scalars": [(tag,
    value, step)], "hists": [...], "work": dir}}, the differing
    pseudo-label pixels of each port step, and the head entries whose
    port-side gradient fell below ADAM_NOISE_GRAD in a step."""
    root = str(tmp_path_factory.mktemp("train_cli"))
    clip_npz = os.path.join(root, "clip.npz")
    jax_save_params_npz(clip_npz, init_clip_params(jax.random.PRNGKey(0),
                                                   tiny_config().clip))
    flags = ["--tiny", "--random-init", "--synthetic", "4", "--clip-params",
             clip_npz, "--batch-size", "2", "--log-iters", "1",
             "--eval-iters", str(FIRST), "--num-workers", "2"]
    out = {pkg: {"scalars": [], "hists": [],
                 "work": os.path.join(root, pkg)} for pkg in ("jax", "port")}
    recorded, differing, small, heads = [], [], {}, []

    def record(*args, **kwargs):
        labels = jax_pseudo(*args, **kwargs)
        jax.debug.callback(lambda x: recorded.append(np.asarray(x)), labels)
        return labels

    def replay(*args, **kwargs):
        own = port_pseudo(*args, **kwargs)
        ref = torch.from_numpy(recorded.pop(0).copy())
        differing.append(int((own != ref).sum()))
        return ref

    def port_step(*args, **kwargs):
        state, metrics = port_train_step(*args, **kwargs)
        for name, p in state.head.named_parameters():
            small[name] = small.get(name, False) | (
                n(p.grad).__abs__() < ADAM_NOISE_GRAD)
        return state, metrics

    def scalars(pkg, real):
        def add_scalar(self, tag, value, step):
            out[pkg]["scalars"].append((tag, float(value), int(step)))
            real(self, tag, value, step)
        return add_scalar

    def hists(pkg, real):
        def scores(h):
            out[pkg]["hists"].append(np.asarray(
                h.cpu() if isinstance(h, torch.Tensor) else h)
                .astype(np.int64))
            return real(h)
        return scores

    def jax_head(init):
        def initialised(*args):
            params = init(*args)
            heads.append(jax.device_get(params["head"]))
            return params
        return initialised

    def port_init(cfg, clip_params, generator, device):
        return {"clip": clip_params, "head": port_head(heads[0], cfg)}

    jax_pseudo, port_pseudo = jtr.pseudo_labels, ptr.pseudo_labels
    port_train_step = ptr.train_step
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrain, "resolve", _no_dropout(jtrain.resolve))
        mp.setattr(ptrain, "resolve", _no_dropout(ptrain.resolve))
        mp.setattr(jtr, "pseudo_labels", record)
        mp.setattr(ptr, "pseudo_labels", replay)
        mp.setattr(ptr, "train_step", port_step)
        mp.setattr(jtrain, "init_excel_params",
                   jax_head(jtrain.init_excel_params))
        mp.setattr(ptrain, "init_excel_params", port_init)
        mp.setattr(jtb.SummaryWriter, "add_scalar",
                   scalars("jax", jtb.SummaryWriter.add_scalar))
        mp.setattr(ptb.SummaryWriter, "add_scalar",
                   scalars("port", ptb.SummaryWriter.add_scalar))
        mp.setattr(jev, "scores_from_hist", hists("jax", jev.scores_from_hist))
        mp.setattr(pev, "scores_from_hist",
                   hists("port", pev.scores_from_hist))
        port_flags = flags + ["--device", "cpu", "--work-dir",
                              out["port"]["work"]]
        jax_flags = flags + ["--work-dir", out["jax"]["work"]]
        first = ["--max-iters", str(FIRST), "--tensorboard", "--viz"]
        # one log of the resumed steps' means
        resumed = ["--resume", "--max-iters", str(RESUMED), "--no-eval",
                   "--tensorboard", "--log-iters", str(RESUMED)]
        # the port writes the tree; the JAX CLI reuses a copy of it (its
        # completion marker names the same parameters)
        build_synthetic(argparse.Namespace(
            work_dir=out["port"]["work"], synthetic="4", tiny=True),
            port_tiny_config())
        shutil.copytree(os.path.join(out["port"]["work"], "synthetic_data"),
                        os.path.join(out["jax"]["work"], "synthetic_data"))
        # the JAX CLI runs first: its initial head is the port's
        jtrain.main(jax_flags + first)
        jtrain.main(jax_flags + resumed)
        assert len(recorded) == RESUMED
        ptrain.main(port_flags + first)
        ptrain.main(port_flags + resumed)
    assert not recorded
    return out, differing, small


def _series(scalars, tag):
    return {step: value for t, value, step in scalars if t == tag}


def test_logged_losses_match_jax(runs):
    """Every logged seg and diversity loss (steps 1-5, then the resumed
    run's mean of 6 and 7) and rate; each step's pseudo-labels within the
    bound."""
    out, differing, _ = runs
    assert len(differing) == RESUMED
    assert max(differing) <= MAX_DIFFERING_PSEUDO, differing
    for tag, rtol in (("train/seg_loss", LOSS_RTOL),
                      ("train/diver_loss", LOSS_RTOL), ("train/lr", LR_RTOL)):
        got = _series(out["port"]["scalars"], tag)
        ref = _series(out["jax"]["scalars"], tag)
        assert sorted(got) == sorted(ref) == LOGGED
        for step in ref:
            assert np.isfinite(got[step])
            np.testing.assert_allclose(got[step], ref[step], rtol=rtol,
                                       err_msg=f"{tag} @{step}")


@pytest.mark.parametrize("it", [FIRST, RESUMED])
def test_head_files_match_jax(runs, it):
    """head_5.npz after the first run and head_7.npz after the resumed one;
    entries whose port-side gradient fell below ADAM_NOISE_GRAD in some
    step are excluded, at most MAX_EXCLUDED of them."""
    out, _, small = runs
    cfg = tiny_config()
    paths = [os.path.join(out[p]["work"], f"head_{it}.npz")
             for p in ("port", "jax")]
    got, ref = (load_head_npz(p, cfg.head, cfg.num_classes, device="cpu")
                .state_dict() for p in paths)
    total = sum(m.size for m in small.values())
    assert sum(int(m.sum()) for m in small.values()) <= MAX_EXCLUDED * total
    for name, value in got.items():
        keep = ~small[name]
        np.testing.assert_allclose(n(value)[keep], n(ref[name])[keep],
                                   atol=PARAM_ATOL, rtol=0, err_msg=name)


def test_validation_hists_match_jax(runs):
    out, _, _ = runs
    got, ref = out["port"]["hists"], out["jax"]["hists"]
    assert len(got) == len(ref) == 2          # pseudo-labels, segmentation
    for g, r in zip(got, ref):
        assert g.sum() == r.sum() > 0
        assert np.abs(g - r).sum() // 2 <= MAX_DIFFERING_PIXELS


def test_checkpoints_tensorboard_and_viz_files(runs):
    """Checkpoints at steps 5 and 7; the resumed run started at step 5
    (its log at 7); the event files' scalars; the panels
    decode as image | pseudo-labels | segmentation."""
    from excel_tpu_torch.engine.checkpoint import latest_checkpoint

    out, _, _ = runs
    work = out["port"]["work"]
    assert latest_checkpoint(os.path.join(work, "checkpoints")).endswith(
        f"step_{RESUMED}.pt")
    assert os.path.exists(os.path.join(work, "checkpoints",
                                       f"step_{FIRST}.pt"))
    assert sorted(glob.glob(os.path.join(work, "head_*.npz"))) == [
        os.path.join(work, f"head_{i}.npz") for i in (FIRST, RESUMED)]
    steps = [s for t, _, s in out["port"]["scalars"] if t == "train/lr"]
    assert steps == LOGGED
    assert [t for t, _, _ in out["port"]["scalars"]
            if t.startswith("val/")] == ["val/pseudo_miou", "val/seg_miou"]
    # both runs' events (one file when both start in the same second),
    # every record's CRCs checked: per run a file_version event, per log 3
    # scalars; the first run's 2 validation scalars and 2 images
    from test_torch_tb import _records
    records = sum((_records(p) for p in glob.glob(
        os.path.join(work, "tb", "events.out.*"))), [])
    assert len(records) == 2 + 3 * len(LOGGED) + 2 + 2
    panels = sorted(glob.glob(os.path.join(work, "viz", "*.png")))
    assert len(panels) == 2                   # the first val batch of 2
    for path in panels:
        pixels, palette = read_png(path)
        assert palette is None and pixels.ndim == 3
        assert pixels.shape[1] % 3 == 0

