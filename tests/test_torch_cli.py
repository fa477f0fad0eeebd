"""The port's eval CLIs (excel_tpu_torch.cli.infer_lam, infer_seg,
rescore) on the CPU, tiny config, a 4-image synthetic tree (a 2-image one
for the host CRF's runs, held against `excel_tpu`'s post-pass), against the
JAX package's sweeps on the same tree with the same parameters: CLIP
weights written by the JAX package's `save_params_npz`, a head by its
`save_head_npz`, the seeded random text bank of --random-init. The JAX
side takes its config, parameters and text bank from its own
`cli.common.resolve` over the same flags, which finds the port's tree
through the shared completion marker."""
import argparse
import os

import jax
import numpy as np
import pytest
import torch

from excel_tpu.cli import common as jcommon
from excel_tpu.config import tiny_config
from excel_tpu.engine import evaluate as jev
from excel_tpu.engine.checkpoint import save_head_npz
from excel_tpu.models.params import init_clip_params, load_params_npz
from excel_tpu.models.params import save_params_npz as jax_save_params_npz
from excel_tpu_torch.cli import common, infer_lam, infer_seg, rescore
from excel_tpu_torch.engine import evaluate as pev
from excel_tpu_torch.models.params import save_params_npz
from torch_port_common import jax_clip_tree, jax_head_tree, port_params

# The bound of tests/test_torch_evaluate.py: SVC's uint8 truncation can turn
# a 1-ulp LAM difference into another box, and random weights tie classes
# over regions; at most this many pixels change class over the sweep.
MAX_DIFFERING_PIXELS = 20
SCALES = "1.0,0.5"


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(work dir, the flags both packages take, JAX CLIP params npz, JAX
    head npz)."""
    work = str(tmp_path_factory.mktemp("cli"))
    clip_npz = os.path.join(work, "clip.npz")
    jax_save_params_npz(clip_npz, init_clip_params(jax.random.PRNGKey(0),
                                                   tiny_config().clip))
    head_npz = os.path.join(work, "head.npz")
    save_head_npz(head_npz, jax_head_tree(tiny_config(), seed=1))
    flags = ["--tiny", "--random-init", "--synthetic", "4", "--work-dir",
             work, "--clip-params", clip_npz, "--batch-size", "2"]
    return work, flags, clip_npz, head_npz


def _capture(monkeypatch, module):
    """Record the hists `module.scores_from_hist` turns into scores."""
    hists = []
    real = module.scores_from_hist
    monkeypatch.setattr(module, "scores_from_hist",
                        lambda h: hists.append(np.asarray(
                            h.cpu() if isinstance(h, torch.Tensor) else h)
                            .astype(np.int64)) or real(h))
    return hists


def _jax_resolve(flags):
    ap = argparse.ArgumentParser()
    jcommon.add_common_args(ap)
    args = ap.parse_args(flags)
    cfg, clip, text = jcommon.resolve(args)
    return cfg, clip, text, jcommon.eval_dataset(cfg)


def _assert_hists_match(got, ref):
    assert got.sum() == ref.sum()
    assert np.abs(got - ref).sum() // 2 <= MAX_DIFFERING_PIXELS


def test_infer_lam_training_free_with_crf_matches_jax(run, monkeypatch):
    """--training-free --crf-tpu: the LAM hist and the CRF hist."""
    _, flags, _, _ = run
    hists = _capture(monkeypatch, pev)
    scores, crf = infer_lam.main(["--device", "cpu", "--training-free",
                                  "--crf-tpu"] + flags)
    assert len(hists) == 2 and np.isfinite(scores["miou"])
    jhists = _capture(monkeypatch, jev)
    cfg, clip, text, ds = _jax_resolve(flags)
    jev.run_lam_eval({"clip": clip}, ds, text, cfg, batch_size=2,
                     crf_tpu=True)
    total = sum(int((ds[i]["label"] != 255).sum()) for i in range(len(ds)))
    for got, ref in zip(hists, jhists):
        assert got.sum() == total
        _assert_hists_match(got, ref)


def test_infer_lam_trained_matches_jax(run, monkeypatch):
    """--head: the flip-fused calibrated LAMs of the trained mode."""
    _, flags, _, head_npz = run
    hists = _capture(monkeypatch, pev)
    infer_lam.main(["--device", "cpu", "--head", head_npz] + flags)
    jhists = _capture(monkeypatch, jev)
    cfg, clip, text, ds = _jax_resolve(flags)
    params = {"clip": clip, "head": jax_head_tree(tiny_config(), seed=1)}
    jev.run_lam_eval(params, ds, text, cfg, mode="trained", batch_size=2)
    _assert_hists_match(hists[0], jhists[0])


def test_infer_seg_matches_jax_and_rescore_equals_it(run, monkeypatch):
    """MSC + flip at two scales with the head, palette PNGs written; then
    rescore over those PNGs gives infer_seg's scores exactly."""
    work, flags, _, head_npz = run
    hists = _capture(monkeypatch, pev)
    scores = infer_seg.main(["--device", "cpu", "--head", head_npz,
                             "--scales", SCALES, "--save-preds"] + flags)
    jhists = _capture(monkeypatch, jev)
    cfg, clip, text, ds = _jax_resolve(flags)
    params = {"clip": clip, "head": jax_head_tree(tiny_config(), seed=1)}
    jev.run_msc_seg_eval(params, ds, text, cfg, scales=(1.0, 0.5),
                         batch_size=2)
    _assert_hists_match(hists[0], jhists[0])
    preds = sorted(os.listdir(os.path.join(work, "preds")))
    assert preds == [f"synth_{i:06d}.png" for i in range(4)]
    again = rescore.main(["--device", "cpu", "--pred-dir",
                          os.path.join(work, "preds")] + flags)
    assert again["miou"] == scores["miou"]
    assert again["pAcc"] == scores["pAcc"]
    assert again["iou"] == scores["iou"]


@pytest.mark.parametrize("cli,extra", [
    ("infer_lam", ["--crf-stream"]), ("infer_lam", ["--crf-workers", "2"]),
    ("infer_lam", ["--save-preds"]), ("infer_seg", ["--crf-stream"]),
    ("infer_seg", ["--crf-workers", "2"])])
def test_host_crf_flag_gates(run, cli, extra, capsys):
    """The host CRF's companion flags without --crf: both packages' CLIs
    exit 2 with the same message, before any weights are read."""
    import importlib

    _, flags, _, _ = run
    argv = ["--training-free"] * (cli == "infer_lam") + extra + flags
    errors = []
    for package in ("excel_tpu.cli", "excel_tpu_torch.cli"):
        main = importlib.import_module(f"{package}.{cli}").main
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert e.value.code == 2
        errors.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert "require --crf" in errors[0]
    assert errors[0].split("error: ")[1] == errors[1].split("error: ")[1]


@pytest.fixture(scope="module")
def run2(run, tmp_path_factory):
    """The flags of `run` on a 2-image tree of its own."""
    _, flags, clip_npz, head_npz = run
    work = str(tmp_path_factory.mktemp("cli_crf"))
    flags = list(flags)
    flags[flags.index("--synthetic") + 1] = "2"
    flags[flags.index("--work-dir") + 1] = work
    return work, flags, clip_npz, head_npz


def _jax_crf_hist(work, flags, subdir, kind):
    """excel_tpu's post-pass over the spill directory the port's CLI
    wrote, on the JAX package's own dataset of the same tree."""
    from excel_tpu.engine import crf_post as jpost

    cfg, _, _, ds = _jax_resolve(flags)
    return jpost.run_crf_post(ds, os.path.join(work, subdir),
                              jpost.crf_from_cfg(cfg.crf), cfg.num_classes,
                              kind=kind, num_workers=2)


def test_infer_seg_host_crf_post_and_streamed_match_jax(run2, monkeypatch):
    """infer_seg --crf and --crf --crf-stream: equal scores; excel_tpu's
    post-pass over the port CLI's logits/ gives its crf hist exactly; the
    _crf PNGs rescore to the same scores."""
    work, flags, _, head_npz = run2
    hists = _capture(monkeypatch, common)
    argv = ["--device", "cpu", "--head", head_npz, "--scales", "1.0",
            "--crf"] + flags
    raw, crf = infer_seg.main(argv + ["--save-preds"])
    raw_s, crf_s = infer_seg.main(argv + ["--crf-stream", "--crf-workers",
                                          "2"])
    np.testing.assert_equal(raw_s, raw)        # NaN (absent class) == NaN
    np.testing.assert_equal(crf_s, crf)
    np.testing.assert_array_equal(hists[0], hists[1])
    np.testing.assert_array_equal(hists[0],
                                  _jax_crf_hist(work, flags, "logits", "seg"))
    preds = sorted(os.listdir(os.path.join(work, "preds")))
    assert preds == [f"synth_{i:06d}{sfx}.png" for i in range(2)
                     for sfx in ("", "_crf")]
    again = rescore.main(["--device", "cpu", "--pred-dir",
                          os.path.join(work, "preds"), "--suffix", "_crf"]
                         + flags)
    np.testing.assert_equal(again, crf)


def test_infer_lam_host_crf_post_and_streamed_match_jax(run2, monkeypatch):
    """infer_lam --training-free --crf --save-preds, then with
    --crf-stream: equal scores; excel_tpu's post-pass over the port CLI's
    lam_logits/ gives its crf hist exactly; the crf_preds/ PNGs rescore to
    it."""
    work, flags, _, _ = run2
    hists = _capture(monkeypatch, common)
    argv = ["--device", "cpu", "--training-free", "--crf"] + flags
    lam, crf = infer_lam.main(argv + ["--save-preds"])
    lam_s, crf_s = infer_lam.main(argv + ["--crf-stream"])
    np.testing.assert_equal(lam_s, lam)
    np.testing.assert_equal(crf_s, crf)
    np.testing.assert_array_equal(hists[0], hists[1])
    np.testing.assert_array_equal(
        hists[0], _jax_crf_hist(work, flags, "lam_logits", "lam"))
    pred_dir = os.path.join(work, "crf_preds")
    assert sorted(os.listdir(pred_dir)) == [f"synth_{i:06d}.png"
                                            for i in range(2)]
    again = rescore.main(["--device", "cpu", "--pred-dir", pred_dir] + flags)
    np.testing.assert_equal(again, crf)


def test_clis_need_a_gpu_unless_cpu_is_asked(run):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    work, flags, _, _ = run
    for main, extra in ((infer_lam.main, ["--training-free"]),
                        (infer_seg.main, []),
                        (rescore.main, ["--pred-dir", work])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(extra + flags)


def test_save_params_npz_is_read_by_both_packages(run, tmp_path):
    """The port's `save_params_npz` writes the JAX package's file format:
    the JAX loader reads back the same arrays."""
    _, _, clip_npz, _ = run
    cfg = tiny_config().clip
    tree = jax_clip_tree(cfg, seed=0)
    path = str(tmp_path / "port.npz")
    save_params_npz(path, port_params(tree, cfg))
    back = jax.device_get(load_params_npz(path, cfg))
    ref = jax.device_get(load_params_npz(clip_npz, cfg))
    for a, b, c in zip(jax.tree_util.tree_leaves(back),
                       jax.tree_util.tree_leaves(tree),
                       jax.tree_util.tree_leaves(ref)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


@pytest.mark.slow
def test_jax_clis_run_on_the_ports_tree(run, monkeypatch):
    """The JAX package's own infer_lam and infer_seg on the tree the port
    wrote (the completion marker says the same parameters, so neither
    regenerates it): hists within the bound of the port's CLIs'. Slow: the
    JAX CLIs compile their sweeps' programs for every canvas and scale."""
    from excel_tpu.cli import infer_lam as jax_infer_lam
    from excel_tpu.cli import infer_seg as jax_infer_seg

    work, flags, _, head_npz = run
    marker = os.path.join(work, "synthetic_data", ".complete")
    hists = _capture(monkeypatch, pev)
    infer_lam.main(["--device", "cpu", "--training-free"] + flags)
    infer_seg.main(["--device", "cpu", "--head", head_npz, "--scales",
                    SCALES] + flags)
    stamp = os.stat(marker).st_mtime_ns
    jhists = _capture(monkeypatch, jev)
    jax_infer_lam.main(["--training-free"] + flags)
    jax_infer_seg.main(["--head", head_npz, "--scales", SCALES] + flags)
    assert os.stat(marker).st_mtime_ns == stamp
    for got, ref in zip(hists, jhists):
        _assert_hists_match(got, ref)
