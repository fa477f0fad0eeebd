"""The port's sharded eval sweeps and eval CLIs on the CPU: 2 gloo ranks,
each over its round-robin shard of a synthetic tree, with the hists summed
over the ranks before scoring, give one process's scores bit for bit
(`run_lam_eval` with the on-device CRF, `infer_lam --training-free
--crf-tpu`, `infer_seg --head --crf-tpu --crf` with the host CRF's
reduced hist), from the same summed hists, which carry information (a
nonzero diagonal). `run_validation` takes attn_pred's mean over each batch,
which sharding regroups: its 2-rank scores are those of the summed hists
of one process run on each shard."""
import argparse
import os

import numpy as np
import pytest
import torch

from excel_tpu_torch.cli.common import add_common_args, eval_dataset, resolve
from excel_tpu_torch.config import tiny_config
from excel_tpu_torch.engine import evaluate as pev
from excel_tpu_torch.engine.checkpoint import save_head_npz
from excel_tpu_torch.models.excel import init_excel_params
from excel_tpu_torch.models.head import init_head_params
from excel_tpu_torch.parallel.distributed import shard_dataset
from excel_tpu_torch.utils.metrics import scores_from_hist
from torch_parallel_common import flat_scores, read_json, run_ranks

# the ranks run one thread each; so does this process
torch.set_num_threads(1)

FLAGS = ["--device", "cpu", "--tiny", "--random-init", "--synthetic", "8",
         "--batch-size", "2"]


def _parse(flags):
    ap = argparse.ArgumentParser()
    add_common_args(ap)
    return ap.parse_args(flags)


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    """(rank 0's and rank 1's scores, {"rank": ..., "one": work dir})."""
    out = str(tmp_path_factory.mktemp("parallel_sweeps"))
    work = os.path.join(out, "ranks")
    run_ranks(2, "sweeps", out, *FLAGS, "--work-dir", work)
    return [read_json(os.path.join(out, f"rank{r}_sweeps.json"))
            for r in range(2)], os.path.join(out, "one")


def test_sharded_lam_sweep_equals_one_process(sweeps):
    ranks, work = sweeps
    cfg, clip, text = resolve(_parse(FLAGS + ["--work-dir", work]))
    lam, lam_crf = pev.run_lam_eval({"clip": clip}, eval_dataset(cfg), text,
                                    cfg, batch_size=2, crf_tpu=True,
                                    device="cpu")
    for got in ranks:
        assert got["lam"] == flat_scores(lam)
        assert got["lam_crf"] == flat_scores(lam_crf)


def test_sharded_validation_equals_summed_shards(sweeps, monkeypatch):
    ranks, work = sweeps
    cfg, clip, text = resolve(_parse(FLAGS + ["--work-dir", work]))
    params = init_excel_params(cfg, clip, torch.Generator().manual_seed(0),
                               "cpu")
    monkeypatch.setattr(pev, "scores_from_hist", lambda h: h)
    hists = [pev.run_validation(params, shard_dataset(eval_dataset(cfg), r,
                                                      2),
                                text, cfg, batch_size=2, device="cpu")
             for r in range(2)]
    pseudo = scores_from_hist(hists[0][0] + hists[1][0])
    seg = scores_from_hist(hists[0][1] + hists[1][1])
    for got in ranks:
        assert got["pseudo"] == flat_scores(pseudo)
        assert got["seg"] == flat_scores(seg)


def test_sharded_eval_clis_equal_one_process(tmp_path):
    """infer_lam and infer_seg at 2 ranks (a shared work dir: the tree
    generated by rank 0, the spills of both shards side by side) against
    one process's runs, bit for bit, the host CRF's scores included: the
    hists each run scored are one process's hists, and those carry
    information (pixels on the diagonal, pAcc > 0), so that scores of
    hists with no hit cannot agree whatever the ranks summed."""
    cfg = tiny_config()
    head_npz = str(tmp_path / "head.npz")
    save_head_npz(head_npz, init_head_params(
        cfg.head, cfg.num_classes, torch.Generator().manual_seed(1), "cpu"))
    flags = FLAGS + ["--head", head_npz]
    for world, name in ((2, "ranks"), (1, "one")):
        d = tmp_path / name
        d.mkdir()
        run_ranks(world, "cli", str(d), *flags, "--work-dir", str(d))
    want = read_json(str(tmp_path / "one" / "rank0_cli.json"))
    assert len(want["hists"]) == 4
    for hist in want["hists"]:
        assert np.trace(np.array(hist)) > 0
    for scores in want["scores"].values():
        assert scores[0] > 0  # pAcc
    for r in range(2):
        got = read_json(str(tmp_path / "ranks" / f"rank{r}_cli.json"))
        assert got["hists"] == want["hists"], r
        assert got["scores"] == want["scores"], r
