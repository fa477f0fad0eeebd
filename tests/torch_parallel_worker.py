"""One rank of the port's data-parallel tests (tests/test_torch_parallel_*.py).

    python tests/torch_parallel_worker.py <job> <out_dir> [flags...]

started by `torch_parallel_common.run_ranks` with the environment torchrun
would give it. Jobs, each writing `<out_dir>/rank<r>_<job>.*`:
- step <backend|->: joins the group (a group of one with an explicit
  backend at world size 1) and runs `step_records` over out_dir's batch;
- replicate: `replicate` of a head and an AdamW state that differ by rank;
- sweeps <flags>: `run_lam_eval` (training-free, on-device CRF) and
  `run_validation` over this rank's shard of the flags' synthetic tree;
- cli <flags>: `infer_lam --training-free --crf-tpu` and `infer_seg`
  with SEG_FLAGS (`--head` among the flags) on the flags' tree, with the
  hists each run scores (summed over the ranks) kept;
- train <flags>: `cli.train.main(flags)`, with the files each rank writes
  counted and the logged losses kept at full precision.

At world size 1 (no process group) a job is the one-process run that the
ranks' runs are held to.
"""
import logging
import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)

from torch_parallel_common import (SEG_FLAGS, flat_scores,  # noqa: E402
                                   step_records, write_json)


def _args(flags):
    import argparse

    from excel_tpu_torch.cli.common import add_common_args

    ap = argparse.ArgumentParser()
    add_common_args(ap)
    return ap.parse_args(flags)


def job_step(out_dir: str, backend: str) -> dict:
    from excel_tpu_torch.parallel import initialize

    assert initialize("cpu", None if backend == "-" else backend)
    return step_records(out_dir)


def job_replicate() -> dict:
    """A head seeded by the rank and an AdamW state after one step on a
    rank-scaled gradient, flattened before and after `replicate`."""
    from excel_tpu_torch.config import tiny_config
    from excel_tpu_torch.models.head import init_head_params
    from excel_tpu_torch.parallel import initialize, replicate
    from excel_tpu_torch.parallel.distributed import rank

    assert initialize("cpu")
    cfg = tiny_config()
    head = init_head_params(cfg.head, cfg.num_classes,
                            torch.Generator().manual_seed(rank()), "cpu")
    opt = torch.optim.AdamW(head.parameters(), lr=1e-3)
    for p in head.parameters():
        p.grad = torch.full_like(p, rank() + 1.0)
    opt.step()

    def flat():
        state = [opt.state[p][k] for p in head.parameters()
                 for k in sorted(opt.state[p])]
        return {"params": torch.cat([p.detach().reshape(-1)
                                     for p in head.parameters()]).numpy(),
                "state": torch.cat([t.reshape(-1) for t in state]).numpy()}

    before = flat()
    replicate(head, opt)
    return {**flat(), **{"before_" + k: v for k, v in before.items()}}


def job_sweeps(flags) -> dict:
    from excel_tpu_torch.cli.common import eval_dataset, resolve
    from excel_tpu_torch.engine.evaluate import run_lam_eval, run_validation
    from excel_tpu_torch.models.excel import init_excel_params
    from excel_tpu_torch.parallel.distributed import shard_dataset

    cfg, clip, text = resolve(_args(flags))
    ds = shard_dataset(eval_dataset(cfg))
    lam, lam_crf = run_lam_eval({"clip": clip}, ds, text, cfg, batch_size=2,
                                crf_tpu=True, device="cpu")
    params = init_excel_params(cfg, clip, torch.Generator().manual_seed(0),
                               "cpu")
    pseudo, seg = run_validation(params, ds, text, cfg, batch_size=2,
                                 device="cpu")
    return {k: flat_scores(v) for k, v in (
        ("lam", lam), ("lam_crf", lam_crf), ("pseudo", pseudo),
        ("seg", seg))}


def job_cli(flags) -> dict:
    """The CLIs' scores, and the hists they were scored from (in the order
    scored: LAM, device CRF, seg, host CRF)."""
    from excel_tpu_torch.cli import common, infer_lam, infer_seg
    from excel_tpu_torch.engine import evaluate

    hists = []

    def keep(real):
        def scores(hist):
            hists.append(np.asarray(hist).tolist())
            return real(hist)
        return scores

    for mod in (evaluate, common):
        mod.scores_from_hist = keep(mod.scores_from_hist)
    lam, lam_crf = infer_lam.main(flags + ["--training-free", "--crf-tpu"])
    seg, seg_crf = infer_seg.main(flags + SEG_FLAGS)
    scores = {k: flat_scores(v) for k, v in (
        ("lam", lam), ("lam_crf", lam_crf), ("seg", seg),
        ("seg_crf", seg_crf))}
    return {"scores": scores, "hists": hists}


class _LossLines(logging.Handler):
    """(iteration, seg_loss, diver_loss) of each of the train CLI's loss
    lines, from the record's arguments (full precision, not the %.4f
    text)."""

    def __init__(self, out: list):
        super().__init__()
        self.out = out

    def emit(self, record):
        if record.msg.startswith("Iter:"):
            self.out.append([record.args[0], *record.args[-2:]])


def job_train(flags) -> dict:
    from excel_tpu_torch.cli import train
    from excel_tpu_torch.engine import checkpoint
    from excel_tpu_torch.utils import tb

    writes = {"checkpoint": 0, "head_npz": 0, "tb": 0}
    losses: list = []
    setup_logger = train.setup_logger

    def logger(*a, **k):
        out = setup_logger(*a, **k)
        out.addHandler(_LossLines(losses))
        return out

    def counted(key, fn):
        def wrapped(*a, **k):
            writes[key] += 1
            return fn(*a, **k)
        return wrapped

    checkpoint.torch.save = counted("checkpoint", torch.save)
    checkpoint.save_npz_tree = counted("head_npz", checkpoint.save_npz_tree)
    tb.SummaryWriter = counted("tb", tb.SummaryWriter)
    train.setup_logger = logger
    state = train.main(flags)
    head = torch.cat([p.detach().reshape(-1)
                      for p in state.head.parameters()]).numpy()
    return {"writes": writes, "step": state.step, "head": head.tolist(),
            "losses": losses}


def main() -> None:
    job, out_dir, rest = sys.argv[1], sys.argv[2], sys.argv[3:]
    rank = int(os.environ["RANK"])
    if job in ("step", "replicate"):
        out = job_step(out_dir, rest[0]) if job == "step" else job_replicate()
        np.savez(os.path.join(out_dir, f"rank{rank}_{job}.npz"), **out)
        return
    out = {"sweeps": job_sweeps, "cli": job_cli, "train": job_train}[job](
        rest)
    write_json(os.path.join(out_dir, f"rank{rank}_{job}.json"), out)
    print(f"rank {rank} {job} done", flush=True)


if __name__ == "__main__":
    main()
