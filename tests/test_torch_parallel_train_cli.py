"""The port's train CLI at 2 gloo ranks on the CPU, on one shared work
dir: 3 steps with validation, then `--resume` to step 4. Both ranks log
the same loss lines (the global batch's losses, summed over the ranks) and
hold the same head, and those are one process's at the global batch of 4
(which takes the compacted class-slot step where the ranks take
`TrainStepCache.full`); rank 0 alone writes the checkpoints, the head
files, the TensorBoard events and the log file; the resumed run starts
from rank 0's checkpoint on both ranks."""
import glob
import os
import re

import numpy as np
import pytest

from torch_parallel_common import (GRAD_RTOL_OF_MAX, LOSS_RTOL, read_json,
                                   run_ranks)

FIRST, RESUMED = 3, 4
LOSS_LINE = re.compile(r"Iter: (\d+); .*?(LR: .*)$")


def _loss_lines(out: str) -> list:
    """(iteration, 'LR: ...; seg_loss: ..., diver_loss: ...') of each loss
    line (the clock fields dropped)."""
    return [m.groups() for m in map(LOSS_LINE.search, out.splitlines())
            if m]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"work": dir, "first"/"resumed": (per rank output, per rank
    record), "one": one process's record of the first run at B=4}."""
    root = tmp_path_factory.mktemp("parallel_train_cli")
    work = str(root / "work")
    flags = ["--device", "cpu", "--tiny", "--random-init", "--synthetic",
             "8", "--log-iters", "1", "--num-workers", "1"]
    first = ["--max-iters", str(FIRST), "--eval-iters", str(FIRST),
             "--tensorboard"]
    out = {"work": work}
    for name, world, extra in (
            ("first", 2, ["--work-dir", work, "--batch-size", "2", *first]),
            ("resumed", 2, ["--work-dir", work, "--batch-size", "2",
                            "--max-iters", str(RESUMED), "--resume",
                            "--no-eval"]),
            ("one", 1, ["--work-dir", str(root / "one_work"),
                        "--batch-size", "4", *first])):
        d = root / name
        d.mkdir()
        outs = run_ranks(world, "train", str(d), *flags, *extra)
        recs = [read_json(str(d / f"rank{r}_train.json"))
                for r in range(world)]
        out[name] = recs[0] if world == 1 else (outs, recs)
    return out


@pytest.mark.parametrize("run", ["first", "resumed"])
def test_ranks_log_the_same_losses_and_hold_one_head(runs, run):
    outs, recs = runs[run]
    lines = [_loss_lines(o) for o in outs]
    first = FIRST if run == "first" else RESUMED
    start = 0 if run == "first" else FIRST
    assert [int(i) for i, _ in lines[0]] == list(range(start + 1, first + 1))
    assert lines[0] == lines[1]
    assert recs[0]["step"] == recs[1]["step"] == first
    assert recs[0]["head"] == recs[1]["head"]


def test_ranks_match_one_process(runs):
    """The ranks' logged losses (full precision) and final head against
    one process's at the global batch: the same 3 steps, each rank's
    loss shares summed when logged."""
    one = runs["one"]
    for rec in runs["first"][1]:
        got, want = np.array(rec["losses"]), np.array(one["losses"])
        np.testing.assert_array_equal(got[:, 0], np.arange(1, FIRST + 1))
        np.testing.assert_array_equal(got[:, 0], want[:, 0])
        np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=LOSS_RTOL,
                                   atol=0)
        head, ref = np.array(rec["head"]), np.array(one["head"])
        assert (np.abs(head - ref).max()
                <= GRAD_RTOL_OF_MAX * np.abs(ref).max())


@pytest.mark.parametrize("run", ["first", "resumed"])
def test_rank_zero_alone_writes(runs, run):
    _, recs = runs[run]
    assert recs[1]["writes"] == {"checkpoint": 0, "head_npz": 0, "tb": 0}
    w = recs[0]["writes"]
    assert w["checkpoint"] == 1 and w["head_npz"] == 1
    assert w["tb"] == (1 if run == "first" else 0)


def test_files_and_resume(runs):
    work = runs["work"]
    assert sorted(os.listdir(os.path.join(work, "checkpoints"))) == [
        f"step_{FIRST}.pt", f"step_{RESUMED}.pt"]
    assert os.path.exists(os.path.join(work, f"head_{FIRST}.npz"))
    assert len(glob.glob(os.path.join(work, "tb", "events.*"))) == 1
    with open(os.path.join(work, "train.log")) as f:
        log = f.read()
    # one writer: each iteration's line once, one validation table
    for it in range(1, RESUMED + 1):
        assert len(re.findall(rf"Iter: {it};", log)) == 1, it
    assert log.count("val @") == 1
    for out in runs["resumed"][0]:
        assert f"(step {FIRST})" in out
