"""Helpers of the tests that run the port's data-parallel paths in rank
processes (tests/test_torch_parallel_*.py): starting ranks as torchrun
would, and the runs that a rank and one process without a group both make.
Imports neither jax nor excel_tpu, so that the ranks start quickly."""
from __future__ import annotations

import dataclasses
import json
import math
import os
import socket
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_parallel_worker.py")
PHASES = [(False, False), (True, False), (True, True)]
# infer_seg's flags in the CLI runs: both CRFs, two scales
SEG_FLAGS = ["--crf-tpu", "--crf", "--scales", "1.0,0.75"]
# losses summed over the ranks against one process's: fp32 rounding of the
# same sums split in two
LOSS_RTOL = 1e-5
# gradients after the all_reduce (and heads after the update) against one
# process's, relative to the largest
GRAD_RTOL_OF_MAX = 1e-5
# a rank process at the tiny config takes a few seconds; a run of them
# that outlasts this has hung
RANK_TIMEOUT_S = 240


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def rank_env(rank: int, world: int, port: int) -> dict:
    """The environment torchrun gives rank `rank` of `world` on one host."""
    env = dict(os.environ)
    env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
               LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo",
               PYTHONPATH=os.pathsep.join([ROOT, HERE]))
    return env


def run_ranks(world: int, *args: str) -> list[str]:
    """Run `torch_parallel_worker.py *args` as ranks 0..world-1 of one
    group (at world 1: one process, no group); returns each rank's output
    after all exited with 0."""
    port = free_port()
    procs = [subprocess.Popen([sys.executable, WORKER, *args],
                              env=rank_env(r, world, port), cwd=ROOT,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-6000:]}"
    return outs


def cfg_with_dropout(cfg, rate: float):
    return dataclasses.replace(cfg, head=dataclasses.replace(
        cfg.head, dropout=rate))


def step_records(data_dir: str) -> dict:
    """One train step from the same head in each phase, with the tiny
    config's dropout and without dropout, on this rank's rows of the
    global batch in `data_dir` (the whole batch without a group):
    {"<rate>_<calibrated>_<seg_affinity>_<what>": array}, `what` the
    step's losses (total, seg, diversity; a rank's are its shares), the
    head's gradients after the step's reduction, and the head after the
    update, both flattened."""
    from excel_tpu_torch.config import tiny_config
    from excel_tpu_torch.engine.checkpoint import load_head_npz
    from excel_tpu_torch.engine.train import (init_train_state,
                                              step_generator, train_step)
    from excel_tpu_torch.models.params import load_params_npz
    from excel_tpu_torch.parallel import shard_local_batch

    base = tiny_config()
    clip = load_params_npz(os.path.join(data_dir, "clip.npz"), base.clip,
                           "cpu")
    with np.load(os.path.join(data_dir, "batch.npz")) as d:
        images, cls = shard_local_batch((d["images"], d["cls"]))
        text = torch.from_numpy(d["text"])
    images, cls = torch.from_numpy(images), torch.from_numpy(cls)
    out = {}
    for rate in (base.head.dropout, 0.0):
        cfg = cfg_with_dropout(base, rate)
        for cal, seg in PHASES:
            head = load_head_npz(os.path.join(data_dir, "head.npz"),
                                 cfg.head, cfg.num_classes, "cpu")
            state = init_train_state(head, cfg.train)
            gen = step_generator(cfg.train, 0, "cpu") if rate else None
            state, m = train_step(state, clip, images, cls, text, gen, cfg,
                                  calibrated=cal, seg_affinity=seg)
            key = f"{rate}_{int(cal)}_{int(seg)}"
            out[key + "_losses"] = np.array(
                [float(m[k]) for k in ("loss", "seg_loss", "diver_loss")])
            params = list(state.head.parameters())
            out[key + "_grads"] = torch.cat(
                [p.grad.reshape(-1) for p in params]).numpy()
            out[key + "_head"] = torch.cat(
                [p.detach().reshape(-1) for p in params]).numpy()
    return out


def flat_scores(scores: dict) -> list:
    """A scores dict as one list of floats (NaN as None, for JSON), in a
    fixed order: pAcc, mAcc, mIoU, then each per-class metric."""
    vals = [scores["pAcc"], scores["mAcc"], scores["miou"]]
    for m in ("iou", "confusion", "precision", "recall"):
        vals += [scores[m][c] for c in sorted(scores[m])]
    return [None if math.isnan(v) else float(v) for v in vals]


def write_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)


def read_json(path: str):
    with open(path) as f:
        return json.load(f)
