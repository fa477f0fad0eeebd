"""The port's reference-style wrappers (scripts/torch/*.sh) on the CPU at
the tiny config: each runs with bash from a working directory that holds
assets/clip_vit_b16.npz (tiny weights written by the port's
`save_params_npz`), over a synthetic tree, exits 0 and writes what its CLI
writes when called in this process with the arguments the wrapper names
(the same files, the same bytes); and each names only the port's modules,
with the same positional arguments and flags as its scripts/*.sh
namesake, the module the port's counterpart of that one's."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from excel_tpu_torch.cli import infer_lam, infer_seg, train
from excel_tpu_torch.config import tiny_config
from excel_tpu_torch.engine.checkpoint import save_head_npz
from excel_tpu_torch.models.head import init_head_params
from excel_tpu_torch.models.params import init_clip_params, save_params_npz

# one thread here and in the wrappers' processes: the same sums
torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXTRA = ["--tiny", "--device", "cpu", "--random-init", "--synthetic", "4",
         "--batch-size", "2"]
# wrapper -> (its CLI, the arguments before the work dir's, the CLI's own
# flags the wrapper adds, extra arguments, the files compared)
CASES = {
    "run_train": (train, ["voc"], ["--dataset", "voc"],
                  ["--max-iters", "2", "--eval-iters", "2", "--log-iters",
                   "1"], ["head_2.npz"]),
    "infer_lam": (infer_lam, ["voc"], ["--dataset", "voc"],
                  ["--training-free", "--save-cam"],
                  [f"cams/synth_{i:06d}.png" for i in range(4)]),
    "infer_seg_voc": (infer_seg, [], ["--dataset", "voc"], ["--save-preds"],
                      [f"preds/synth_{i:06d}.png" for i in range(4)]),
    "infer_seg_coco": (infer_seg, [], ["--dataset", "coco"],
                       ["--save-preds"],
                       [f"preds/synth_{i:06d}.png" for i in range(4)]),
}


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """A working directory with the weights under assets/ and a head, and a
    PATH whose `python` is this interpreter."""
    work = tmp_path_factory.mktemp("wrappers")
    cfg = tiny_config()
    os.makedirs(work / "assets")
    save_params_npz(str(work / "assets" / "clip_vit_b16.npz"),
                    init_clip_params(cfg.clip, device="cpu"))
    save_head_npz(str(work / "head.npz"),
                  init_head_params(cfg.head, cfg.num_classes, device="cpu"))
    bin_dir = work / "bin"
    os.makedirs(bin_dir)
    with open(bin_dir / "python", "w") as f:
        f.write(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
    os.chmod(bin_dir / "python", 0o755)
    env = dict(os.environ, PATH=f"{bin_dir}{os.pathsep}{os.environ['PATH']}",
               PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    return work, env


def _read(path):
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", sorted(CASES))
def test_wrapper_runs_its_cli(workspace, name, monkeypatch):
    work, env = workspace
    cli, lead, flags, extra, files = CASES[name]
    runs = {}
    for how in ("wrapper", "in_process"):
        out = str(work / f"{name}_{how}")
        head = [str(work / "head.npz")] if name.startswith("infer_seg") \
            else []
        # the tree the run reads: the CLIs' synthetic tree in its work dir
        tree = os.path.join(out, "synthetic_data")
        if how == "wrapper":
            r = subprocess.run(
                ["bash", os.path.join(ROOT, "scripts", "torch", name + ".sh")]
                + lead + [tree, out] + head + EXTRA + extra, cwd=work,
                env=env, capture_output=True, text=True, timeout=240)
            assert r.returncode == 0, r.stderr[-3000:]
        else:
            monkeypatch.chdir(work)
            argv = flags + ["--data-root", tree, "--clip-params",
                            "assets/clip_vit_b16.npz", "--work-dir", out]
            argv += (["--head", head[0]] if head else []) + ["--fast"]
            cli.main(argv + EXTRA + extra)
        runs[how] = {f: _read(os.path.join(out, f)) for f in files}
    for f in files:
        got, want = runs["wrapper"][f], runs["in_process"][f]
        if isinstance(want, dict):
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got == want, f


def _exec_line(path):
    with open(path) as f:
        text = f.read().replace("\\\n", " ")
    assert "set -eu" in text
    line = next(ln for ln in text.splitlines() if ln.startswith("exec "))
    positional = re.findall(r"(\w+)=\$\{(\d):\?", text)
    return line.split(), positional


@pytest.mark.parametrize("name", sorted(CASES))
def test_wrapper_mirrors_the_jax_one_and_names_only_the_port(name):
    got, got_pos = _exec_line(os.path.join(ROOT, "scripts", "torch",
                                           name + ".sh"))
    want, want_pos = _exec_line(os.path.join(ROOT, "scripts", name + ".sh"))
    assert got_pos == want_pos and len(got_pos) == 3
    module = want[want.index("-m") + 1]
    assert module.startswith("excel_tpu.cli.")
    port = module.replace("excel_tpu.", "excel_tpu_torch.", 1)
    assert got == [port if w == module else w for w in want]
