"""The comparison that decides `correct`: the reference agrees with the
program in float32; the bfloat16 program passes its limits; the float8
control fails one; and a run whose timed path is broken underneath comes
out not correct, for each fault the cell can have. Tiny configuration on
the CPU, with the limits of tests/data/limits/tiny.*.json (set from these
seeds' readings: the cells' own limits are set at the cells' sizes)."""
import contextlib

import pytest
import torch

from portbench.tests.common import run_tiny


@pytest.mark.parametrize("kind,bound", [("lam", 1e-4), ("msc", 1e-4),
                                        ("train", 5e-3)])
def test_reference_agrees_with_the_program_in_float32(kind, bound):
    rc, line, _ = run_tiny(kind, seed=21, config="tiny-fp32")
    assert rc == 0 and line["correct"]
    for name, c in line["checks"].items():
        if not name.startswith("label"):
            assert c["value"] <= bound, (name, c)
        else:
            assert c["value"] <= 1e-3, (name, c)


@pytest.mark.parametrize("kind", ["lam", "msc", "train"])
def test_bf16_program_passes_and_float8_control_fails(kind):
    rc, line, _ = run_tiny(kind, seed=21)
    assert rc == 0 and line["correct"], line["checks"]
    rc, ctl, _ = run_tiny(kind, seed=21, control="float8")
    assert rc == 0 and not ctl["correct"], ctl["checks"]


@contextlib.contextmanager
def _patched(module, name, make):
    original = getattr(module, name)
    setattr(module, name, make(original))
    try:
        yield
    finally:
        setattr(module, name, original)


def _answer_altered(kind):
    from excel_tpu_torch.engine import evaluate, train
    if kind == "train":
        from portbench.drivers import train as driver
        return _patched(train, "pseudo_labels", driver.altered)
    if kind == "lam":
        def make(fn):
            def broken(*a, **k):
                out = fn(*a, **k)
                q = out.shape[1] // 4      # every image's top quarter
                return torch.cat([(out[:, :q] + 1) % 6, out[:, q:]], dim=1)
            return broken
        return _patched(evaluate, "lam_eval_step", make)

    def make(fn):
        def broken(*a, **k):
            out = fn(*a, **k)
            return torch.cat([-out[:1], out[1:]])
        return broken
    return _patched(evaluate, "msc_accumulate", make)


def _half_batch(kind):
    from excel_tpu_torch.engine import evaluate, train
    if kind == "lam":
        def make(fn):
            def broken(params, images, cls, valid, *a, **k):
                h = images.shape[0] // 2
                out = fn(params, images[:h], cls[:h], valid[:h], *a, **k)
                return torch.cat([out, out])
            return broken
        return _patched(evaluate, "lam_eval_step", make)
    if kind == "msc":
        def make(fn):
            def broken(params, images, valid, text, cfg, canvas, acc,
                       keep_flip=True):
                h = images.shape[0] // 2
                part = fn(params, images[:h], valid[:h], text, cfg, canvas,
                          acc[:h] * 0, keep_flip=keep_flip)
                return acc + torch.cat([part, part])
            return broken
        return _patched(evaluate, "msc_accumulate", make)

    def make(fn):
        def broken(head, clip, images, cls, *a, **k):
            h = images.shape[0] // 2
            return fn(head, clip, images[:h], cls[:h], *a, **k)
        return broken
    return _patched(train, "train_losses", make)


def _state_unchanged(kind):
    from excel_tpu_torch.engine import train

    def make(fn):
        def broken(head, cfg):
            opt = fn(head, cfg)
            opt.step = lambda *a, **k: None
            return opt
        return broken
    return _patched(train, "make_optimizer", make)


FAULTS = [("lam", _answer_altered), ("lam", _half_batch),
          ("msc", _answer_altered), ("msc", _half_batch),
          ("train", _answer_altered), ("train", _half_batch),
          ("train", _state_unchanged)]


@pytest.mark.parametrize("kind,fault", FAULTS,
                         ids=[f"{k}-{f.__name__[1:]}" for k, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(kind, fault):
    with fault(kind):
        rc, line, _ = run_tiny(kind, seed=21)
    assert rc == 0 and not line["correct"], line["checks"]


def test_reference_guide_rounds_as_the_program_states():
    """Training's PAR guide floors x * std + mean, where one rounding
    moves a grey level: the reference forms it as the program states
    (engine/pipeline), over every byte value of each channel."""
    from excel_tpu_torch.engine.pipeline import (denormalize_images,
                                                 normalize_images)
    from portbench.reference import encoder, train

    v = torch.arange(256).float()[:, None].expand(256, 3)[None]
    assert torch.equal(encoder.normalize(v), normalize_images(v))
    assert torch.equal(train.denormalize(v),
                       denormalize_images(normalize_images(v)))
