"""utils.profiling's spans and counters inside the port, on the CPU: off
they leave nothing behind; on they nest as the layers do, their records
line up with the profiler's ranges on its own clock, the counters count
what they name, and the outputs are the same bits either way."""
from __future__ import annotations

import copy
import math

import numpy as np
import pytest
import torch

from excel_tpu_torch.config import tiny_config
from excel_tpu_torch.engine import evaluate, train
from excel_tpu_torch.models import clip as clip_mod
from excel_tpu_torch.models.head import init_head_params
from excel_tpu_torch.models.params import init_clip_params
from excel_tpu_torch.ops import affinity
from excel_tpu_torch.ops.par import fill_counts
from excel_tpu_torch.utils import profiling
from torch_launches import launch_counters, spy

torch.set_num_threads(1)

# (h, w, present classes) of the sweep's samples: one canvas bucket
# (64 x 128) and one class-slot bucket (2), so batch 2 gives a full batch
# and one with a blank remainder
SAMPLES = ((40, 56, (0,)), (50, 60, (1, 3)), (33, 100, (2,)))


@pytest.fixture(autouse=True)
def spans_off():
    profiling.enable(False)
    profiling.reset()
    yield
    profiling.enable(False)
    profiling.reset()


@pytest.fixture(scope="module")
def model():
    cfg = tiny_config()
    g = torch.Generator().manual_seed(0)
    params = {"clip": init_clip_params(cfg.clip, g, device="cpu")}
    text = torch.randn(cfg.num_fg + 3, cfg.clip.embed_dim, generator=g)
    text = text / text.norm(dim=-1, keepdim=True)
    return cfg, params, text


def _dataset(cfg):
    rng = np.random.default_rng(0)
    out = []
    for i, (h, w, classes) in enumerate(SAMPLES):
        cls = np.zeros(cfg.num_fg, np.float32)
        cls[list(classes)] = 1.0
        label = rng.choice(np.asarray((0,) + tuple(c + 1 for c in classes)),
                           (h, w)).astype(np.int32)
        out.append({"name": f"s{i}", "cls_label": cls, "label": label,
                    "image": rng.integers(0, 256, (h, w, 3), np.uint8)})
    return out


def _sweep(model):
    cfg, params, text = model
    return evaluate.run_lam_eval(params, _dataset(cfg), text, cfg,
                                 batch_size=2, device="cpu")


def _train_state(cfg):
    head = init_head_params(cfg.head, cfg.num_classes,
                            torch.Generator().manual_seed(1), device="cpu")
    return train.init_train_state(head, cfg.train)


def _train_inputs(cfg, b=2):
    rng = np.random.default_rng(1)
    s = cfg.data.crop_size
    images = torch.from_numpy(rng.integers(0, 256, (b, s, s, 3), np.uint8))
    cls = np.zeros((b, cfg.num_fg), np.float32)
    cls[0, 1] = cls[1, 0] = cls[1, 4] = 1.0
    return images, cls


def _train_step(model, state):
    """One calibrated step through the step cache."""
    cfg, params, text = model
    images, cls = _train_inputs(cfg)
    step = train.TrainStepCache(cfg)((True, False), cls)
    state.step = cfg.train.lvc_calibrate_iter
    return step(state, params["clip"], images, torch.from_numpy(cls), text,
                None)


def _ancestors(recs, r) -> list:
    out = []
    while r.parent >= 0:
        r = recs[r.parent]
        out.append(r.name)
    return out


def _excel_ranges(prof) -> list:
    return [e for e in prof.profiler.kineto_results.events()
            if e.name().startswith("excel.")]


def test_off_leaves_nothing(model):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _sweep(model)
        _train_step(model, _train_state(model[0]))
    assert _excel_ranges(prof) == []
    assert profiling.records() == []
    snap = profiling.snapshot()
    assert snap == {"counters": {}, "spans": {}, "dropped": 0}


def test_sweep_spans_nest_as_the_layers(model):
    profiling.enable(True)
    _sweep(model)
    recs = profiling.records()
    snap = profiling.snapshot()
    names = {r.name for r in recs}
    assert {"read", "prep", "wait", "batch", "step", "encoder", "attn",
            "lams", "labels", "svc", "svc.propagate", "par",
            "hist"} <= names
    cfg = model[0]
    assert snap["spans"]["batch"]["count"] == 2
    assert snap["spans"]["attn"]["count"] == 2 * cfg.clip.vision_layers
    for r in recs:
        up = _ancestors(recs, r)
        if r.name == "svc.propagate":
            assert up[:4] == ["svc", "labels", "step", "batch"]
        elif r.name in ("encoder", "lams", "labels"):
            assert up[:2] == ["step", "batch"]
        elif r.name == "attn":
            assert up[:3] == ["encoder", "step", "batch"]
        elif r.name == "par":
            assert up[:3] == ["labels", "step", "batch"]
        elif r.name == "hist":
            assert up == ["batch"]
        elif r.name in ("read", "prep", "wait", "batch"):
            assert up == []
    assert [r.attrs for r in recs if r.name == "batch"] == [
        "batch=0 images=2", "batch=1 images=2"]
    for s in snap["spans"].values():
        assert 0.0 <= s["self_s"] <= s["total_s"]
    assert snap["counters"]["batches"] == 2
    assert snap["counters"]["images"] == 4
    assert snap["counters"]["svc.syncs"] >= 2
    assert snap["dropped"] == 0


def test_train_spans_nest_as_the_layers(model):
    profiling.enable(True)
    _train_step(model, _train_state(model[0]))
    recs = profiling.records()
    by_name = {}
    for r in recs:
        by_name.setdefault(r.name, []).append(r)
    (step,) = by_name["step"]
    assert step.attrs == f"images=2 step={model[0].train.lvc_calibrate_iter}"
    for name, chain in (("forward", ["step"]), ("backward", ["step"]),
                        ("optimizer", ["step"]),
                        ("calibrate", ["forward", "step"]),
                        ("head", ["forward", "step"]),
                        ("pseudo", ["forward", "step"]),
                        ("loss", ["forward", "step"]),
                        ("labels", ["pseudo", "forward", "step"]),
                        ("svc", ["labels", "pseudo", "forward", "step"]),
                        ("par", ["labels", "pseudo", "forward", "step"])):
        assert by_name[name], name
        for r in by_name[name]:
            assert _ancestors(recs, r) == chain, name
    # the first encoder pass is the forward's, the second the calibration's
    assert [_ancestors(recs, r)[0] for r in by_name["encoder"]] == [
        "forward", "calibrate"]
    snap = profiling.snapshot()
    assert snap["counters"]["steps"] == 1
    for s in snap["spans"].values():
        assert 0.0 <= s["self_s"] <= s["total_s"]


def test_ln_fused_counts_each_encoder_pass(model, monkeypatch):
    """The encoder's 2L + 2 LayerNorms (models/layers.layer_norm_fused and
    add_layer_norm_fused) a pass: one pass a sweep batch, two a calibrated
    train step (the forward's and the calibration's); the head's decoder
    adds none. On the CPU the profiling state counts no launch."""
    cfg = model[0]
    per_pass = 2 * cfg.clip.vision_layers + 2
    calls = (spy(monkeypatch, clip_mod, "layer_norm_fused"),
             spy(monkeypatch, clip_mod, "add_layer_norm_fused"))
    profiling.enable(True)
    _sweep(model)
    assert sum(map(len, calls)) == 2 * per_pass
    assert launch_counters() == {}
    for c in calls:
        c.clear()
    profiling.reset()
    _train_step(model, _train_state(cfg))
    assert sum(map(len, calls)) == 2 * per_pass
    assert launch_counters() == {}


def test_records_enclose_their_profiler_ranges(model):
    """The records' stamps are on the clock of the profiler's events: each
    record's [start, end] holds its range, within 1 ms. The profiler
    records the ranges of the thread that started it, not those of the
    sweep's prefetch thread (read, prep), which only the records keep."""
    import threading

    from torch.profiler import ProfilerActivity, profile

    profiling.enable(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _sweep(model)
        _train_step(model, _train_state(model[0]))
    ranges = _excel_ranges(prof)
    recs = profiling.records()
    assert {r.name for r in recs
            if r.thread != threading.get_ident()} == {"read", "prep"}
    recs = [r for r in recs if r.thread == threading.get_ident()]
    assert len(ranges) == len(recs) > 0
    by_name: dict = {}
    for e in sorted(ranges, key=lambda e: e.start_ns()):
        by_name.setdefault(e.name()[len("excel."):], []).append(e)
    for name, events in by_name.items():
        mine = sorted((r for r in recs if r.name == name),
                      key=lambda r: r.start_ns)
        assert len(mine) == len(events), name
        for r, e in zip(mine, events):
            assert r.start_ns <= e.start_ns() + 1_000_000
            assert r.end_ns >= e.start_ns() + e.duration_ns() - 1_000_000


def _snake(h: int, w: int, rows: int) -> torch.Tensor:
    """A one-pixel path through `rows` rows of a [1, h, w] mask, back and
    forth, joined at alternate ends."""
    m = torch.zeros((1, h, w), dtype=torch.bool)
    for i in range(rows):
        m[0, 2 * i] = True
        if i + 1 < rows:
            m[0, 2 * i + 1, w - 1 if i % 2 == 0 else 0] = True
    return m


def _sweeps_to_fixed_point(mask: torch.Tensor) -> int:
    """The sweeps of min-label propagation that change a label."""
    _, h, w = mask.shape
    big = h * w
    lab = torch.where(mask, torch.arange(big).reshape(1, h, w), big)
    k = 0
    while True:
        p = torch.nn.functional.pad(lab, (1, 1, 1, 1), value=big)
        nxt = torch.where(mask, torch.stack(
            [p[:, dy:dy + h, dx:dx + w] for dy in range(3)
             for dx in range(3)]).amin(dim=0), big)
        if torch.equal(nxt, lab):
            return k
        lab, k = nxt, k + 1


@pytest.mark.parametrize("h,w,rows", [(1, 1, 1), (1, 8, 1), (1, 9, 1),
                                      (1, 17, 1), (5, 6, 3), (7, 12, 4)])
def test_svc_syncs_one_per_fixed_point_test(h, w, rows):
    """One sync a test of the fixed point, a test every SWEEPS_PER_TEST
    sweeps: a mask whose labels settle in k sweeps takes ceil(k / 8) + 1
    tests, the last of them finding a group of sweeps that changed
    nothing."""
    mask = _snake(h, w, rows)
    k = _sweeps_to_fixed_point(mask)
    profiling.enable(True)
    affinity._propagate_labels(mask)
    per = affinity.SWEEPS_PER_TEST
    assert profiling.snapshot()["counters"]["svc.syncs"] == (
        math.ceil(k / per) + 1)


def test_par_fill_counts_by_hand(model):
    cls = np.zeros((3, 5), np.float32)
    cls[0, 1] = 1
    cls[1, [0, 2, 3]] = 1
    cls[2, 4] = 1
    refined, useful = fill_counts(cls, [(10, 20), (30, 40), (50, 60)],
                                  (64, 128), 5, [False, False, True])
    assert refined == 3 * 5 * 64 * 128
    assert useful == 2 * 10 * 20 + 4 * 30 * 40

    # the sweep: two batches of 2 on a 64 x 128 canvas, 1 + 2 slots; the
    # second batch's remainder is blank
    profiling.enable(True)
    _sweep(model)
    counters = profiling.snapshot()["counters"]
    assert counters["par.refined"] == 2 * 2 * 3 * 64 * 128
    assert counters["par.useful"] == sum(
        (1 + len(c)) * h * w for h, w, c in SAMPLES)

    # the train step: 2 crops of 64 x 64, the bucket of 4 slots
    profiling.reset()
    _train_step(model, _train_state(model[0]))
    counters = profiling.snapshot()["counters"]
    assert counters["par.refined"] == 2 * 5 * 64 * 64
    assert counters["par.useful"] == (2 + 3) * 64 * 64


def _hist(model):
    """The confusion hist of the sweep's first batch."""
    cfg, params, text = model
    samples = _dataset(cfg)[:2]
    canvas = evaluate._bucket_of(samples[0], cfg.data.eval_pad)
    images, cls, labels, valid = (torch.from_numpy(a) for a in
                                  evaluate._prep_batch(
                                      samples, cfg.clip.image_size, canvas))
    return evaluate.lam_eval_hist_step(
        evaluate.init_hist(cfg.num_classes, "cpu"), params, images, cls,
        labels, valid, text, cfg, canvas, class_slots=2)


def test_outputs_are_the_same_bits_on_and_off(model):
    cfg = model[0]
    runs = []
    for on in (False, True):
        profiling.enable(on)
        hist, scores = _hist(model), _sweep(model)
        state = _train_state(cfg)
        _, m = _train_step(model, state)
        runs.append((hist, scores, m,
                     copy.deepcopy(state.head.state_dict())))
    (hist0, s0, m0, h0), (hist1, s1, m1, h1) = runs
    assert hist0.sum() > 0 and torch.equal(hist0, hist1)
    np.testing.assert_equal(s0, s1)
    for k in ("loss", "seg_loss", "diver_loss"):
        assert torch.equal(m0[k], m1[k])
    assert h0.keys() == h1.keys()
    for k in h0:
        assert torch.equal(h0[k], h1[k]), k


def test_records_stop_at_the_bound(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_RECORDS", 3)
    profiling.enable(True)
    with profiling.span("outer", n=1):
        for _ in range(4):
            with profiling.span("inner"):
                pass
    snap = profiling.snapshot()
    assert snap["dropped"] == 2
    assert snap["spans"]["outer"]["count"] == 1
    assert snap["spans"]["inner"]["count"] == 2
    recs = profiling.records()
    assert [r.parent for r in recs] == [-1, 0, 0]
