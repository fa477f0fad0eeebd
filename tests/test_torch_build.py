"""`build.launch`, the one launch path of the port's CUDA kernels, on the
CPU with a fake entry point in place of `build.load`: the entry point it
loads, the stream it passes, the error it raises, the launch it counts."""
from __future__ import annotations

import types

import pytest
import torch

from excel_tpu_torch import build
from excel_tpu_torch.utils import profiling

STREAM = 0x5EED


@pytest.fixture(autouse=True)
def spans_off():
    profiling.enable(False)
    profiling.reset()
    yield
    profiling.enable(False)
    profiling.reset()


@pytest.fixture
def fake(monkeypatch):
    """build.load replaced by a fake entry point that records each call and
    returns `fake.rc`; the current stream of every device is STREAM."""
    state = types.SimpleNamespace(rc=0, loads=[], calls=[], devices=[])

    def load(name, symbol):
        state.loads.append((name, symbol))

        def entry(*args):
            state.calls.append(args)
            return state.rc
        return entry

    def current_stream(device):
        state.devices.append(device)
        return types.SimpleNamespace(cuda_stream=STREAM)

    monkeypatch.setattr(build, "load", load)
    monkeypatch.setattr(build.torch.cuda, "current_stream", current_stream)
    return state


@pytest.mark.parametrize("name,symbol", [
    (name, symbol) for name, entries in build.ENTRY_POINTS.items()
    for symbol in entries])
def test_launch_loads_the_source_of_its_entry_point(fake, name, symbol):
    t = torch.zeros(3)
    build.launch(symbol, t, 1, 2.5, None)
    assert fake.loads == [(name, symbol)]
    assert fake.calls == [(1, 2.5, None, STREAM)]
    assert fake.devices == [t.device]


def test_launch_counts_only_while_profiling_is_on(fake):
    t = torch.zeros(1)
    build.launch("excel_layer_norm_bf16", t)
    profiling.enable(True)
    assert profiling.snapshot()["counters"] == {}
    build.launch("excel_layer_norm_bf16", t)
    build.launch("excel_layer_norm_bf16", t)
    build.launch("excel_par_affinity_direct_bf16", t, 7)
    assert profiling.snapshot()["counters"] == {
        "launch.excel_layer_norm_bf16": 2,
        "launch.excel_par_affinity_direct_bf16": 1}
    profiling.enable(False)
    build.launch("excel_layer_norm_bf16", t)
    assert profiling.snapshot()["counters"][
        "launch.excel_layer_norm_bf16"] == 2
    assert len(fake.calls) == 5


def test_launch_raises_with_the_entry_point_and_counts_nothing(fake):
    fake.rc = 700
    profiling.enable(True)
    with pytest.raises(RuntimeError,
                       match="excel_plain_attention_bf16 failed to launch: "
                             "cudaError_t 700"):
        build.launch("excel_plain_attention_bf16", torch.zeros(1), 4)
    assert fake.calls == [(4, STREAM)]
    assert profiling.snapshot()["counters"] == {}


def test_typed_names_both_entry_points_and_refuses_other_types():
    assert build.typed("excel_par_diffuse", torch.float32) == \
        "excel_par_diffuse_f32"
    assert build.typed("excel_par_diffuse", torch.bfloat16) == \
        "excel_par_diffuse_bf16"
    with pytest.raises(KeyError):
        build.typed("excel_par_diffuse", torch.float16)
    symbols = {s for entries in build.ENTRY_POINTS.values() for s in entries}
    for stem in ("excel_plain_attention", "excel_surgery_attention",
                 "excel_par_diffuse", "excel_pad_clamp", "excel_layer_norm",
                 "excel_qkv_heads"):
        for dtype in build.SUFFIX:
            assert build.typed(stem, dtype) in symbols


def test_an_unknown_entry_point_is_refused(fake):
    with pytest.raises(KeyError):
        build.launch("excel_no_such_kernel", torch.zeros(1))
    assert fake.loads == []
