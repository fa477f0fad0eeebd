"""The encoder MLP's fc bias add and activation (models/layers
`fc_act_fused`) on the CPU, where it computes its plain version: the same
bits as the bias add and `ACTIVATIONS[act]` of `mlp`, for QuickGELU and
exact GELU in fp32 and bf16; `models/clip.mlp` built on it gives
`layers.mlp`'s bits, and `vision_forward` keeps its bits; the towers call
`clip.mlp` once a block (EVA-02's SwiGLU blocks never), while the LVC
head's decoder keeps `layers.mlp` and trains through it. The kernel itself
(csrc/fc_act.cu) is held to these on the card in
tests/test_torch_kernels_gpu.py."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from excel_tpu_torch.config import tiny_config, with_backbone
from excel_tpu_torch.models import clip as clip_mod
from excel_tpu_torch.models import head as head_mod
from excel_tpu_torch.models import layers as L
from excel_tpu_torch.models.head import decoder_forward, init_head_params
from excel_tpu_torch.models.params import init_clip_params
from excel_tpu_torch.utils import profiling
from portbench.harness import weights as W
from torch_launches import launch_counters, spy

torch.set_num_threads(1)

DTYPES = [torch.float32, torch.bfloat16]
ACTS = ["quick_gelu", "gelu"]


@pytest.fixture(autouse=True)
def spans_off():
    profiling.enable(False)
    profiling.reset()
    yield
    profiling.enable(False)
    profiling.reset()


def _fc_params(c: int, hidden: int, seed: int = 0) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {"fc": {"w": torch.randn((hidden, c), generator=g) * c ** -0.5,
                   "b": 0.1 * torch.randn(hidden, generator=g)},
            "proj": {"w": torch.randn((c, hidden), generator=g)
                     * hidden ** -0.5,
                     "b": 0.1 * torch.randn(c, generator=g)}}


def _quick_gelu_chain(x):
    """QuickGELU as its eager ops: x 1.702 (rounded to x's type), negate,
    exp, + 1, reciprocal, x 1.0, x the input."""
    alpha = float(torch.tensor(1.702, dtype=x.dtype))
    return x * ((alpha * x).neg().exp().add(1.0).reciprocal() * 1.0)


@pytest.mark.parametrize("shape", [(2, 17, 64), (1, 5, 3072), (3, 4, 40)])
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("act", ACTS)
def test_wrapper_computes_the_bias_add_and_activation(act, dtype, shape):
    g = torch.Generator().manual_seed(2)
    u = (2.0 * torch.randn(shape, generator=g)).to(dtype)
    bias = 0.1 * torch.randn(shape[-1], generator=g)
    got = L.fc_act_fused(u, bias, act)
    z = u + bias.to(dtype)
    want = _quick_gelu_chain(z) if act == "quick_gelu" else \
        torch.nn.functional.gelu(z)
    assert got.dtype == dtype and got.shape == shape
    assert torch.equal(got, want)
    assert torch.equal(got, L.ACTIVATIONS[act](z))


@pytest.mark.parametrize("device,act,error", [
    ("meta", "quick_gelu", "device"), ("meta", "gelu", "device"),
    ("cpu", "relu", "activation"), ("meta", "swiglu", "activation")])
def test_wrapper_refuses_devices_without_the_kernel(device, act, error):
    u = torch.empty((2, 5, 256), device=device)
    with pytest.raises(ValueError, match=error):
        L.fc_act_fused(u, torch.empty(256, device=device), act)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("act", ACTS)
def test_clip_mlp_gives_layers_mlp_bits(act, dtype):
    p = _fc_params(48, 192)
    x = torch.randn((2, 9, 48),
                    generator=torch.Generator().manual_seed(3)).to(dtype)
    got = clip_mod.mlp(x, p, act)
    assert got.dtype == dtype
    assert torch.equal(got, L.mlp(x, p, act))


def _tower(name: str, dtype):
    """tiny ViT-B/16, or ViT-H/14 at its widths (16 heads of 80, MLP 5120,
    exact GELU) cut to 2 blocks, 1 of them surgery, on a 56-pixel image."""
    if name == "vitb16_tiny":
        clip = tiny_config().clip
    else:
        clip = dataclasses.replace(
            with_backbone(tiny_config(), "openclip-vit-h-14").clip,
            image_size=56, vision_layers=2, surgery_blocks=1)
    return dataclasses.replace(clip, compute_dtype=dtype)


@pytest.mark.parametrize("attn_mode", ["stack", "mean"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("tower", ["vitb16_tiny", "vith14_depth2"])
def test_vision_forward_keeps_its_bits(tower, dtype, attn_mode,
                                       monkeypatch):
    cfg = _tower(tower, dtype)
    params = W.clip_visual(cfg, 24, "cpu")
    images = torch.randn((2, cfg.image_size, cfg.image_size, 3),
                         generator=torch.Generator().manual_seed(5))
    with torch.inference_mode():
        got = clip_mod.vision_forward(params, images, cfg,
                                      attn_mode=attn_mode)
        monkeypatch.setattr(clip_mod, "mlp", L.mlp)
        want = clip_mod.vision_forward(params, images, cfg,
                                       attn_mode=attn_mode)
    for key in ("projected", "attn", "feats"):
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("tower", ["openai-vit-b-16", "openclip-vit-h-14",
                                   "eva02-clip-l-14-336"])
def test_block_mlp_calls_clip_mlp_once_a_block(tower, monkeypatch):
    """L calls of `clip.mlp` (and of `fc_act_fused` inside it) a vision
    pass, one more a text block; none in EVA-02's SwiGLU vision blocks,
    whose text tower keeps the plain MLP. On the CPU no launch is
    counted."""
    cfg = with_backbone(tiny_config(), tower, tiny=True).clip
    clip = init_clip_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    images = torch.zeros((1, cfg.image_size, cfg.image_size, 3))
    tokens = torch.zeros((2, cfg.context_length), dtype=torch.long)
    mlps = spy(monkeypatch, clip_mod, "mlp")
    fused = spy(monkeypatch, clip_mod, "fc_act_fused")
    profiling.enable(True)
    vision = 0 if cfg.block == "eva02" else cfg.vision_layers
    with torch.inference_mode():
        clip_mod.encode_image(clip, images, cfg, attn_mode="mean")
        assert (len(mlps), len(fused)) == (vision, vision)
        clip_mod.text_forward(clip, tokens, cfg)
    assert (len(mlps), len(fused)) == (vision + cfg.text_layers,) * 2
    assert all(args[2] == cfg.activation for args in mlps)
    assert launch_counters() == {}


def test_head_keeps_layers_mlp_and_trains_through_it(monkeypatch):
    """The LVC head's decoder calls `layers.mlp` once a layer and never the
    fused pass, and the loss's gradient reaches every fc weight."""
    cfg = tiny_config()
    head = init_head_params(cfg.head, cfg.num_classes,
                            torch.Generator().manual_seed(1), device="cpu")
    plain = spy(monkeypatch, head_mod, "mlp")
    fused = spy(monkeypatch, L, "fc_act_fused")
    x = torch.randn((2, 4, cfg.head.embedding_dim),
                    generator=torch.Generator().manual_seed(6))
    logits, _ = decoder_forward(head, x)
    logits.square().sum().backward()
    assert (len(plain), len(fused)) == (cfg.head.decoder_layers, 0)
    for blk in head.decoder:
        grad = blk["mlp"]["fc"]["w"].grad
        assert grad is not None and bool(grad.abs().sum() > 0)
