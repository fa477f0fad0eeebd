"""The encoder's qkv bias add and head split (models/layers
`qkv_heads_fused`) on the CPU, where it computes its plain version
`qkv_projection`: the same bits at head dims 32, 64 and 80; `vision_forward`
built on it gives the same bits as the forward built on `qkv_projection`;
it runs once a vision block, and the text tower and the head's decoder keep
`qkv_projection`; the attention wrappers' contexts still merge to the same
[B, N, C]. The kernel itself (csrc/qkv_heads.cu) and the kernels'
token-major contexts are held to these on the card in
tests/test_torch_kernels_gpu.py."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from excel_tpu_torch.config import tiny_config, with_backbone
from excel_tpu_torch.models import attention_kernels as ak
from excel_tpu_torch.models import clip as clip_mod
from excel_tpu_torch.models import layers as L
from excel_tpu_torch.models.head import decoder_forward, init_head_params
from excel_tpu_torch.models.params import init_clip_params
from excel_tpu_torch.utils import profiling
from portbench.harness import weights as W
from torch_launches import launch_counters, spy

torch.set_num_threads(1)

DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture(autouse=True)
def spans_off():
    profiling.enable(False)
    profiling.reset()
    yield
    profiling.enable(False)
    profiling.reset()


def _qkv_params(c: int, seed: int = 0) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {"qkv": {"w": torch.randn((3 * c, c), generator=g) * c ** -0.5,
                    "b": 0.1 * torch.randn(3 * c, generator=g)}}


@pytest.mark.parametrize("tokens", [1, 17, 197, 401])
@pytest.mark.parametrize("d", [32, 64, 80])
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_wrapper_computes_qkv_projection(dtype, d, tokens):
    heads = 3
    p = _qkv_params(heads * d)
    y = torch.randn((2, tokens, heads * d),
                    generator=torch.Generator().manual_seed(1)).to(dtype)
    got = L.qkv_heads_fused(y, p, heads)
    want = L.qkv_projection(y, p, heads)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == (2, heads, tokens, d)
        assert g.is_contiguous()
        assert torch.equal(g, w)


def test_wrapper_refuses_devices_without_the_kernel():
    y = torch.empty((2, 5, 192), device="meta")
    p = {"qkv": {"w": torch.empty((576, 192), device="meta"),
                 "b": torch.empty(576, device="meta")}}
    with pytest.raises(ValueError, match="device"):
        L.qkv_heads_fused(y, p, 3)


def _tower(name: str, dtype):
    """tiny ViT-B/16, or ViT-H/14 at its widths (16 heads of 80, MLP 5120)
    cut to 2 blocks, 1 of them surgery, on a 56-pixel image (17 tokens)."""
    if name == "vitb16_tiny":
        clip = tiny_config().clip
    else:
        clip = dataclasses.replace(
            with_backbone(tiny_config(), "openclip-vit-h-14").clip,
            image_size=56, vision_layers=2, surgery_blocks=1)
    return dataclasses.replace(clip, compute_dtype=dtype)


TOWERS = ["vitb16_tiny", "vith14_depth2"]
_WEIGHTS: dict = {}


def _visual(tower: str, cfg) -> dict:
    """The benchmark's seeded encoder weights, made once a tower and type."""
    key = (tower, cfg.compute_dtype)
    if key not in _WEIGHTS:
        _WEIGHTS[key] = W.clip_visual(cfg, 24, "cpu")
    return _WEIGHTS[key]


@pytest.mark.parametrize("attn_mode", ["stack", "mean"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("tower", TOWERS)
def test_vision_forward_keeps_its_bits(tower, dtype, attn_mode,
                                       monkeypatch):
    cfg = _tower(tower, dtype)
    params = _visual(tower, cfg)
    images = torch.randn((2, cfg.image_size, cfg.image_size, 3),
                         generator=torch.Generator().manual_seed(5))
    with torch.inference_mode():
        got = clip_mod.vision_forward(params, images, cfg,
                                      attn_mode=attn_mode)
        monkeypatch.setattr(L, "qkv_heads_fused", L.qkv_projection)
        want = clip_mod.vision_forward(params, images, cfg,
                                       attn_mode=attn_mode)
    for key in ("projected", "attn", "feats"):
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("tower", ["openai-vit-b-16", "openclip-vit-h-14"])
def test_qkv_heads_fused_runs_once_a_vision_block(tower, monkeypatch):
    """L calls a vision pass (its plain version inside each); the text
    tower and the LVC head's decoder call `qkv_projection` alone. On the
    CPU no launch is counted."""
    cfg = with_backbone(tiny_config(), tower, tiny=True)
    ccfg = cfg.clip
    clip = init_clip_params(ccfg, torch.Generator().manual_seed(0),
                            device="cpu")
    head = init_head_params(cfg.head, cfg.num_classes,
                            torch.Generator().manual_seed(1), device="cpu")
    images = torch.zeros((1, ccfg.image_size, ccfg.image_size, 3))
    tokens = torch.zeros((2, ccfg.context_length), dtype=torch.long)
    fused = spy(monkeypatch, L, "qkv_heads_fused")
    plain = spy(monkeypatch, L, "qkv_projection")
    profiling.enable(True)
    with torch.inference_mode():
        clip_mod.encode_image(clip, images, ccfg, attn_mode="mean")
        assert (len(fused), len(plain)) == (ccfg.vision_layers,) * 2
        clip_mod.text_forward(clip, tokens, ccfg)
        assert len(fused) == ccfg.vision_layers
        assert len(plain) == ccfg.vision_layers + ccfg.text_layers
        decoder_forward(head, torch.zeros((1, 4, cfg.head.embedding_dim)))
    assert len(fused) == ccfg.vision_layers
    assert len(plain) == (ccfg.vision_layers + ccfg.text_layers
                          + cfg.head.decoder_layers)
    assert launch_counters() == {}


def test_merge_heads_of_a_token_major_context_is_a_view():
    """The kernels' contexts are [B, H, N, D] views of a contiguous
    [B, N, H, D]: `merge_heads` of one is that buffer as [B, N, C], no
    copy; of a contiguous [B, H, N, D] it is the same values, copied."""
    t = torch.randn((2, 7, 3, 16))
    ctx = t.permute(0, 2, 1, 3)
    merged = L.merge_heads(ctx)
    assert merged.data_ptr() == t.data_ptr()
    assert torch.equal(merged, t.reshape(2, 7, 48))
    copied = L.merge_heads(ctx.contiguous())
    assert copied.data_ptr() != t.data_ptr()
    assert torch.equal(copied, merged)


@pytest.mark.parametrize("kind", ["plain", "surgery"])
def test_attention_wrappers_return_head_major_contexts(kind):
    """On the CPU the wrappers' contexts are their plain versions' [B, H,
    N, D], and `merge_heads` of them the [B, N, C] the out-projection
    reads."""
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn((2, 3, 9, 32), generator=g) for _ in range(3))
    if kind == "plain":
        ctx = ak.fused_plain_attention(q, k, v)[0]
        ref = ak.plain_attention_reference(q, k, v)[0]
    else:
        ctx = ak.fused_surgery_attention(q, k, v)[2]
        ref = ak.surgery_attention_reference(q, k, v)[2]
    assert ctx.shape == (2, 3, 9, 32)
    assert torch.equal(L.merge_heads(ctx),
                       ref.permute(0, 2, 1, 3).reshape(2, 9, 96))
