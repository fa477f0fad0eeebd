"""The encoder's residual add + LayerNorm wrappers (models/layers
`layer_norm_fused`, `add_layer_norm_fused`) on the CPU, where they compute
their plain versions: the same bits as `layer_norm` and as `x + y` then
`layer_norm`; `vision_forward` built on them gives the same bits as the
forward that ran each residual add and LayerNorm on its own; the wrappers
run 2L + 2 times a vision pass, and the text tower and the head's decoder
keep the plain `layer_norm`. The kernel itself
(csrc/layer_norm.cu) is held to these on the card in
tests/test_torch_kernels_gpu.py."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from excel_tpu_torch.config import tiny_config, voc_config, with_backbone
from excel_tpu_torch.models import clip as clip_mod
from excel_tpu_torch.models import layers as L
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


def _ln_params(c: int, seed: int = 0) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {"scale": 1.0 + 0.1 * torch.randn(c, generator=g),
            "bias": 0.1 * torch.randn(c, generator=g)}


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 17, 64), (3, 5, 160), (1, 4, 768)])
def test_wrappers_compute_their_plain_versions(shape, dtype):
    g = torch.Generator().manual_seed(1)
    x = (3.0 * torch.randn(shape, generator=g) + 0.5).to(dtype)
    y = torch.randn(shape, generator=g).to(dtype)
    p = _ln_params(shape[-1])
    assert torch.equal(L.layer_norm_fused(x, p), L.layer_norm(x, p))
    s, out = L.add_layer_norm_fused(x, y, p)
    assert s.dtype == out.dtype == dtype
    assert torch.equal(s, x + y)
    assert torch.equal(out, L.layer_norm(x + y, p))
    assert torch.equal(L.add_layer_norm_fused(x, y, p, eps=1e-3)[1],
                       L.layer_norm(x + y, p, eps=1e-3))


def test_wrappers_refuse_devices_without_the_kernel():
    x = torch.empty((2, 3, 64), device="meta")
    p = {"scale": torch.empty(64, device="meta"),
         "bias": torch.empty(64, device="meta")}
    with pytest.raises(ValueError, match="device"):
        L.layer_norm_fused(x, p)
    with pytest.raises(ValueError, match="device"):
        L.add_layer_norm_fused(x, x, p)


def _vision_forward_as_it_was(params, images, cfg, attn_mode):
    """models/clip.vision_forward as it was before the fused wrappers
    (without ex_feats): every residual add, then `layer_norm` on its own,
    each block's ln_1 and ln_2 taken from its own stream."""
    p = params["visual"]
    heads = cfg.vision_heads
    n_single = cfg.vision_layers - cfg.surgery_blocks
    x = clip_mod._patch_embed(images.to(cfg.compute_dtype),
                              p["patch_embed"].to(cfg.compute_dtype),
                              cfg.patch_size)
    b, gh, gw, c = x.shape
    x = x.reshape(b, gh * gw, c)
    x = torch.cat([p["class_embedding"].to(x.dtype).expand(b, 1, c), x],
                  dim=1)
    pos = clip_mod.interpolate_pos_embedding(p["positional_embedding"], gh)
    x = L.layer_norm(x + pos.to(x.dtype), p["ln_pre"])

    def block_mlp(z, blk):
        return L.mlp(L.layer_norm(z, blk["ln_2"]), blk["mlp"], cfg.activation)

    win_start = cfg.vision_layers - (cfg.attn_out_layers or cfg.vision_layers)
    attn_list, acc = [], None
    single_feats, ori_feats, ori_residuals = [], [], []
    x_ori = None
    for i, blk in enumerate(p["blocks"]):
        in_win = i >= win_start and attn_mode != "none"
        fused_acc = acc if attn_mode == "mean" and in_win else None
        if i < n_single:
            y, w = L.attention_fused(L.layer_norm(x, blk["ln_1"]),
                                     blk["attn"], heads, attn_acc=fused_acc,
                                     need_weights=in_win)
            x = x + y
            x = x + block_mlp(x, blk)
            single_feats.append(x)
        else:
            src = x if x_ori is None else x_ori
            dense_res, ori_res, w = L.surgery_attention_fused(
                L.layer_norm(src, blk["ln_1"]), blk["attn"], heads,
                attn_acc=fused_acc, need_attn=in_win)
            x_ori = src + ori_res
            x_ori = x_ori + block_mlp(x_ori, blk)
            x = x + dense_res
            ori_feats.append(x_ori)
            ori_residuals.append(ori_res)
        if in_win:
            if attn_mode == "mean":
                acc = w
            else:
                attn_list.append(w)
    if x_ori is not None:
        x = torch.cat([x_ori[:, :1], x[:, 1:]], dim=1)
    if ori_feats:
        feat_list = single_feats[:-1] + [x]
        for j in range(len(ori_feats) - 1):
            feat_list.append(ori_feats[j] + ori_residuals[j + 1])
        feat_list.append(ori_feats[-1])
    else:
        feat_list = single_feats
    x = L.layer_norm(x, p["ln_post"])
    if attn_mode == "none":
        attn = None
    elif attn_mode == "mean":
        attn = acc / (cfg.attn_out_layers or cfg.vision_layers)
    else:
        attn = torch.stack(attn_list, dim=0)
    return {"projected": torch.matmul(x, p["proj"].to(x.dtype)),
            "attn": attn, "feats": torch.stack(feat_list, dim=0)}


def _tower(name: str, dtype):
    """A tower's ClipConfig: tiny ViT-B/16, ViT-B/16 at its full widths on a
    48-pixel image (3 x 3 patches), or tiny ViT-H/14."""
    clip = {"vitb16_tiny": tiny_config().clip,
            "vitb16_full": dataclasses.replace(voc_config().clip,
                                              image_size=48),
            "vith14_tiny": with_backbone(tiny_config(), "openclip-vit-h-14",
                                         tiny=True).clip}[name]
    return dataclasses.replace(clip, compute_dtype=dtype)


TOWERS = ["vitb16_tiny", "vitb16_full", "vith14_tiny"]
_WEIGHTS: dict = {}


def _visual(tower: str, cfg) -> dict:
    """The benchmark's seeded encoder weights (LayerNorm affines drawn
    too), made once a tower and type."""
    key = (tower, cfg.compute_dtype)
    if key not in _WEIGHTS:
        _WEIGHTS[key] = W.clip_visual(cfg, 23, "cpu")
    return _WEIGHTS[key]


@pytest.mark.parametrize("attn_mode", ["stack", "mean", "none"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("tower", TOWERS)
def test_vision_forward_keeps_its_bits(tower, dtype, attn_mode):
    cfg = _tower(tower, dtype)
    params = _visual(tower, cfg)
    images = torch.randn((2, cfg.image_size, cfg.image_size, 3),
                         generator=torch.Generator().manual_seed(5))
    with torch.inference_mode():
        got = clip_mod.vision_forward(params, images, cfg,
                                      attn_mode=attn_mode)
        want = _vision_forward_as_it_was(params, images, cfg, attn_mode)
    for key in ("projected", "attn", "feats"):
        if want[key] is None:
            assert got[key] is None, key
        else:
            assert got[key].dtype == want[key].dtype, key
            assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("tower", TOWERS)
def test_ln_fused_counts_two_per_block_and_two_a_pass(tower, monkeypatch):
    """2L + 2 a vision pass: ln_pre, block 0's ln_1 and ln_post alone, and
    each block's ln_2 and the next block's ln_1 with the residual add; the
    text tower calls neither wrapper. On the CPU no launch is counted."""
    cfg = _tower(tower, torch.float32)
    clip = init_clip_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    images = torch.zeros((1, cfg.image_size, cfg.image_size, 3))
    tokens = torch.zeros((2, cfg.context_length), dtype=torch.long)
    plain = spy(monkeypatch, clip_mod, "layer_norm_fused")
    residual = spy(monkeypatch, clip_mod, "add_layer_norm_fused")
    profiling.enable(True)
    with torch.inference_mode():
        clip_mod.encode_image(clip, images, cfg, attn_mode="none")
        clip_mod.encode_image(clip, images, cfg, attn_mode="stack")
        assert (len(plain), len(residual)) == (
            2 * 3, 2 * (2 * cfg.vision_layers - 1))
        clip_mod.text_forward(clip, tokens, cfg)
    assert len(plain) + len(residual) == 2 * (2 * cfg.vision_layers + 2)
    assert launch_counters() == {}
