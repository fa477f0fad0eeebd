"""OpenCLIP ViT-H/14 as the port's backbone, on the CPU: the port's towers
against the benchmark's plain float32 reference of OpenCLIP's
(portbench/reference/openclip.py), at a small ViT-H/14-shaped size (width
160 in 2 heads of 80, exact GELU, patch 14, grid 4: 56 px) on seeded random
weights; the attention kernels' plain versions at head dim 80; the named
backbone through config inference, the converter and a CLI; and the
OpenAI default's QuickGELU path bit for bit as it was.

Tolerances (relative to the largest magnitude of the compared output):
- float32, 1e-5: the same arithmetic summed in another order (the port
  batches images and heads, the reference takes one image and per-head
  products); the readings are <= 7e-7.
- bfloat16, 0.03: the port rounds every product, the residual stream and
  the activation to bfloat16 (2^-8 = 0.0039 a rounding) through 4 blocks;
  the readings are <= 0.0114.
The float32 comparison is the one that holds the activation: a tower with
QuickGELU in place of GELU reads 0.0046 on the same weights, 460 times the
float32 tolerance and under the bfloat16 one
(test_the_comparison_sees_the_activation).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from excel_tpu_torch import config as C
from excel_tpu_torch.config import tiny_config, with_backbone
from excel_tpu_torch.engine import evaluate
from excel_tpu_torch.models import clip as clip_mod
from excel_tpu_torch.models import layers
from excel_tpu_torch.models.excel import compute_lams
from excel_tpu_torch.models.params import init_clip_params
from portbench.harness import weights as W
from portbench.reference import encoder as E
from portbench.reference import openclip as R

torch.set_num_threads(1)

VITH = "openclip-vit-h-14"
TOL = {torch.float32: 1e-5, torch.bfloat16: 0.03}


def vith_tiny(dtype=torch.float32, **clip):
    cfg = with_backbone(tiny_config(), VITH, tiny=True)
    return dataclasses.replace(cfg, clip=dataclasses.replace(
        cfg.clip, compute_dtype=dtype, **clip))


def rel_err(got, ref) -> float:
    ref = ref.float()
    return float((got.float() - ref).abs().max() / ref.abs().max())


def images(b=2, size=56, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (b, size, size, 3), generator=g).float()


def test_tiny_preset_is_vit_h14_shaped():
    c = vith_tiny().clip
    assert (c.vision_width // c.vision_heads, c.patch_size, c.grid,
            c.activation) == (80, 14, 4, "gelu")
    full = with_backbone(C.fast(C.coco_config()), VITH)
    assert (full.clip.vision_width, full.clip.vision_heads,
            full.clip.vision_layers, full.clip.grid, full.clip.tokens,
            full.clip.embed_dim, full.clip.compute_dtype) == \
        (1280, 16, 32, 24, 577, 1024, torch.bfloat16)
    assert (full.head.in_channels, full.head.num_blocks, full.num_classes,
            full.data.crop_size) == (1280, 32, 81, 336)
    assert with_backbone(C.voc_config(), C.DEFAULT_BACKBONE) == \
        C.voc_config()
    with pytest.raises(ValueError, match="unknown backbone"):
        with_backbone(C.voc_config(), "vit-bigg-14")


@pytest.mark.parametrize("attn_mode", ["stack", "mean", "none"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_vision_forward_matches_reference(dtype, attn_mode):
    cfg = vith_tiny(dtype).clip
    params = W.clip_visual(cfg, 11, "cpu")
    x = E.normalize(images())
    out = clip_mod.vision_forward(params, x, cfg, attn_mode=attn_mode)
    for i in range(x.shape[0]):
        ref = R.vision_forward(params["visual"], x[i], cfg.vision_heads,
                               cfg.surgery_blocks, cfg.attn_out_layers,
                               act="gelu", stack=True)
        proj = out["projected"][i].float()
        assert rel_err(proj / proj.norm(dim=0, keepdim=True),
                       ref["projected"]) <= TOL[dtype]
        assert rel_err(out["feats"][:, i], ref["feats"]) <= TOL[dtype]
        if attn_mode == "stack":
            assert rel_err(out["attn"][:, i], ref["stack"]) <= TOL[dtype]
        elif attn_mode == "mean":
            assert rel_err(out["attn"][i], ref["attn"]) <= TOL[dtype]
        else:
            assert out["attn"] is None


def test_the_comparison_sees_the_activation():
    """The port's tower with QuickGELU against the GELU reference misses
    the float32 tolerance by far (0.0046), so the float32 comparisons hold
    the activation."""
    cfg = vith_tiny().clip
    params = W.clip_visual(cfg, 11, "cpu")
    x = E.normalize(images(b=1))
    quick = clip_mod.vision_forward(
        params, x, dataclasses.replace(cfg, activation="quick_gelu"),
        attn_mode="none")["feats"][:, 0]
    ref = R.vision_forward(params["visual"], x[0], cfg.vision_heads,
                           cfg.surgery_blocks, cfg.attn_out_layers)
    assert rel_err(quick, ref["feats"]) > 100 * TOL[torch.float32]


def _reference_numbers(cfg, params, text):
    return {"visual": params["visual"], "text": text,
            "size": cfg.clip.image_size, "patch": cfg.clip.patch_size,
            "heads": cfg.clip.vision_heads,
            "surgery": cfg.clip.surgery_blocks,
            "window": cfg.clip.attn_out_layers, "num_fg": cfg.num_fg,
            "caa": cfg.refine.caa_threshold,
            "dilations": tuple(cfg.refine.par_dilations),
            "iters": cfg.refine.par_iters,
            "activation": cfg.clip.activation}


@pytest.mark.parametrize("size", [56, 336], ids=["grid4", "grid24"])
def test_lams_and_hist_step_match_reference(size):
    """compute_lams and one training-free lam_eval_hist_step, at grid 4 and
    at ViT-H/14's grid 24 (336 px, 577 tokens: the patch-14 grid through
    the encoder, SVC and the labels): the LAMs within the float32
    tolerance, the hist within two pixels a differing label of the one
    from the reference's labels (none differ here; an ulp may decide a tie
    of two maps)."""
    cfg = vith_tiny(image_size=size)
    params = W.clip_visual(cfg.clip, 11, "cpu")
    text = W.text_bank(cfg.num_fg + 3, cfg.clip.embed_dim, 11, "cpu")
    img = images(size=size, seed=5)
    cls = torch.zeros(2, cfg.num_fg)
    cls[0, 1] = cls[1, 3] = cls[1, 4] = 1.0
    g = torch.Generator().manual_seed(6)
    gt = torch.randint(0, cfg.num_classes, (2, size, size), generator=g)
    valid = torch.tensor([[size, size]] * 2)
    out = clip_mod.encode_image(params, evaluate.normalize_images(img),
                                cfg.clip, attn_mode="mean")
    lams = compute_lams(out, text, cfg.num_fg)
    hist = evaluate.lam_eval_hist_step(
        torch.zeros((cfg.num_classes,) * 2, dtype=torch.int64),
        {"clip": params}, img, cls, gt, valid, text, cfg, (size, size))
    m = _reference_numbers(cfg, params, text)
    ref_hist = torch.zeros_like(hist)
    for i in range(2):
        ref = R.lam_image(m, img[i].to(torch.uint8), cls[i])
        assert rel_err(lams[i], ref["lams"]) <= TOL[torch.float32]
        ref_hist += torch.bincount(
            gt[i].flatten() * cfg.num_classes + ref["labels"].flatten(),
            minlength=cfg.num_classes ** 2).reshape(hist.shape)
    assert int(hist.sum()) == 2 * size * size
    assert int((hist - ref_hist).abs().sum()) <= 2 * 0.005 * hist.sum()


def test_text_forward_with_gelu_matches_reference():
    cfg = vith_tiny().clip
    params = init_clip_params(cfg, torch.Generator().manual_seed(1), "cpu")
    g = torch.Generator().manual_seed(0)
    tokens = torch.randint(1, cfg.vocab_size - 1, (3, cfg.context_length),
                           generator=g)
    tokens[:, 9] = cfg.vocab_size - 1           # the EOT id, the largest
    out = clip_mod.text_forward(params, tokens, cfg)
    for i in range(3):
        ref = R.text_forward(params["text"], tokens[i], cfg.text_heads,
                             act="gelu")
        assert rel_err(out[i], ref) <= TOL[torch.float32]


@pytest.mark.parametrize("mode", ["none", "out", "acc"])
def test_attention_plain_versions_at_head_dim_80(mode):
    """The encoder's attention layers on CPU tensors (the kernels' plain
    versions) with 2 heads of 80, against the reference's per-image
    attention: outputs and weights in every mode, surgery with ex."""
    cfg = vith_tiny().clip
    blk = W.clip_visual(cfg, 13, "cpu")["visual"]["blocks"][0]
    g = torch.Generator().manual_seed(2)
    b, n, c = 2, cfg.tokens, cfg.vision_width
    y = torch.randn((b, n, c), generator=g)
    acc = torch.rand((b, n, n), generator=g)
    ex = torch.rand((b, n - 1, n - 1), generator=g) / n
    kw = {"attn_acc": acc.clone() if mode == "acc" else None}
    out, w = layers.attention_fused(y, blk["attn"], cfg.vision_heads,
                                    need_weights=mode != "none", **kw)
    kw = {"attn_acc": acc.clone() if mode == "acc" else None}
    dense, ori, w_sum = layers.surgery_attention_fused(
        y, blk["attn"], cfg.vision_heads, ex_attn=ex,
        need_attn=mode != "none", **kw)
    base = acc if mode == "acc" else 0.0
    for i in range(b):
        r_out, r_w = E.plain_attention(y[i], blk["attn"], cfg.vision_heads,
                                       R.FP32)
        r_dense, r_ori, r_sum = E.surgery_attention(
            y[i], blk["attn"], cfg.vision_heads, R.FP32, ex[i])
        for got, ref in ((out[i], r_out), (dense[i], r_dense),
                         (ori[i], r_ori)):
            assert rel_err(got, ref) <= TOL[torch.float32]
        if mode == "none":
            assert w is None and w_sum is None
        else:
            b_i = base[i] if mode == "acc" else 0.0
            assert rel_err(w[i], r_w + b_i) <= TOL[torch.float32]
            assert rel_err(w_sum[i], r_sum + b_i) <= TOL[torch.float32]


def _vith_shapes() -> dict:
    """ViT-H/14's state dict as shapes (zero-stride arrays, no memory):
    the keys the config inference reads."""
    shapes = {"visual.conv1.weight": (1280, 3, 14, 14),
              "visual.positional_embedding": (257, 1280),
              "positional_embedding": (77, 1024),
              "text_projection": (1024, 1024),
              "token_embedding.weight": (49408, 1024)}
    sd = {k: np.broadcast_to(np.float32(0), s) for k, s in shapes.items()}
    for i in range(32):
        sd[f"visual.transformer.resblocks.{i}.ln_1.weight"] = np.empty(1)
    for i in range(24):
        sd[f"transformer.resblocks.{i}.ln_1.weight"] = np.empty(1)
    return sd


def test_infer_clip_config_takes_heads_from_the_named_backbone():
    from excel_tpu_torch.models.params import infer_clip_config

    sd = _vith_shapes()
    # OpenAI's rule reads the shapes as 20 heads of 64 and QuickGELU
    guessed = infer_clip_config(sd)
    assert (guessed.vision_heads, guessed.activation) == (20, "quick_gelu")
    got = infer_clip_config(sd, VITH)
    assert got == C.ClipConfig(**C.BACKBONES[VITH]["full"])
    assert (got.vision_heads, got.vision_width // got.vision_heads,
            got.text_heads, got.activation) == (16, 80, 16, "gelu")
    with pytest.raises(ValueError, match="not openai-vit-b-16"):
        infer_clip_config(sd, "openai-vit-b-16")
    del sd["visual.transformer.resblocks.31.ln_1.weight"]
    with pytest.raises(ValueError, match="vision_layers: 31"):
        infer_clip_config(sd, VITH)


def _openclip_state_dict(cfg, seed=0) -> dict:
    """An OpenCLIP-layout state dict of the port's seeded tree: OpenAI's
    keys, fused in_proj, the text tower's `attn_mask` buffer."""
    p = init_clip_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    sd = {}

    def ln(name, q):
        sd[name + ".weight"], sd[name + ".bias"] = q["scale"], q["bias"]

    def lin(name, q):
        sd[name + "weight"], sd[name + "bias"] = q["w"], q["b"]

    def block(prefix, q):
        ln(prefix + ".ln_1", q["ln_1"])
        lin(prefix + ".attn.in_proj_", q["attn"]["qkv"])
        lin(prefix + ".attn.out_proj.", q["attn"]["out"])
        ln(prefix + ".ln_2", q["ln_2"])
        lin(prefix + ".mlp.c_fc.", q["mlp"]["fc"])
        lin(prefix + ".mlp.c_proj.", q["mlp"]["proj"])

    v, t = p["visual"], p["text"]
    sd["visual.conv1.weight"] = v["patch_embed"]
    sd["visual.class_embedding"] = v["class_embedding"]
    sd["visual.positional_embedding"] = v["positional_embedding"]
    ln("visual.ln_pre", v["ln_pre"])
    for i, q in enumerate(v["blocks"]):
        block(f"visual.transformer.resblocks.{i}", q)
    ln("visual.ln_post", v["ln_post"])
    sd["visual.proj"] = v["proj"]
    sd["token_embedding.weight"] = t["token_embedding"]
    sd["positional_embedding"] = t["positional_embedding"]
    for i, q in enumerate(t["blocks"]):
        block(f"transformer.resblocks.{i}", q)
    ln("ln_final", t["ln_final"])
    sd["text_projection"] = t["text_projection"]
    sd["logit_scale"] = torch.tensor(4.6052)
    sd["attn_mask"] = torch.full((cfg.context_length,) * 2, -torch.inf)
    return p, sd


def test_convert_clip_with_a_named_backbone(tmp_path, monkeypatch):
    """convert_clip --backbone on an OpenCLIP-layout checkpoint: the named
    tower's heads and activation (the name's widths set to the tiny form
    here, so that the checkpoint stays small), the file read back equal to
    the seeded tree; a checkpoint of other widths is refused."""
    from excel_tpu_torch.cli import convert_clip
    from excel_tpu_torch.models.params import load_params_npz

    tiny = vith_tiny().clip
    full = {f.name: getattr(tiny, f.name)
            for f in dataclasses.fields(tiny) if f.name != "compute_dtype"}
    monkeypatch.setitem(C.BACKBONES, VITH, {"full": full, "tiny": {}})
    params, sd = _openclip_state_dict(tiny)
    src, dst = str(tmp_path / "vith.pt"), str(tmp_path / "vith.npz")
    torch.save(sd, src)
    cfg = convert_clip.main(["--backbone", VITH, src, dst])
    assert (cfg.vision_heads, cfg.activation) == (2, "gelu")
    back = load_params_npz(dst, cfg, device="cpu")
    for a, b in ((back["visual"]["blocks"][3]["mlp"]["fc"]["w"],
                  params["visual"]["blocks"][3]["mlp"]["fc"]["w"]),
                 (back["text"]["blocks"][1]["attn"]["qkv"]["b"],
                  params["text"]["blocks"][1]["attn"]["qkv"]["b"])):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="not openai-vit-b-16"):
        convert_clip.main(["--backbone", "openai-vit-b-16", src, dst])


def test_backbone_flag_through_infer_lam(tmp_path, monkeypatch):
    """infer_lam --tiny --random-init --backbone openclip-vit-h-14 runs the
    sweep on heads of 80 with exact GELU at 56 px."""
    from excel_tpu_torch.cli import infer_lam

    seen = {"d": set(), "act": set(), "size": set()}
    attention = layers.fused_plain_attention
    mlp = clip_mod.mlp

    def spy_attention(q, k, v, **kw):
        seen["d"].add(q.shape[-1])
        return attention(q, k, v, **kw)

    def spy_mlp(x, p, act="quick_gelu"):
        seen["act"].add(act)
        seen["size"].add(x.shape[1])
        return mlp(x, p, act)

    monkeypatch.setattr(layers, "fused_plain_attention", spy_attention)
    monkeypatch.setattr(clip_mod, "mlp", spy_mlp)
    scores = infer_lam.main([
        "--device", "cpu", "--tiny", "--random-init", "--synthetic", "4",
        "--training-free", "--backbone", VITH,
        "--work-dir", os.fspath(tmp_path)])
    assert seen == {"d": {80}, "act": {"gelu"}, "size": {4 * 4 + 1}}
    assert 0.0 <= scores["miou"] <= 1.0


def _quick_gelu_as_it_was(x):
    return x * (1.0 / (1.0 + torch.exp(-(layers._GELU_ALPHA[x.dtype] * x))))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_openai_default_keeps_quick_gelu_bit_for_bit(dtype, monkeypatch):
    """The OpenAI default (activation "quick_gelu") computes what the MLP
    computed before the activation became a field: `mlp` with its default
    and the tiny ViT-B tower give the same bits as with the old MLP in its
    place."""
    cfg = dataclasses.replace(tiny_config(), clip=dataclasses.replace(
        tiny_config().clip, compute_dtype=dtype)).clip
    assert cfg.activation == "quick_gelu"
    params = W.clip_visual(cfg, 17, "cpu")
    blk = params["visual"]["blocks"][0]["mlp"]
    x = torch.randn((2, 5, cfg.vision_width),
                    generator=torch.Generator().manual_seed(4)).to(dtype)
    old = layers.linear(_quick_gelu_as_it_was(layers.linear(x, blk["fc"])),
                        blk["proj"])
    assert torch.equal(layers.mlp(x, blk), old)
    xs = E.normalize(images(size=cfg.image_size))
    now = clip_mod.vision_forward(params, xs, cfg, attn_mode="mean")
    monkeypatch.setattr(clip_mod, "mlp", lambda y, p, act: layers.linear(
        _quick_gelu_as_it_was(layers.linear(y, p["fc"])), p["proj"]))
    before = clip_mod.vision_forward(params, xs, cfg, attn_mode="mean")
    for key in ("projected", "attn", "feats"):
        assert torch.equal(now[key], before[key])
