"""OpenCLIP's towers: the surgery ViT, its training-free LAM step and the
text transformer, with the MLP activation as a parameter.

Restates excel_tpu_torch/models/clip.py (`vision_forward`, `text_forward`)
and models/layers.py (`mlp` with `activation="gelu"`) in float32, one image
at a time, as encoder.py does for OpenAI's ViT-B/16; everything else is
encoder.py's, pipeline.py's, svc.py's and par.py's, used as it is. The
activation is `act`: "gelu", OpenCLIP's `nn.GELU()` (exact, erf), or
"quick_gelu" (encoder.py's). The head width is the width over `heads` (80
for ViT-H/14's 16 heads of width 1280), whatever it is.

Departures from OpenCLIP's `VisionTransformer` / `TextTransformer`
(src/open_clip/transformer.py, ViT-H-14.json), each the port's as well:
- the last `surgery` blocks run ExCEL's dual-path attention
  (encoder.surgery_attention), and the feature stack, the CLS token from
  the original path and the token-axis L2 norm are encoder.py's quirks;
- every token is projected (OpenCLIP pools the CLS token alone);
- the positional table is resized half-pixel bilinear from the
  pretraining grid (16) to the image's (24 at 336 px); OpenCLIP's
  `resize_pos_embed` resizes bicubic with antialiasing when weights load;
- no dropout, patch dropout or layer scale (ViT-H/14 sets none);
- text: the causal mask as -inf above the diagonal, pooled at the
  largest token id (OpenAI's EOT rule; OpenCLIP's `text_global_pool`
  takes the same argmax), projected by `text_projection`.

`lam_image` is pipeline.lam_image over this encoder, and the names
`cams_from_state`, `label_gap` and `gap_summary` are pipeline.py's, so
that a driver can hand this module to lam_sweep's check in place of
pipeline.py.
"""
from __future__ import annotations

import math

import torch

from . import encoder as E
from .pipeline import (cams_from_state, class_ids, gap_summary,  # noqa: F401
                       label_gap, resize, upscale)
from .precision import FP32


def gelu(x):
    """nn.GELU(): 0.5 x (1 + erf(x / sqrt 2))."""
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


ACTIVATIONS = {"gelu": gelu, "quick_gelu": E.quick_gelu}


def mlp(x, p, prec, act):
    return E.linear(ACTIVATIONS[act](E.linear(x, p["fc"], prec)), p["proj"],
                    prec)


def vision_forward(visual, image, heads, surgery, window, prec=FP32,
                   act="gelu", ex_attn=None, need_attn=True, stack=False):
    """encoder.vision_forward with the MLP activation `act`: one normalised
    image [H, W, 3] -> {"projected" [N, E], "attn" [N, N] or None, "feats"
    [L, N, width]} (and "stack" [window, N, N] with stack)."""
    w = visual["patch_embed"].float()
    width, _, ps, _ = w.shape
    h, wd, _ = image.shape
    gh, gw = h // ps, wd // ps
    patches = image[:gh * ps, :gw * ps].reshape(gh, ps, gw, ps, 3)
    patches = patches.permute(0, 2, 4, 1, 3).reshape(gh * gw, 3 * ps * ps)
    x = prec.mm(patches, w.reshape(width, -1).t())
    x = torch.cat([visual["class_embedding"].float()[None], x])
    x = x + E.pos_embedding(visual["positional_embedding"], gh)
    x = E.layer_norm(x, visual["ln_pre"])
    blocks = visual["blocks"]
    n_single = len(blocks) - surgery
    acc = None
    per_block = []
    single, ori_feats, ori_res = [], [], []
    x_ori = None
    for i, blk in enumerate(blocks):
        if i < n_single:
            y, wts = E.plain_attention(E.layer_norm(x, blk["ln_1"]),
                                       blk["attn"], heads, prec)
            x = x + y
            x = x + mlp(E.layer_norm(x, blk["ln_2"]), blk["mlp"], prec, act)
            single.append(x)
        else:
            src = x if x_ori is None else x_ori
            dense, ori, wts = E.surgery_attention(
                E.layer_norm(src, blk["ln_1"]), blk["attn"], heads, prec,
                ex_attn)
            x_ori = src + ori
            x_ori = x_ori + mlp(E.layer_norm(x_ori, blk["ln_2"]), blk["mlp"],
                                prec, act)
            x = x + dense
            ori_feats.append(x_ori)
            ori_res.append(ori)
        if need_attn and i >= len(blocks) - window:
            acc = wts if acc is None else acc + wts
            per_block.append(wts)
    if x_ori is not None:
        x = torch.cat([x_ori[:1], x[1:]])
    feats = single[:-1] + [x]
    feats += [ori_feats[j] + ori_res[j + 1] for j in range(len(ori_feats) - 1)]
    feats.append(ori_feats[-1])
    x = E.layer_norm(x, visual["ln_post"])
    projected = prec.mm(x, visual["proj"].float())
    projected = projected / projected.norm(dim=0, keepdim=True)
    out = {"projected": projected,
           "attn": acc / window if need_attn else None,
           "feats": torch.stack(feats)}
    if stack:
        out["stack"] = torch.stack(per_block)
    return out


def lam_image(m, raw, cls, prec=FP32):
    """pipeline.lam_image over this encoder, its activation m["activation"]:
    raw [h, w, 3] uint8, cls [num_fg] {0, 1} -> {"lams", "attn", "cams",
    "labels", "guide"}."""
    h, w = raw.shape[:2]
    x = E.normalize(resize(raw, m["size"]))
    out = vision_forward(m["visual"], x, m["heads"], m["surgery"],
                         m["window"], prec, m["activation"])
    lam = E.lams(out["projected"], m["text"], m["num_fg"])
    present = torch.nonzero(cls > 0).flatten()
    guide = upscale(x.permute(2, 0, 1), (h, w), align=True)
    cams = cams_from_state(m, lam[:, present].t(), out["attn"][1:, 1:],
                           guide, prec)
    return {"lams": lam, "attn": out["attn"], "cams": cams,
            "labels": class_ids(present)[cams.argmax(dim=0)],
            "guide": guide}


def _causal_attention(y, p, heads, prec):
    q, k, v = E._qkv(y, p, heads, prec)
    n = y.shape[0]
    logits = prec.mm(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    mask = torch.triu(torch.full((n, n), -torch.inf, device=y.device), 1)
    ctx = prec.mm(torch.softmax(logits + mask, dim=-1), v)
    return E.linear(E._merge(ctx), p["out"], prec)


def text_forward(text, tokens, heads, prec=FP32, act="gelu"):
    """One prompt's token ids [L] -> its embedding [embed_dim]: token and
    positional embeddings, pre-LN causal blocks with the MLP activation
    `act`, ln_final, the row at the largest id, text_projection."""
    x = text["token_embedding"].float()[tokens.long()]
    x = x + text["positional_embedding"].float()
    for blk in text["blocks"]:
        x = x + _causal_attention(E.layer_norm(x, blk["ln_1"]), blk["attn"],
                                  heads, prec)
        x = x + mlp(E.layer_norm(x, blk["ln_2"]), blk["mlp"], prec, act)
    x = E.layer_norm(x, text["ln_final"])
    return prec.mm(x[tokens.argmax()], text["text_projection"].float())
