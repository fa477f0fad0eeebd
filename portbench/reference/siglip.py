"""SigLIP So400m/14's towers: the surgery ViT with no CLS token, the
attention-pooling head over ExCEL's two streams, the training-free LAM step
and the text transformer.

Restates excel_tpu_torch/models/clip.py (`vision_forward` and `map_head`
of a SigLIP tower, `text_forward` with SigLIP's text config) and
models/layers.py (`mlp` with `activation="gelu_tanh"`) in float32, one
image at a time, as encoder.py does for OpenAI's ViT-B/16; everything else
is encoder.py's, pipeline.py's, svc.py's and par.py's, used as it is.

SigLIP's vision tower (arXiv 2303.15343; the So400m shape of arXiv
2305.13035; transformers' SiglipVisionTransformer with
google/siglip-so400m-patch14-384's config.json), x [N, C], the N tokens
the patches in row-major order:
  x = patch_conv(img) + b_patch + pos             (no CLS; pos [N, C])
  block: h = LN_1(x); q, k, v = h Wq + bq, h Wk + bk, h Wv + bv;
         x = x + (softmax(q k^T / sqrt D) v) Wo + bo;
         x = x + gelu_tanh(LN_2(x) W1 + b1) W2 + b2;
  gelu_tanh(u) = 0.5 u (1 + tanh(sqrt(2 / pi) (u + 0.044715 u^3)));
  post_layernorm, then the attention-pooling ("MAP") head: a probe [1, C]
  as the one query of an nn.MultiheadAttention (in_proj q|k|v, out_proj),
  then p + MLP(LN_head(p)). Every LayerNorm at eps 1e-6.

Departures from transformers' SiglipVisionTransformer, each the port's as
well:
- the last `surgery` blocks run ExCEL's dual-path attention
  (`surgery_attention`: encoder.py's mix of q q^T, k k^T and v v^T shared
  over heads; the LVC calibration over every token, there being no CLS
  row), and the dense stream skips the FFN; the feature stack repeats
  encoder.py's aliased views over the 729 tokens;
- `projected` has 1 + N rows: row 0 is the MAP head over
  LN_post(x_ori), the original stream's published image embedding, in
  the place that the CLS token of the original path takes in the other
  towers (feature surgery's class reweighting reads it); rows 1..N are
  the dense stream's tokens through the head's value path,
  (LN_post(x_dense)_t Wv + bv) Wo + bo and then + MLP(LN_head(.)): the
  head with token t as its only key, whose softmax over one key is 1
  (MaskCLIP's dense use of CLIP-ResNet's attention pool); the token-axis
  L2 norm is encoder.py's quirk, over all 1 + N rows;
- the image is resized to 378 px (27 x 14), not 384: the published
  convolution reads only the first 378 rows and columns of its input, so
  the grid, its 729 tokens and the positional table are the same, and
  ExCEL maps the grid onto the whole resized image; the table is resized
  half-pixel bilinear where the grid is not its own;
- the input is normalised as (x - 127.5) times the float32 reciprocal of
  127.5 (mean and std 0.5 of the 0-1 range), as encoder.normalize forms
  ImageNet's;
- no dropout.
The text tower (SiglipTextTransformer) as published: no attention mask
(SigLIP's text model has none), the last position pooled, LN_final at eps
1e-6, then its head, a Linear with bias.

`lam_image` is pipeline.lam_image over this encoder, and the names
`cams_from_state`, `label_gap` and `gap_summary` are pipeline.py's, so
that a driver can hand this module to lam_sweep's check in place of
pipeline.py.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import encoder as E
from .pipeline import (cams_from_state, class_ids, gap_summary,  # noqa: F401
                       label_gap, resize, upscale)
from .precision import FP32

EPS = 1e-6


def gelu_tanh(x):
    """gelu_pytorch_tanh: 0.5 x (1 + tanh(sqrt(2 / pi) (x + 0.044715
    x^3)))."""
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


def mlp(x, p, prec):
    return E.linear(gelu_tanh(E.linear(x, p["fc"], prec)), p["proj"], prec)


def normalize(image):
    """[H, W, 3] 0-255 -> (x - 127.5) * float32(1 / 127.5)."""
    return (image.float() - 127.5) * (1.0 / torch.tensor(
        127.5, device=image.device))


def pos_embedding(pos, side):
    """[S*S, C] table (no CLS row) resized to side x side (half-pixel
    bilinear; the cells only upsample or keep it)."""
    s = int(round(pos.shape[0] ** 0.5))
    if s == side:
        return pos.float()
    if side < s:
        raise NotImplementedError("downsampling the positional table "
                                  "antialiases; no cell needs it")
    grid = pos.float().reshape(s, s, -1).permute(2, 0, 1)[None]
    grid = F.interpolate(grid, size=(side, side), mode="bilinear",
                         align_corners=False)
    return grid[0].permute(1, 2, 0).reshape(side * side, -1)


def surgery_attention(y, p, heads, prec, ex_attn=None):
    """encoder.surgery_attention with the calibration over every token (no
    CLS row) -> (dense output, original output, head-summed weights)."""
    q, k, v = E._qkv(y, p, heads, prec)
    attn_ori = E._softmax_sim(q, k, prec)
    mix = (E._softmax_sim(q, q, prec) + E._softmax_sim(k, k, prec)
           + E._softmax_sim(v, v, prec)) / 3.0
    if ex_attn is not None:
        mix = mix + ex_attn[None]
    shared = mix.sum(0)
    dense = E.linear(E._merge(prec.mm(shared[None], v)), p["out"], prec)
    ori = E.linear(E._merge(prec.mm(attn_ori, v)), p["out"], prec)
    return dense, ori, attn_ori.sum(0)


def map_head(head, post_ori, post_dense, heads, prec, eps=EPS):
    """The MAP head over one image's two LN_post'd streams [N, C] ->
    [1 + N, C]: row 0 nn.MultiheadAttention(probe, post_ori, post_ori)
    then + MLP(LN(.)); rows 1..N each dense token's value path then the
    same."""
    c = post_ori.shape[-1]
    w, b = head["attn"]["qkv"]["w"].float(), head["attn"]["qkv"]["b"].float()
    q = prec.mm(head["probe"].float(), w[:c].t()) + b[:c]           # [1, C]
    k = prec.mm(post_ori, w[c:2 * c].t()) + b[c:2 * c]
    v = prec.mm(post_ori, w[2 * c:].t()) + b[2 * c:]
    qh, kh, vh = E._heads(q, heads), E._heads(k, heads), E._heads(v, heads)
    pooled = E._merge(prec.mm(E._softmax_sim(qh, kh, prec), vh))     # [1, C]
    v_dense = prec.mm(post_dense, w[2 * c:].t()) + b[2 * c:]
    e = E.linear(torch.cat([pooled, v_dense]), head["attn"]["out"], prec)
    return e + mlp(E.layer_norm(e, head["ln"], eps), head["mlp"], prec)


def vision_forward(visual, image, heads, surgery, window, prec=FP32,
                   eps=EPS, ex_attn=None, need_attn=True, stack=False):
    """One normalised image [H, W, 3] -> {"projected" [1 + N, C], "attn"
    [N, N] (the mean over the last `window` blocks of the head-mean
    (plain) or head-sum (surgery) weights) or None, "feats" [L, N,
    width]} (and "stack" [window, N, N] with stack). ex_attn: optional
    [N, N] calibration added to each surgery block's mix."""
    w = visual["patch_embed"].float()
    width, _, ps, _ = w.shape
    h, wd, _ = image.shape
    gh, gw = h // ps, wd // ps
    if gh != gw:
        raise NotImplementedError("the cells' images are square")
    patches = image[:gh * ps, :gw * ps].reshape(gh, ps, gw, ps, 3)
    patches = patches.permute(0, 2, 4, 1, 3).reshape(gh * gw, 3 * ps * ps)
    x = prec.mm(patches, w.reshape(width, -1).t()) \
        + visual["patch_bias"].float()
    x = x + pos_embedding(visual["positional_embedding"], gh)
    blocks = visual["blocks"]
    n_single = len(blocks) - surgery
    acc = None
    per_block = []
    single, ori_feats, ori_res = [], [], []
    x_ori = None
    for i, blk in enumerate(blocks):
        if i < n_single:
            y, wts = E.plain_attention(E.layer_norm(x, blk["ln_1"], eps),
                                       blk["attn"], heads, prec)
            x = x + y
            x = x + mlp(E.layer_norm(x, blk["ln_2"], eps), blk["mlp"], prec)
            single.append(x)
        else:
            src = x if x_ori is None else x_ori
            dense, ori, wts = surgery_attention(
                E.layer_norm(src, blk["ln_1"], eps), blk["attn"], heads,
                prec, ex_attn)
            x_ori = src + ori
            x_ori = x_ori + mlp(E.layer_norm(x_ori, blk["ln_2"], eps),
                                blk["mlp"], prec)
            x = x + dense
            ori_feats.append(x_ori)
            ori_res.append(ori)
        if need_attn and i >= len(blocks) - window:
            acc = wts if acc is None else acc + wts
            per_block.append(wts)
    feats = single[:-1] + [x]
    feats += [ori_feats[j] + ori_res[j + 1] for j in range(len(ori_feats) - 1)]
    feats.append(ori_feats[-1])
    post = visual["ln_post"]
    projected = map_head(visual["map_head"],
                         E.layer_norm(x if x_ori is None else x_ori, post,
                                      eps),
                         E.layer_norm(x, post, eps), heads, prec, eps)
    projected = projected / projected.norm(dim=0, keepdim=True)
    out = {"projected": projected,
           "attn": acc / window if need_attn else None,
           "feats": torch.stack(feats)}
    if stack:
        out["stack"] = torch.stack(per_block)
    return out


def lam_image(m, raw, cls, prec=FP32):
    """pipeline.lam_image over this encoder: raw [h, w, 3] uint8, cls
    [num_fg] {0, 1} -> {"lams", "attn" [N, N], "cams", "labels", "guide"}.
    The attention drives SVC whole: every row is a patch's."""
    h, w = raw.shape[:2]
    x = normalize(resize(raw, m["size"]))
    out = vision_forward(m["visual"], x, m["heads"], m["surgery"],
                         m["window"], prec, m["eps"])
    lam = E.lams(out["projected"], m["text"], m["num_fg"])
    present = torch.nonzero(cls > 0).flatten()
    guide = upscale(x.permute(2, 0, 1), (h, w), align=True)
    cams = cams_from_state(m, lam[:, present].t(), out["attn"], guide, prec)
    return {"lams": lam, "attn": out["attn"], "cams": cams,
            "labels": class_ids(present)[cams.argmax(dim=0)],
            "guide": guide}


def _attention(y, p, heads, prec):
    """Text self-attention with no mask (SigLIP's text model has none)."""
    q, k, v = E._qkv(y, p, heads, prec)
    ctx = prec.mm(E._softmax_sim(q, k, prec), v)
    return E.linear(E._merge(ctx), p["out"], prec)


def text_forward(text, tokens, heads, prec=FP32, eps=EPS):
    """One prompt's token ids [L] -> its embedding [embed_dim]: token and
    positional embeddings, pre-LN blocks without a mask, tanh-GELU MLPs,
    LN_final, the last position, the head (x @ text_projection + its
    bias)."""
    x = text["token_embedding"].float()[tokens.long()]
    x = x + text["positional_embedding"].float()
    for blk in text["blocks"]:
        x = x + _attention(E.layer_norm(x, blk["ln_1"], eps), blk["attn"],
                           heads, prec)
        x = x + mlp(E.layer_norm(x, blk["ln_2"], eps), blk["mlp"], prec)
    x = E.layer_norm(x, text["ln_final"], eps)
    return prec.mm(x[-1], text["text_projection"].float()) \
        + text["text_projection_bias"].float()
