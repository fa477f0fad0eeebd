"""Frozen CLIP ViT with ExCEL architecture surgery, and the CLIP text
transformer (counterpart of excel_tpu/models/clip.py): OpenAI's ViT-B/16 by
default, any tower of `config.BACKBONES` (OpenCLIP ViT-H/14: head dim 80,
exact GELU; EVA02-CLIP-L/14: rotary q/k and eps 1e-6 by its ClipConfig,
and the parts its parameter tree holds: sub-LayerNorms, SwiGLU, a patch
bias, a head with bias, no ln_pre; SigLIP So400m/14: head dim 72, tanh
GELU, no CLS token, the attention-pooling head `map_head` in place of the
projection, and its text tower: no mask, the last position, a head with
bias) by its ClipConfig. With `ex_feats` (the LVC head's fused features)
the surgery blocks' dense path is calibrated by their feature affinity, as
in the trained forward's second pass.

"Surgery" is a static property of the forward: the last
`cfg.surgery_blocks` blocks run the dual-path value-value attention. The
JAX package's effective behaviour is carried over, quirks included: the CLS
token from the original path, the per-block feature stack that replicates
the reference's aliased views, and the token-dim L2 norm of encode_image.

`cfg.compute_dtype` is float32 or bfloat16 (the fast preset). In bf16 the
JAX package's flow is kept: the patch embedding, the residual streams, the
projections (fp32 accumulation, rounded to bf16) and `projected` are bf16;
LayerNorm runs in fp32 and casts back (in the vision tower in one kernel
with the residual add before it: `layers.add_layer_norm_fused`); the
attention kernels keep their softmax and the fp32 head-mean accumulator of
the "mean" mode; each MLP's fc bias add and activation are one pass
(`mlp`: `layers.fc_act_fused`), in both towers.
"""
from __future__ import annotations

import torch

from ..config import ClipConfig
from ..ops.labels import scale_and_translate
from ..utils import profiling
from .layers import (ACTIVATIONS, _product, add_layer_norm_fused, attend,
                     attention_fused, external_feature_attention,
                     fc_act_fused, layer_norm, layer_norm_fused, linear,
                     merge_heads, multi_head_attention, rope_table,
                     split_heads, surgery_attention_fused, swiglu)


def interpolate_pos_embedding(pos: torch.Tensor, new_side: int,
                              cls_token: bool = True) -> torch.Tensor:
    """Resize the grid part of a [1+S*S, C] positional table (an [S*S, C]
    one without cls_token) as the JAX package does, with
    `jax.image.resize(..., "linear")`: half-pixel sampling, and
    antialiased when downsampling (a grid below the pretrained one, e.g.
    MSC scale 0.5): the triangle kernel is widened by 1 / scale and its
    weights renormalised where the table's edge cuts it.

    Upsampling equals torch's `F.interpolate(bilinear,
    align_corners=False)`, which the original torch implementation uses;
    downsampling does not, because `F.interpolate` does not antialias (at
    14 -> 10 the two differ by up to 1.11 on a standard-normal table). The
    port is held to the JAX package, so it antialiases."""
    start = 1 if cls_token else 0
    cls_tok, grid = pos[:start], pos[start:]
    side = int(round(float(grid.shape[0]) ** 0.5))
    c = grid.shape[-1]
    if side == new_side:
        return pos
    grid = grid.reshape(side, side, c).permute(2, 0, 1)[None]  # [1,C,S,S]
    scale = torch.full((1, 2), new_side / side, dtype=torch.float32,
                       device=pos.device)
    grid = scale_and_translate(grid, (new_side, new_side), scale,
                               torch.zeros_like(scale), antialias=True)
    return torch.cat([cls_tok, grid[0].permute(1, 2, 0).reshape(-1, c)],
                     dim=0)


def _patch_embed(images: torch.Tensor, w: torch.Tensor,
                 patch: int) -> torch.Tensor:
    """16x16 stride-16 convolution as an exact im2col product (no cuDNN, so
    no TF32) in the inputs' type: images [B, H, W, 3] NHWC, w [width, 3, P,
    P] -> [B, gh, gw, width]."""
    b, h, wd, c = images.shape
    gh, gw = h // patch, wd // patch
    x = images[:, :gh * patch, :gw * patch]
    x = x.reshape(b, gh, patch, gw, patch, c).permute(0, 1, 3, 5, 2, 4)
    x = x.reshape(b, gh, gw, c * patch * patch)
    return torch.matmul(x, w.reshape(w.shape[0], -1).t())


def mlp(x: torch.Tensor, p: dict, act: str) -> torch.Tensor:
    """`layers.mlp` as the towers run it: the fc product, its bias and
    the activation act in one pass (`fc_act_fused`: one kernel on the
    card), proj."""
    return linear(fc_act_fused(_product(x, p["fc"]), p["fc"]["b"], act),
                  p["proj"])


def _block_mlp(h: torch.Tensor, blk: dict, act: str,
               eps: float = 1e-5) -> torch.Tensor:
    """A block's MLP branch on h = ln_2 of its residual stream, inside the
    span "mlp": `mlp` with the activation act (attr act), or where the
    block's MLP holds a sub-LayerNorm `ln_ffn` EVA-02's `swiglu` (that
    LayerNorm at eps; attr act "swiglu")."""
    if "ln_ffn" in blk["mlp"]:
        with profiling.span("mlp", act="swiglu"):
            return swiglu(h, blk["mlp"], eps)
    with profiling.span("mlp", act=act):
        return mlp(h, blk["mlp"], act)


def _residual(x: torch.Tensor, y: torch.Tensor, ln: dict | None,
              eps: float = 1e-5):
    """The residual add x + y and, where a LayerNorm follows it (ln),
    that LayerNorm in the same kernel: (sum, normalised sum or None)."""
    if ln is None:
        return x + y, None
    return add_layer_norm_fused(x, y, ln, eps)


def _activation(cfg: ClipConfig) -> str:
    if cfg.activation not in ACTIVATIONS:
        raise ValueError(f"activation {cfg.activation!r}: the towers take "
                         f"{', '.join(ACTIVATIONS)}")
    return cfg.activation


def vision_forward(params: dict, images: torch.Tensor, cfg: ClipConfig,
                   ex_feats: torch.Tensor | None = None,
                   attn_mode: str = "stack", global_batch: bool = False):
    """Surgery ViT forward.

    images: [B, H, W, 3] (NHWC, already normalised).
    ex_feats: optional [B, C, h, w] LVC features; their
      `external_feature_attention`, rounded to the compute type as in the
      JAX package, is added to every surgery block's patch-patch mix
      (its mean over the process group's batch with global_batch).
    attn_mode:
      "stack" — attn = [L, B, N, N] per-block weights (head-mean for
                single-path blocks, head-sum for surgery blocks), L =
                cfg.attn_out_layers (or all);
      "mean"  — attn = [B, N, N] fp32, the mean over those L blocks,
                accumulated in place across blocks by the kernels;
      "none"  — attn = None.
    Returns {"projected": [B, N, embed_dim], "attn": see attn_mode,
             "feats": [L_all, B, N, width]}. N counts a CLS token where
    the tree holds one (`class_embedding`); without one (SigLIP) N is the
    patch grid's and `projected` has 1 + N rows, row 0 the attention-
    pooled embedding (`map_head`).
    """
    if attn_mode not in ("stack", "mean", "none"):
        raise ValueError(attn_mode)
    if attn_mode == "mean" and cfg.attn_out_layers is None:
        raise ValueError("attn_mode='mean' needs an explicit attn_out_layers "
                         "window")
    dtype = cfg.compute_dtype
    act = _activation(cfg)
    eps = cfg.ln_eps
    if dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f"compute_dtype {dtype}: the encoder runs "
                                  "in float32 or bfloat16")
    with profiling.span("encoder"):
        p = params["visual"]
        heads = cfg.vision_heads
        n_single = cfg.vision_layers - cfg.surgery_blocks

        x = _patch_embed(images.to(dtype), p["patch_embed"].to(dtype),
                         cfg.patch_size)
        if "patch_bias" in p:
            x = x + p["patch_bias"].to(x.dtype)
        b, gh, gw, c = x.shape
        x = x.reshape(b, gh * gw, c)
        has_cls = "class_embedding" in p
        if has_cls:
            cls = p["class_embedding"].to(x.dtype).expand(b, 1, c)
            x = torch.cat([cls, x], dim=1)
        pos = interpolate_pos_embedding(p["positional_embedding"], gh,
                                        has_cls)
        x = x + pos.to(x.dtype)
        if "ln_pre" in p:
            x = layer_norm_fused(x, p["ln_pre"], eps)
        rope = None
        if cfg.rope_grid:
            rope = rope_table(cfg.rope_grid, gh, gw, c // heads, x.device)

        ex_attn = None
        if ex_feats is not None:
            ex_attn = external_feature_attention(
                ex_feats, global_batch=global_batch).to(x.dtype)

        window = cfg.attn_out_layers or cfg.vision_layers
        win_start = cfg.vision_layers - window

        attn_list = []          # "stack": per-block weights
        attn_acc = None         # "mean": the kernels' in-place accumulator
        single_feats, ori_feats, ori_residuals = [], [], []
        x_ori = None
        blocks = p["blocks"]
        # h: ln_1 of the stream the block attends over, formed by the
        # previous block's last residual add (block 0: from x itself)
        h = layer_norm_fused(x, blocks[0]["ln_1"], eps)
        for i, blk in enumerate(blocks):
            in_win = i >= win_start and attn_mode != "none"
            fused_acc = attn_acc if attn_mode == "mean" and in_win else None
            ln_next = blocks[i + 1]["ln_1"] if i + 1 < len(blocks) else None
            if i < n_single:
                y, attn_w = attention_fused(h, blk["attn"], heads,
                                            attn_acc=fused_acc,
                                            need_weights=in_win, rope=rope,
                                            eps=eps)
                x, h = add_layer_norm_fused(x, y, blk["ln_2"], eps)
                x, h = _residual(x, _block_mlp(h, blk, act, eps), ln_next,
                                 eps)
                single_feats.append(x)
            else:
                # dual path: both streams attend over ln_1 of the ORIGINAL
                # stream (src)
                src = x if x_ori is None else x_ori
                dense_res, ori_res, attn_w = surgery_attention_fused(
                    h, blk["attn"], heads, ex_attn=ex_attn,
                    attn_acc=fused_acc, need_attn=in_win, rope=rope,
                    eps=eps)
                x_ori, h = add_layer_norm_fused(src, ori_res, blk["ln_2"],
                                                eps)
                x_ori, h = _residual(x_ori, _block_mlp(h, blk, act, eps),
                                     ln_next, eps)
                x = x + dense_res          # dense stream skips the FFN
                ori_feats.append(x_ori)
                ori_residuals.append(ori_res)
            if in_win:
                if attn_mode == "mean":
                    attn_acc = attn_w          # the kernel added the prior acc
                else:
                    attn_list.append(attn_w)

        # CLS token from the original path
        if x_ori is not None and has_cls:
            x = torch.cat([x_ori[:, :1], x[:, 1:]], dim=1)

        # per-block feature stack with the reference's effective values (its
        # appended views are mutated by later in-place updates):
        #   blocks 0..n_single-2: clean single-path outputs
        #   block  n_single-1:    the FINAL dense stream (CLS already swapped)
        #   surgery blocks i<last: x_ori after block i + block i+1's attention
        #                          residual (pre-MLP)
        #   last surgery block:   clean x_ori
        if ori_feats:
            feat_list = single_feats[:-1] + [x]
            for j in range(len(ori_feats) - 1):
                feat_list.append(ori_feats[j] + ori_residuals[j + 1])
            feat_list.append(ori_feats[-1])
        else:
            feat_list = single_feats

        if "map_head" in p:
            projected = map_head(p, x if x_ori is None else x_ori, x, heads,
                                 act, eps)
        else:
            x = layer_norm_fused(x, p["ln_post"], eps)
            projected = torch.matmul(x, p["proj"].to(x.dtype))
            if "proj_bias" in p:
                projected = projected + p["proj_bias"].to(x.dtype)

        if attn_mode == "none":
            attn_out = None
        elif attn_mode == "mean":
            attn_out = attn_acc / window
        else:
            attn_out = torch.stack(attn_list, dim=0)

        return {"projected": projected, "attn": attn_out,
                "feats": torch.stack(feat_list, dim=0)}


def map_head(p: dict, x_ori: torch.Tensor, x_dense: torch.Tensor,
             heads: int, act: str, eps: float) -> torch.Tensor:
    """SigLIP's attention-pooling ("MAP") head over ExCEL's two streams
    [B, N, C], inside the span "map_head" -> [B, 1 + N, C]. The head (p's
    `map_head`: a probe [1, C], an attention whose `qkv` is
    nn.MultiheadAttention's in_proj split q|k|v and `out` its out_proj, a
    LayerNorm `ln`, an MLP) gives z = e + mlp(ln(e)) of each row e of:
    - row 0: the probe's attention over LN_post(x_ori) (`attend`, the
      probe's q [1, H, 1, D] shared by the batch; the published image
      embedding of the original stream, in the CLS row's place);
    - rows 1..N: each token t of LN_post(x_dense) through the value path,
      (LN_post(x_dense)_t Wv + bv) Wo + bo: the head with t as its only
      key, whose softmax over one key is 1 (MaskCLIP's dense use of an
      attention pool).
    The out-projection, LayerNorm and MLP run once over all 1 + N rows."""
    h = p["map_head"]
    n = x_dense.shape[1]
    with profiling.span("map_head", tokens=n, pooled=1):
        c = x_dense.shape[-1]
        w, bias = h["attn"]["qkv"]["w"], h["attn"]["qkv"]["b"]
        post_ori = layer_norm_fused(x_ori, p["ln_post"], eps)
        post_dense = layer_norm_fused(x_dense, p["ln_post"], eps)
        probe = h["probe"].to(x_dense.dtype)[None]            # [1, 1, C]
        q = linear(probe, {"w": w[:c], "b": bias[:c]})
        k, v = linear(post_ori, {"w": w[c:], "b": bias[c:]}).chunk(2, -1)
        pooled, _ = attend(split_heads(q, heads), split_heads(k, heads),
                           split_heads(v, heads))
        v_dense = linear(post_dense, {"w": w[2 * c:], "b": bias[2 * c:]})
        e = linear(torch.cat([merge_heads(pooled), v_dense], dim=1),
                   h["attn"]["out"])
        return e + mlp(layer_norm_fused(e, h["ln"], eps), h["mlp"], act)


def encode_image(params: dict, images: torch.Tensor, cfg: ClipConfig,
                 ex_feats: torch.Tensor | None = None,
                 attn_mode: str = "stack", global_batch: bool = False):
    """vision_forward, then the reference's L2 norm over the TOKEN dimension
    (dim 1 of [B, N, C]), not the feature dimension."""
    out = vision_forward(params, images, cfg, ex_feats, attn_mode=attn_mode,
                         global_batch=global_batch)
    feats = out["projected"]
    out["projected"] = feats / _norm(feats, dim=1)
    return out


def _norm(x: torch.Tensor, dim: int) -> torch.Tensor:
    """jnp.linalg.norm(x, axis=dim, keepdims=True) as its program computes
    it: squares in x's type, summed in fp32, the root in x's type."""
    sq = (x * x).float().sum(dim=dim, keepdim=True)
    return torch.sqrt(sq.to(x.dtype))


# ---------------------------------------------------------------------------
# text encoder
# ---------------------------------------------------------------------------

def text_forward(params: dict, tokens: torch.Tensor,
                 cfg: ClipConfig) -> torch.Tensor:
    """CLIP text transformer on any device: tokens [B, context_length] int
    -> [B, embed_dim] in `cfg.compute_dtype`, pooled at the EOT (argmax-id)
    position. The JAX package's type points: the token embedding cast to
    the compute type, LayerNorm in fp32, the causal mask triu(-inf, 1) on
    fp32 logits (`multi_head_attention`), and the projection of the pooled
    tokens by the fp32 `text_projection` formed in fp32 (its `jnp.dot`
    promotes a bf16 operand) and rounded to the compute type. SigLIP's
    tower by its config: no mask (`text_causal`), the last position
    (`text_pool`), LayerNorm eps `text_ln_eps`, and its head's bias
    (`text_projection_bias`, where the tree holds one) added in fp32."""
    p = params["text"]
    act = _activation(cfg)
    eps = cfg.text_ln_eps
    tokens = tokens.long()
    x = p["token_embedding"][tokens].to(cfg.compute_dtype)
    x = x + p["positional_embedding"].to(x.dtype)

    n = tokens.shape[-1]
    mask = None
    if cfg.text_causal:
        mask = torch.triu(torch.full((n, n), -torch.inf, dtype=torch.float32,
                                     device=x.device), diagonal=1)
    for blk in p["blocks"]:
        y, _ = multi_head_attention(layer_norm(x, blk["ln_1"], eps),
                                    blk["attn"], cfg.text_heads, mask=mask)
        x = x + y
        x = x + _block_mlp(layer_norm(x, blk["ln_2"], eps), blk, act)

    x = layer_norm(x, p["ln_final"], eps)
    if cfg.text_pool not in ("eot", "last"):
        raise ValueError(f"text_pool {cfg.text_pool!r}: 'eot' or 'last'")
    at = tokens.argmax(dim=-1) if cfg.text_pool == "eot" else \
        torch.full_like(tokens[:, 0], n - 1)
    pooled = x[torch.arange(x.shape[0], device=x.device), at]
    out = torch.matmul(pooled.float(), p["text_projection"].float())
    if "text_projection_bias" in p:
        out = out + p["text_projection_bias"].float()
    return out.to(x.dtype)


def encode_text_ensemble(params: dict, token_batches: torch.Tensor,
                         cfg: ClipConfig) -> torch.Tensor:
    """Prompt-ensemble class embeddings: token_batches [num_classes,
    num_templates, context_length]. Per class: encode all templates,
    L2-normalize each, mean, L2-normalize the mean, all in the text's type
    (the mean summed in fp32, as `jnp.mean` sums a bf16 array)."""
    nc, nt, length = token_batches.shape
    emb = text_forward(params, token_batches.reshape(nc * nt, length), cfg)
    emb = emb.reshape(nc, nt, -1)
    emb = emb / _norm(emb, dim=-1)
    mean = emb.float().mean(dim=1).to(emb.dtype)
    return mean / _norm(mean, dim=-1)
