"""lam_sweep_eva02: the training-free pseudo-label sweep over an EVA-02
tower (rotary q/k, sub-LayerNorms, SwiGLU; models/clip.vision_forward with
an EVA-02 ClipConfig).

The sweep, its program calls, wrappers, warm-up, window and check are
drivers/lam_sweep.py's, run from a copy of that module of this driver's
own (`cell.load_module` loads a new one), in which three names are bound
anew: `model_inputs` draws EVA-02's weights (harness/weights_eva02.py, at
the published hidden width) and gives the program a copy served as its
loaders serve them (models/params.pad_swiglu: the SwiGLU's hidden padded
to 16-byte rows; cast_matmul_weights); `R`, the reference its check runs,
becomes reference/eva02.py seen through lam_sweep_openclip.FlatMaps
(`label_miss` without the images whose refined map is flat, reported as
`label_miss_flat` and `flat_images`); and `reference_numbers` hands that
reference the weights as drawn, never the program's padded copy, with the
rotary grid and the LayerNorm eps. Three wrappers more add each traced call's least
time from shapes (harness/eva02_counts.py): `swiglu` around the blocks'
SwiGLU MLPs (models/clip.swiglu) for `swiglu_roofline.lam`,
`swiglu_gate` around their gate and sub-LayerNorm (models/layers.
swiglu_gate_fused) for `swiglu_gate_roofline.lam`, and `qkv_rope` around
the rotating head split (models/layers.qkv_heads_kernel) for
`qkv_rope_roofline.lam`.
"""
from __future__ import annotations

import torch

from portbench.harness import cell
from portbench.harness import weights as W
from portbench.harness import weights_eva02
from portbench.harness.eva02_counts import (qkv_rope_work, swiglu_gate_work,
                                            swiglu_work)
from portbench.reference import eva02

_openclip = cell.load_module("drivers", "lam_sweep_openclip")


class FlatMaps(_openclip.FlatMaps):
    """lam_sweep_openclip.FlatMaps over reference/eva02.py: its check
    calls (`cams_from_state`, `gap_summary`: pipeline.py's in both
    modules) and `label_miss` rule, eva02's `lam_image`."""

    def __getattr__(self, name):
        return getattr(eva02, name)


def _sweep_module():
    base = cell.load_module("drivers", "lam_sweep")
    numbers = base.reference_numbers
    drawn = {}

    def model_inputs(ctx):
        from excel_tpu_torch.models.params import (cast_matmul_weights,
                                                   pad_swiglu)

        cfg, spec = ctx.cfg, ctx.spec
        drawn["clip"] = weights_eva02.clip_visual(cfg.clip, ctx.seed,
                                                  ctx.device)
        clip = pad_swiglu(drawn["clip"])
        if cfg.clip.compute_dtype == torch.bfloat16:
            clip = cast_matmul_weights(clip, torch.bfloat16)
        text = W.text_bank(cfg.num_fg + spec["background_rows"],
                           cfg.clip.embed_dim, ctx.seed, ctx.device)
        return {"clip": clip}, text

    def reference_numbers(cfg, params, text):
        return dict(numbers(cfg, drawn, text),
                    rope_grid=cfg.clip.rope_grid, eps=cfg.clip.ln_eps)

    base.R = FlatMaps()
    base.model_inputs = model_inputs
    base.reference_numbers = reference_numbers
    return base


def run(ctx):
    from excel_tpu_torch.models import clip as clip_mod
    from excel_tpu_torch.models import layers

    work = {}
    ctx.spans.wrap(clip_mod, "swiglu", "swiglu",
                   before=swiglu_work(ctx, work))
    ctx.spans.wrap(layers, "swiglu_gate_fused", "swiglu_gate",
                   before=swiglu_gate_work(ctx, work))
    ctx.spans.wrap(layers, "qkv_heads_kernel", "qkv_rope",
                   before=qkv_rope_work(ctx, work))
    sweep = _sweep_module()
    outcome = sweep.run(ctx)
    outcome.work.update(work)
    outcome.info["flat_images"] = sum(f for f, _ in sweep.R.images)
    outcome.info["label_miss_flat"] = max(
        (miss for f, miss in sweep.R.images if f), default=0.0)
    return outcome
