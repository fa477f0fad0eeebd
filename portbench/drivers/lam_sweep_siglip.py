"""lam_sweep_siglip: the training-free pseudo-label sweep over a SigLIP
tower (no CLS token, head dim 72, tanh GELU, the attention-pooling head;
models/clip.vision_forward with a SigLIP ClipConfig).

The sweep, its program calls, wrappers, warm-up, window and check are
drivers/lam_sweep.py's, run from a copy of that module of this driver's
own (`cell.load_module` loads a new one), in which five names are bound
anew:
- `model_inputs` draws SigLIP's weights (harness/weights_siglip.py) and a
  text bank of the tower's width (1,152);
- `R`, the reference its check runs, becomes reference/siglip.py seen
  through lam_sweep_openclip.FlatMaps (`label_miss` without the images
  whose refined map is flat, reported as `label_miss_flat` and
  `flat_images`; the images it compares as `label_miss_images`), and
  `reference_numbers` hands it the LayerNorm eps;
- `F`, whose `encoder_flops` becomes harness/siglip_counts.py's (729
  tokens, no CLS, the MLP at 4,304, the attention-pooling head) for
  `mfu.lam`;
- `S`, whose `Capture` keeps the program's attention with a zero row and
  column in front: lam_sweep's check drops row and column 0 of the
  attention as a CLS token's before SVC, and this tower's [N, N] block
  mean has none, so the check is handed both the program's and the
  reference's attention (`FlatMaps.lam_image`) so laid out; the zeros
  leave the attention gap as it is.
Two wrappers more add each traced call's least time from shapes: `mlp`
around the MLPs (models/clip.mlp, harness/mlp_counts.py at the call's
hidden width: the blocks' and the head's) for `mlp_roofline.lam`, and
`map_head` around the attention-pooling head (models/clip.map_head,
harness/siglip_counts.map_head_layer) for `map_head_roofline.lam`.
"""
from __future__ import annotations

import types

import torch.nn.functional as tF

from portbench.harness import cell
from portbench.harness import sweep as S
from portbench.harness import weights as W
from portbench.harness import weights_siglip
from portbench.harness.mlp_counts import mlp_work
from portbench.harness.siglip_counts import flops_module, map_head_work
from portbench.reference import siglip

_openclip = cell.load_module("drivers", "lam_sweep_openclip")


def _with_cls_place(attn):
    """[..., N, N] -> [..., 1 + N, 1 + N] with a zero row and column 0."""
    return tF.pad(attn, (1, 0, 1, 0))


class FlatMaps(_openclip.FlatMaps):
    """lam_sweep_openclip.FlatMaps over reference/siglip.py: its check
    calls (`cams_from_state`, `gap_summary`: pipeline.py's in both
    modules) and `label_miss` rule; siglip's `lam_image`, its attention
    given a zero row and column 0 (module docstring)."""

    def __getattr__(self, name):
        return getattr(siglip, name)

    def lam_image(self, m, raw, cls, prec=siglip.FP32):
        out = siglip.lam_image(m, raw, cls, prec)
        return dict(out, attn=_with_cls_place(out["attn"]))


class Capture(S.Capture):
    """sweep.Capture keeping the attention with a zero row and column 0."""

    def take(self, key, tensor, **kwargs):
        if key == "attn":
            tensor = _with_cls_place(tensor)
        return super().take(key, tensor, **kwargs)


def _sweep_module():
    base = cell.load_module("drivers", "lam_sweep")
    numbers = base.reference_numbers

    def model_inputs(ctx):
        cfg, spec = ctx.cfg, ctx.spec
        params = weights_siglip.clip_visual(cfg.clip, ctx.seed, ctx.device)
        text = W.text_bank(cfg.num_fg + spec["background_rows"],
                           cfg.clip.embed_dim, ctx.seed, ctx.device)
        return {"clip": params}, text

    def reference_numbers(cfg, params, text):
        return dict(numbers(cfg, params, text), eps=cfg.clip.ln_eps)

    base.R = FlatMaps()
    base.F = flops_module()
    base.S = types.SimpleNamespace(**dict(vars(S), Capture=Capture))
    base.model_inputs = model_inputs
    base.reference_numbers = reference_numbers
    return base


def run(ctx):
    from excel_tpu_torch.models import clip as clip_mod

    work = {}
    ctx.spans.wrap(clip_mod, "mlp", "mlp", before=mlp_work(ctx, work))
    ctx.spans.wrap(clip_mod, "map_head", "map_head",
                   before=map_head_work(ctx, work))
    sweep = _sweep_module()
    outcome = sweep.run(ctx)
    outcome.work.update(work)
    outcome.info["flat_images"] = sum(f for f, _ in sweep.R.images)
    outcome.info["label_miss_images"] = sum(not f for f, _ in sweep.R.images)
    outcome.info["label_miss_flat"] = max(
        (miss for f, miss in sweep.R.images if f), default=0.0)
    return outcome
