"""lam_sweep_openclip: the training-free pseudo-label sweep over an encoder
whose MLP activation the configuration names (OpenCLIP's exact GELU).

The sweep, its program calls, wrappers, warm-up, window and check are
drivers/lam_sweep.py's, run from a copy of that module of this driver's
own (`cell.load_module` loads a new one), in which two names are bound
anew: `R`, the reference its check runs, becomes reference/openclip.py
(pipeline.py's LAM step over a surgery ViT that takes the activation and
any head width) seen through `FlatMaps`, and `reference_numbers` adds the
configuration's activation to what it hands that reference. One wrapper
more, `mlp`, around the encoder blocks' MLPs (models/clip.mlp), adds each
traced call's least time from shapes (harness/mlp_counts.py) for
`mlp_roofline.lam`.

`FlatMaps` leaves out of `label_miss` the images on which some present
class's SVC-refined map is flat: its range (largest value less smallest)
under hw u of its largest magnitude, where u = 2^-24 is float32's unit
roundoff and hw the patch tokens, the products that one refined value
sums. That is the worst-case rounding of a single value, so the order
in which the sums are taken can make the whole shape of such a map, and
the min-max normalisation before PAR stretches it over the range 0-1.
Such maps come from the seeded random weights: after 32 blocks one
class's box may cover the whole grid and its refined map read constant
to 3 parts in 10^6. Their images' label misses are reported as
`label_miss_flat` and their count as `flat_images`.
"""
from __future__ import annotations

from portbench.harness import cell
from portbench.harness.mlp_counts import mlp_work
from portbench.reference import openclip, svc

UNIT_ROUNDOFF = 2.0 ** -24


class FlatMaps:
    """reference/openclip.py as lam_sweep's check calls it, with each
    image's label miss kept out of `label_miss` where a present class's
    refined map is flat (the module docstring). The check calls
    `cams_from_state`, then `gap_summary`, once an image."""

    def __init__(self):
        self.flat = False
        self.images: list = []      # (flat, label miss) of each image

    def __getattr__(self, name):
        return getattr(openclip, name)

    def cams_from_state(self, m, lams, attn, guide, prec=openclip.FP32):
        hw = lams.shape[1]
        refined = svc.refine(lams.float(), attn.float(), m["caa"],
                             int(round(hw ** 0.5)))
        spread = refined.amax(dim=1) - refined.amin(dim=1)
        peak = refined.abs().amax(dim=1)
        self.flat = bool((spread < hw * UNIT_ROUNDOFF * peak).any())
        return openclip.cams_from_state(m, lams, attn, guide, prec)

    def gap_summary(self, gap):
        out = openclip.gap_summary(gap)
        self.images.append((self.flat, out["miss"]))
        out["miss_flat"] = out["miss"] if self.flat else 0.0
        if self.flat:
            out["miss"] = 0.0
        return out


def _sweep_module():
    base = cell.load_module("drivers", "lam_sweep")
    numbers = base.reference_numbers

    def reference_numbers(cfg, params, text):
        return dict(numbers(cfg, params, text),
                    activation=cfg.clip.activation)

    base.R = FlatMaps()
    base.reference_numbers = reference_numbers
    return base


def run(ctx):
    from excel_tpu_torch.models import clip as clip_mod

    work = {}
    ctx.spans.wrap(clip_mod, "mlp", "mlp", before=mlp_work(ctx, work))
    sweep = _sweep_module()
    outcome = sweep.run(ctx)
    outcome.work.update(work)
    outcome.info["flat_images"] = sum(f for f, _ in sweep.R.images)
    outcome.info["label_miss_flat"] = max(
        (miss for f, miss in sweep.R.images if f), default=0.0)
    return outcome
