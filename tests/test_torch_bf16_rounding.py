"""The port's bf16 paths against the JAX package's with XLA made to round
every bf16 operation as the program is written.

By default XLA may keep a bf16 product in fp32 where it feeds a
conversion to fp32 (its `xla_allow_excess_precision`), which skips the
rounding that the Pallas kernels' `(a * m).astype(f32)` and the encoder's
bf16 ops write down. Over 20 PAR steps that drift reaches 0.13 on masks
near 1 (measured on the CPU), so the in-process comparisons of the bf16
route hold only to loose bounds. Here the JAX side runs in a subprocess
with `--xla_allow_excess_precision=false`: the bf16 diffusion then agrees
bit for bit, the whole bf16 PAR route to one bf16 ulp (from the bf16
rounding of the affinities, whose fp32 logits differ by an ulp: XLA
contracts some products into FMAs), and the bf16 encoder to one bf16 ulp
(its GEMMs sum in another order before rounding to bf16)."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from excel_tpu_torch.config import fast
from excel_tpu_torch.config import tiny_config as port_tiny_config
from excel_tpu_torch.models.clip import encode_image
from excel_tpu_torch.models.params import cast_matmul_weights, from_jax_params
from excel_tpu_torch.ops import par_kernels as pk
from excel_tpu_torch.ops.par import _offsets, par_refine
from torch_port_common import n

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
DILATIONS = (1, 2, 4, 8, 12, 24)

SCRIPT = r"""
import dataclasses
import sys

import numpy as np

sys.path[:0] = [ROOT, TESTS]
import jax
import jax.numpy as jnp

from excel_tpu.config import fast, tiny_config
from excel_tpu.models.clip import encode_image
from excel_tpu.models.params import cast_matmul_weights
from excel_tpu.ops import par_pallas as jp
from excel_tpu.ops.par import _offsets, par_refine
from torch_port_common import jax_clip_tree

bf = jnp.bfloat16
rng = np.random.default_rng(0)
out = {}
# PAR: 3 images with mixed extents on a 64 x 128 canvas, production set
img = rng.standard_normal((3, 3, 64, 128)).astype(np.float32)
masks = rng.random((3, 4, 64, 128), dtype=np.float32)
valid = np.asarray([[64, 128], [50, 100], [33, 77]], np.int32)
offs = tuple(_offsets(DILATIONS))
out.update(img=img, masks=masks, valid=valid)
out["refine"] = np.asarray(par_refine(
    jnp.asarray(img), jnp.asarray(masks), dilations=DILATIONS, num_iter=20,
    valid_hw=jnp.asarray(valid), use_pallas="interpret", dtype=bf))
aff = rng.random((3, len(offs), 64, 128), dtype=np.float32)
aff = aff / aff.sum(axis=1, keepdims=True)
aff = np.asarray(jnp.asarray(aff).astype(bf).astype(jnp.float32))
mp = jp.pad_replicate_valid(jnp.asarray(masks).astype(bf),
                            jnp.asarray(valid), 24, interpret=True)
out.update(aff=aff, mp=np.asarray(mp.astype(jnp.float32)))
out["step"] = np.asarray(jp.par_diffuse_padded_valid(
    mp, jnp.asarray(aff).astype(bf), jnp.asarray(valid), offs, 64, 128,
    interpret=True).astype(jnp.float32))
out["resident"] = np.asarray(jp.par_diffuse_valid_resident(
    mp, jnp.asarray(aff).astype(bf), jnp.asarray(valid), offs, 64, 128, 20,
    interpret=True).astype(jnp.float32))
# full extent (row 6): the edge-padded canvas, two padded steps
mpf = jp.pad_for_diffuse(jnp.asarray(masks).astype(bf), 24)
out["padded_canvas"] = np.asarray(mpf.astype(jnp.float32))
for i in range(2):
    mpf = jp.par_diffuse_padded(mpf, jnp.asarray(aff).astype(bf), offs, 64,
                                128, interpret=True)
    out[f"padded_step{i}"] = np.asarray(mpf.astype(jnp.float32))
# row 5 with bf16 storage at the mean-field CRF's 72 offsets (pad 55):
# weights that sum to bi_w = 4, 21 channels
from excel_tpu.ops.crf_tpu import DEFAULT_DILATIONS, _offsets as crf_offsets
from excel_tpu.ops.crf_tpu import crf_meanfield
coffs = tuple(crf_offsets(DEFAULT_DILATIONS))
cq = rng.random((2, 21, 40, 64), dtype=np.float32)
cq = np.asarray(jnp.asarray(cq / cq.sum(axis=1, keepdims=True)).astype(bf)
                .astype(jnp.float32))
caff = rng.random((2, len(coffs), 40, 64), dtype=np.float32)
caff = 4.0 * caff / caff.sum(axis=1, keepdims=True)
caff = np.asarray(jnp.asarray(caff).astype(bf).astype(jnp.float32))
out.update(crf_q=cq, crf_aff=caff)
out["crf_step"] = np.asarray(jp.par_diffuse(
    jp.pad_for_diffuse(jnp.asarray(cq).astype(bf), 55),
    jnp.asarray(caff).astype(bf), coffs, interpret=True).astype(jnp.float32))
# bf16 PAR with a pad of 2 (the per-step Pallas route), with extents and
# without, and the mean-field with bf16 messages
for key, v in (("refine_pad2_valid", jnp.asarray(valid)),
               ("refine_pad2_full", None)):
    out[key] = np.asarray(par_refine(
        jnp.asarray(img), jnp.asarray(masks), dilations=(1, 2), num_iter=5,
        valid_hw=v, use_pallas="interpret", dtype=bf))
# bf16 PAR at the dilations beyond the affinity slab (pad 56, K=56; K=72),
# 20 steps through the padded Pallas route, with extents and without
for i, dil in enumerate(LARGE_DILATIONS):
    for key, v in (("valid", jnp.asarray(valid)), ("full", None)):
        out[f"refine_large{i}_{key}"] = np.asarray(par_refine(
            jnp.asarray(img), jnp.asarray(masks), dilations=dil, num_iter=20,
            valid_hw=v, use_pallas="interpret", dtype=bf))
crf_img = rng.integers(0, 256, (3, 64, 128, 3)).astype(np.uint8)
probs = masks ** 3 / (masks ** 3).sum(axis=1, keepdims=True)
out.update(crf_img=crf_img, crf_probs=probs)
out["crf_bf16"] = np.asarray(crf_meanfield(
    jnp.asarray(crf_img), jnp.asarray(probs), iters=4, dilations=(1, 2, 4),
    use_pallas="interpret", valid_hw=jnp.asarray(valid), msg_dtype=bf,
    coarse_stride=8))
# encoder: fast tiny config on its Pallas kernels, inside one jit
cfg = dataclasses.replace(fast(tiny_config()).clip,
                          fused_attention="interpret")
tree = jax_clip_tree(cfg, seed=0)
images = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
enc = jax.jit(lambda p, x: encode_image(p, x, cfg, attn_mode="mean"))(
    cast_matmul_weights(tree, bf), jnp.asarray(images))
out.update(images=images,
           projected=np.asarray(enc["projected"].astype(jnp.float32)),
           feats=np.asarray(enc["feats"].astype(jnp.float32)),
           attn=np.asarray(enc["attn"]))
out.update({"tree/" + jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]})
# row 5 in bf16 at the CRF's offsets on ragged shapes (pad 55 beyond the
# canvas, odd and unaligned widths, 1, 9 and 21 channels)
for i, (b, c, h, w) in enumerate(CRF_SHAPES):
    q = rng.random((b, c, h, w), dtype=np.float32)
    q = jnp.asarray(q / q.sum(axis=1, keepdims=True)).astype(bf)
    a = rng.random((b, len(coffs), h, w), dtype=np.float32)
    a = jnp.asarray(4.0 * a / a.sum(axis=1, keepdims=True)).astype(bf)
    out[f"crf_q{i}"] = np.asarray(q.astype(jnp.float32))
    out[f"crf_aff{i}"] = np.asarray(a.astype(jnp.float32))
    out[f"crf_step{i}"] = np.asarray(jp.par_diffuse(
        jp.pad_for_diffuse(q, 55), a, coffs,
        interpret=True).astype(jnp.float32))
# the text tower in bf16 on the uncast weights (the CLIs build the text
# bank before casting them): 4 classes x 3 templates of random tokens
from excel_tpu.models.clip import encode_text_ensemble, text_forward
trng = np.random.default_rng(1)
tok = trng.integers(1, cfg.vocab_size - 2,
                    (4, 3, cfg.context_length)).astype(np.int32)
for row in tok.reshape(-1, cfg.context_length):
    eot = trng.integers(2, cfg.context_length)
    row[eot], row[eot + 1:] = cfg.vocab_size - 1, 0
out["text_tokens"] = tok
out["text_forward"] = np.asarray(text_forward(
    tree, jnp.asarray(tok[:, 0]), cfg).astype(jnp.float32))
out["text_ensemble"] = np.asarray(encode_text_ensemble(
    tree, jnp.asarray(tok), cfg).astype(jnp.float32))
np.savez(OUT, **out)
"""
# (B, C, h, w) of the ragged CRF steps, after the 2 x 21 x 40 x 64 one
CRF_SHAPES = [(1, 1, 8, 61), (2, 9, 16, 200), (1, 21, 40, 61)]
# dilations beyond the card's affinity slab: pad 56 (K=56), where no slab
# fits shared memory; nine dilations (K=72), more logits than its
# registers hold
LARGE_DILATIONS = [(1, 2, 4, 8, 12, 24, 56), (1, 2, 4, 8, 12, 16, 24, 32, 40)]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bf16") / "ref.npz")
    flags = os.environ.get("XLA_FLAGS", "")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(flags + " --xla_allow_excess_precision=false"
                          ).strip())
    code = (f"ROOT = {ROOT!r}\nTESTS = {TESTS!r}\nOUT = {path!r}\n"
            f"DILATIONS = {DILATIONS!r}\nCRF_SHAPES = {CRF_SHAPES!r}\n"
            f"LARGE_DILATIONS = {LARGE_DILATIONS!r}\n"
            + SCRIPT)
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    with np.load(path) as d:
        return dict(d)


def _bf16(a) -> torch.Tensor:
    return torch.from_numpy(a).to(torch.bfloat16)


def test_bf16_diffusion_equals_pallas_bitwise(ref):
    offsets = _offsets(DILATIONS)
    valid = torch.from_numpy(ref["valid"])
    mp, aff = _bf16(ref["mp"]), _bf16(ref["aff"])
    step = pk.par_diffuse_padded_valid(mp, aff, valid, offsets, 64, 128)
    np.testing.assert_array_equal(n(step.float()), ref["step"])
    res = pk.par_diffuse_valid_resident(mp, aff, valid, offsets, 64, 128, 20)
    np.testing.assert_array_equal(n(res.float()), ref["resident"])


def test_bf16_padded_step_equals_pallas_bitwise(ref):
    """Plain row 6 (`par_diffuse_padded_reference`: bf16 products, fp32
    sums in chunks of 8, border replicated over the whole canvas) against
    the Pallas `_diffuse_padded_kernel` in interpret mode, two chained
    steps from the same edge-padded canvas, bit for bit; and row 7's step
    with full extents, the route the card takes for it, gives the same
    bits."""
    offsets = _offsets(DILATIONS)
    mp = pk.pad_for_diffuse(_bf16(ref["masks"]), 24)
    np.testing.assert_array_equal(n(mp.float()), ref["padded_canvas"])
    aff = _bf16(ref["aff"])
    full = torch.tensor([[64, 128]] * 3, dtype=torch.int32)
    for i in range(2):
        step = pk.par_diffuse_padded_reference(mp, aff, offsets, 64, 128)
        np.testing.assert_array_equal(n(step.float()), ref[f"padded_step{i}"])
        valid_step = pk.par_diffuse_padded_valid(mp, aff, full, offsets, 64,
                                                 128)
        assert torch.equal(step, valid_step)
        mp = step


@pytest.mark.parametrize("case", ["", "0", "1", "2"])
def test_bf16_diffuse_step_equals_pallas_bitwise(ref, case):
    """`par_diffuse` in bf16 (its plain version: products rounded to bf16,
    fp32 sums in chunks of 8, chunk sums and the running output rounded to
    bf16) against the Pallas `_diffuse_kernel` with bf16 storage in
    interpret mode at the CRF's 72 offsets, bit for bit: [2, 21, 40, 64],
    then the ragged CRF_SHAPES."""
    from excel_tpu_torch.ops.crf_tpu import DEFAULT_DILATIONS
    from excel_tpu_torch.ops.crf_tpu import _offsets as crf_offsets

    offsets = pk.offsets_tensor(crf_offsets(DEFAULT_DILATIONS), "cpu")
    got = pk.par_diffuse(_bf16(ref[f"crf_q{case}"]),
                         _bf16(ref[f"crf_aff{case}"]), offsets)
    assert got.dtype == torch.bfloat16
    assert got.shape == ref[f"crf_step{case}"].shape
    np.testing.assert_array_equal(n(got.float()), ref[f"crf_step{case}"])


@pytest.mark.parametrize("extents", ["valid", "full"])
def test_bf16_par_refine_unaligned_pad_equals_pallas_bitwise(ref, extents):
    """bf16 `par_refine` with dilations (1, 2) (a pad of 2, not a multiple
    of 8), 5 steps: the per-step route equals the JAX package's Pallas
    route for it bit for bit, with per-image extents and without (the fp32
    affinity's ulp differences vanish in its rounding to bf16 here)."""
    got = par_refine(torch.from_numpy(ref["img"]),
                     torch.from_numpy(ref["masks"]), dilations=(1, 2),
                     num_iter=5, dtype=torch.bfloat16,
                     valid_hw=(torch.from_numpy(ref["valid"])
                               if extents == "valid" else None))
    np.testing.assert_array_equal(n(got), ref[f"refine_pad2_{extents}"])


def test_bf16_crf_messages_match_pallas(ref):
    """The mean-field CRF with bf16 messages (4 iterations, valid extents,
    the coarse level) against the JAX function on its Pallas kernel: the
    message pass agrees bit for bit, so Q differs only by the fp32 build's
    ulps where they cross a bf16 rounding of a pairwise weight (one bf16 ulp
    of a weight, 2^-8 of it, into a softmax): 1e-4 on Q (observed 2.3e-6),
    and the same argmax on >= 99.9% of the pixels (observed all)."""
    from excel_tpu_torch.ops.crf_tpu import crf_meanfield

    got = n(crf_meanfield(torch.from_numpy(ref["crf_img"]),
                          torch.from_numpy(ref["crf_probs"]), iters=4,
                          dilations=(1, 2, 4),
                          valid_hw=torch.from_numpy(ref["valid"]),
                          msg_dtype=torch.bfloat16, coarse_stride=8))
    want = ref["crf_bf16"]
    assert (got.argmax(1) == want.argmax(1)).mean() >= 0.999
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_bf16_par_refine_matches_pallas(ref):
    """pad-clamp, affinity and 20 resident steps at the production
    dilations: within one bf16 ulp of masks in [1, 2) (values grow past 1:
    the position term adds w2 to every affinity row)."""
    got = par_refine(torch.from_numpy(ref["img"]),
                     torch.from_numpy(ref["masks"]), dilations=DILATIONS,
                     num_iter=20, valid_hw=torch.from_numpy(ref["valid"]),
                     dtype=torch.bfloat16)
    np.testing.assert_allclose(n(got), ref["refine"], atol=2.0 ** -7, rtol=0)


@pytest.mark.parametrize("extents", ["valid", "full"])
@pytest.mark.parametrize("case", [0, 1])
def test_bf16_par_refine_large_pads_and_offset_counts_match_pallas(
        ref, case, extents):
    """The same 20 steps at pad 56 (K=56) and at K=72, where the card runs
    the direct affinity kernel and the resident diffusion's larger offset
    table: the padded route on both sides, within the same one bf16 ulp."""
    v = torch.from_numpy(ref["valid"]) if extents == "valid" else None
    got = par_refine(torch.from_numpy(ref["img"]),
                     torch.from_numpy(ref["masks"]),
                     dilations=LARGE_DILATIONS[case], num_iter=20,
                     valid_hw=v, dtype=torch.bfloat16)
    np.testing.assert_allclose(n(got), ref[f"refine_large{case}_{extents}"],
                               atol=2.0 ** -7, rtol=0)


def _tree_from(ref) -> dict:
    from excel_tpu_torch.models.params import _insert, _keystr_path

    tree: dict = {}
    for key, value in ref.items():
        if key.startswith("tree/"):
            _insert(tree, _keystr_path(key[len("tree/"):]), value)
    return tree


def test_bf16_encoder_matches_pallas(ref):
    """The fast encoder (attention "mean" mode, tiny config, inside one
    jit on the JAX side): bf16 features within one bf16 ulp of each
    array's largest magnitude (2^-7 of it: a small output of a cancelling
    sum moves by an ulp of its terms, not of itself; observed: 2.8% of
    feats and 10.9% of projected differ, by at most 0.031 and 0.0039,
    where the two GEMM libraries' sums round to neighbouring bf16 values);
    the fp32 block-mean attention, whose logits come from those bf16 q/k,
    within 1e-3 (observed 2.6e-4)."""
    cfg = fast(port_tiny_config()).clip
    params = cast_matmul_weights(from_jax_params(_tree_from(ref), cfg,
                                                 device="cpu"),
                                 torch.bfloat16)
    with torch.inference_mode():
        got = encode_image(params, torch.from_numpy(ref["images"]), cfg,
                           attn_mode="mean")
    assert got["projected"].dtype == torch.bfloat16
    for key in ("projected", "feats"):
        np.testing.assert_allclose(
            n(got[key].float()), ref[key], rtol=0,
            atol=2.0 ** -7 * float(np.abs(ref[key]).max()), err_msg=key)
    np.testing.assert_allclose(n(got["attn"]), ref["attn"], atol=1e-3,
                               rtol=0)


def test_bf16_text_tower_equals_jax_bitwise(ref):
    """The fast preset's text tower (`text_forward`, `encode_text_ensemble`
    over 3 templates) on the uncast weights: bit for bit once XLA rounds as
    written (in-process, XLA's excess precision moves some outputs by one
    or two bf16 ulps: tests/test_torch_text.py)."""
    from excel_tpu_torch.models.clip import encode_text_ensemble, text_forward

    cfg = fast(port_tiny_config()).clip
    params = from_jax_params(_tree_from(ref), cfg, device="cpu")
    tok = torch.from_numpy(ref["text_tokens"])
    with torch.inference_mode():
        fwd = text_forward(params, tok[:, 0], cfg)
        ens = encode_text_ensemble(params, tok, cfg)
    assert fwd.dtype == ens.dtype == torch.bfloat16
    np.testing.assert_array_equal(n(fwd.float()), ref["text_forward"])
    np.testing.assert_array_equal(n(ens.float()), ref["text_ensemble"])
