"""The port's CUDA kernels against their plain versions on a GPU.

These need a CUDA device and nvcc; elsewhere they skip. On a machine with
the card: python -m pytest -m cuda tests/test_torch_kernels_gpu.py -q
"""
import pytest
import torch

from excel_tpu_torch import build
from excel_tpu_torch.models import attention_kernels as ak
from excel_tpu_torch.ops.par import _offsets, _pos_weight, _replicate_valid
from excel_tpu_torch.ops import par_kernels as pk
from torch_launches import launches, spy

pytestmark = pytest.mark.cuda

ATOL = 1e-4     # fp32 sums in another order


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU form)")
    return torch.Generator(device="cuda").manual_seed(0)


# N=17 and 197: tails of the 64-row query tiles and of the 64-key chunks
@pytest.mark.parametrize("tokens,d", [(17, 32), (197, 64)])
@pytest.mark.parametrize("mode", ["none", "out", "acc"])
def test_plain_attention_kernel(gen, tokens, d, mode):
    q, k, v = (torch.randn((2, 3, tokens, d), device="cuda", generator=gen)
               for _ in range(3))
    acc = torch.rand((2, tokens, tokens), device="cuda", generator=gen)
    kw = dict(need_weights=mode != "none")
    got = ak.fused_plain_attention(
        q, k, v, acc=acc.clone() if mode == "acc" else None, **kw)
    ref = ak.plain_attention_reference(
        q, k, v, acc=acc.clone() if mode == "acc" else None, **kw)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if g is not None:
            torch.testing.assert_close(g, r, atol=ATOL, rtol=0)


@pytest.mark.parametrize("tokens", [17, 197])
@pytest.mark.parametrize("mode", ["none", "out", "acc"])
def test_surgery_attention_kernel(gen, tokens, mode):
    q, k, v = (torch.randn((2, 3, tokens, 64), device="cuda", generator=gen)
               for _ in range(3))
    acc = torch.rand((2, tokens, tokens), device="cuda", generator=gen)
    ex = torch.rand((2, tokens, tokens), device="cuda", generator=gen)
    kw = dict(ex_attn=ex, need_attn=mode != "none")
    got = ak.fused_surgery_attention(
        q, k, v, acc=acc.clone() if mode == "acc" else None, **kw)
    ref = ak.surgery_attention_reference(
        q, k, v, acc=acc.clone() if mode == "acc" else None, **kw)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if g is not None:
            torch.testing.assert_close(g, r, atol=ATOL, rtol=0)


# row 5's kernel at its offset sets: K=8 (dilation 1, pad 1), 48 (PAR's
# dilations, pad 24) and 72 (the CRF's, pad 55)
def _diffuse_offsets(k):
    if k == 72:
        from excel_tpu_torch.ops.crf_tpu import DEFAULT_DILATIONS
        from excel_tpu_torch.ops.crf_tpu import _offsets as crf_offsets

        return crf_offsets(DEFAULT_DILATIONS)
    return _offsets({8: (1,), 48: (1, 2, 4, 8, 12, 24)}[k])


# (K, B, C, h, w): 1, 2, 3, 8, 9, 21 and 81 channels (one to 21 channel
# passes); widths 61, 200, 300 and 640 (ragged and whole 64-column tiles);
# heights below the pad; a 1-row and a 1-column image
DIFFUSE_SHAPES = [(8, 2, 1, 1, 61), (8, 1, 3, 33, 1), (48, 1, 8, 1, 200),
                  (48, 2, 2, 20, 640), (48, 1, 9, 40, 61),
                  (72, 1, 3, 8, 300), (72, 2, 21, 40, 61),
                  (72, 1, 81, 16, 200), (72, 1, 9, 50, 640)]


def _diffuse_case(gen, k, b, c, h, w, dtype):
    offs = _diffuse_offsets(k)
    masks = torch.rand((b, c, h, w), device="cuda", generator=gen)
    aff = torch.rand((b, len(offs), h, w), device="cuda", generator=gen)
    aff = aff / aff.sum(dim=1, keepdim=True)
    return masks.to(dtype), aff.to(dtype), pk.offsets_tensor(offs, "cuda")


def _diffuse_bitwise(masks, aff, offsets):
    """The kernel against its plain version bit for bit, twice for equal
    bits, and once more on a side stream."""
    got = pk.par_diffuse(masks, aff, offsets)
    again = pk.par_diffuse(masks, aff, offsets)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        on_side = pk.par_diffuse(masks, aff, offsets)
    torch.cuda.current_stream().wait_stream(side)
    ref = pk.par_diffuse_reference(masks, aff, offsets)
    torch.cuda.synchronize()
    assert got.dtype == masks.dtype
    assert torch.equal(got, ref), float((got.float() - ref.float()).abs()
                                        .max())
    assert torch.equal(got, again) and torch.equal(got, on_side)


def test_par_diffuse_kernel_bitwise(gen):
    offs = _offsets((1, 2, 4, 8, 12, 24))
    masks = torch.rand((2, 10, 40, 300), device="cuda", generator=gen)
    aff = torch.rand((2, len(offs), 40, 300), device="cuda", generator=gen)
    valid = torch.tensor([[40, 300], [25, 170]], device="cuda")
    masks = _replicate_valid(masks, valid)
    offsets = pk.offsets_tensor(offs, "cuda")
    got = pk.par_diffuse(masks, aff, offsets)
    ref = pk.par_diffuse_reference(masks, aff, offsets)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,b,c,h,w", DIFFUSE_SHAPES)
def test_par_diffuse_kernel_shapes_bitwise(gen, k, b, c, h, w, dtype):
    _diffuse_bitwise(*_diffuse_case(gen, k, b, c, h, w, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [8, 72])
def test_par_diffuse_kernel_unaligned_bitwise(gen, k, dtype):
    """Masks and affinities at an odd element offset (a batch sliced off
    the front of an odd-sized one): no 16-byte copy or 4-byte pair is
    aligned."""
    masks, aff, offsets = _diffuse_case(gen, k, 3, 3, 7, 61, dtype)
    _diffuse_bitwise(masks[1:], aff[1:], offsets)


# bf16 outputs against their plain versions: at most one bf16 ulp of the
# reference's own size, |got - ref| <= 2^-7 |ref| (the contexts round fp32
# sums taken in another order; the affinity's exp and reciprocal differ by
# an fp32 ulp); a dropped term or a wrong tile is off by far more. Plus
# the smallest normal fp32, for subnormal values, whose bf16 ulp is coarser
# than 2^-7 of them
BF16_RTOL = 2.0 ** -7
BF16_ATOL = torch.finfo(torch.float32).tiny
# the bf16 attention contexts get two more terms: 2^-20 max|v| (the tensor
# cores sum an instruction's 16 products without rounding each partial sum,
# which shows where a context cancels to nearly 0) and the rounding
# allowance of p (a normalised p at a bf16 tie may round either way; one
# bf16 ulp of exactly those p times |v|, 0 elsewhere)
CTX_ABS_OF_VMAX = 2.0 ** -20


def _ctx_close(got, ref, q, k, v):
    assert got.dtype == ref.dtype
    g, r = got.float(), ref.float()
    lim = BF16_RTOL * r.abs() + BF16_ATOL if got.dtype == torch.bfloat16 \
        else torch.full_like(r, ATOL)
    lim = lim + ak.context_rounding_allowance(q, k, v) \
        + (CTX_ABS_OF_VMAX * float(v.float().abs().max())
           if got.dtype == torch.bfloat16 else 0.0)
    assert torch.isfinite(g).all()
    bad = (g - r).abs() > lim
    assert not bad.any(), (int(bad.sum()), float((g - r).abs().max()))


def _qkv(gen, b, h, n, d, dtype):
    return [torch.randn((b, h, n, d), device="cuda", generator=gen).to(dtype)
            for _ in range(3)]


def _attention(kind, q, k, v, mode, acc, ex=None):
    """(fused outputs, plain outputs) with output 1 the accumulated one."""
    def a():
        return acc.clone() if mode == "acc" else None
    if kind == "plain":
        kw = dict(need_weights=mode != "none")
        got = ak.fused_plain_attention(q, k, v, acc=a(), **kw)
        ref = ak.plain_attention_reference(q, k, v, acc=a(), **kw)
        return (got[1], got[0]), (ref[1], ref[0])
    kw = dict(ex_attn=ex, need_attn=mode != "none")
    got = ak.fused_surgery_attention(q, k, v, acc=a(), **kw)
    ref = ak.surgery_attention_reference(q, k, v, acc=a(), **kw)
    return (got[1], got[2], got[0]), (ref[1], ref[2], ref[0])


def _check_attention(kind, q, k, v, mode, acc, ex=None):
    got, ref = _attention(kind, q, k, v, mode, acc, ex)
    torch.cuda.synchronize()
    assert (got[0] is None) == (mode == "none")
    # the context: [B, H, N, D], stored token-major ([B, N, H, D])
    assert got[1].shape == q.shape
    assert got[1].permute(0, 2, 1, 3).is_contiguous()
    _ctx_close(got[1], ref[1], q, k, v)
    for g, r in zip(got[::2], ref[::2]):       # fp32 [B, N, N] outputs
        assert (g is None) == (r is None)
        if g is not None:
            torch.testing.assert_close(g, r, atol=ATOL, rtol=0)
    return got


# ragged and tiny token counts: one key, tails of 1 and 15 rows on either
# side of the 16-row fragments and the 64-row tiles; every head dim and mode
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["none", "out", "acc"])
@pytest.mark.parametrize("tokens", [1, 15, 17, 63, 65])
@pytest.mark.parametrize("d", [32, 64, 72, 80])
def test_attention_kernels_edge_tokens(gen, d, tokens, mode, dtype):
    q, k, v = _qkv(gen, 2, 3, tokens, d, dtype)
    acc = torch.rand((2, tokens, tokens), device="cuda", generator=gen)
    _check_attention("plain", q, k, v, mode, acc)
    _check_attention("surgery", q, k, v, mode, acc)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["none", "out", "acc"])
@pytest.mark.parametrize("b", [1, 3])
def test_surgery_attention_kernel_ex_every_mode(gen, b, mode, dtype):
    n = 130
    q, k, v = _qkv(gen, b, 12, n, 64, dtype)
    acc = torch.rand((b, n, n), device="cuda", generator=gen)
    ex = (torch.rand((b, n, n), device="cuda", generator=gen)
          / n).to(dtype).float()
    _check_attention("surgery", q, k, v, mode, acc, ex)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["plain", "surgery"])
def test_attention_kernels_deterministic_and_acc_is_out_plus_acc(gen, kind,
                                                                 dtype):
    """Two launches give the same bits (no atomics, fixed order of the head
    sums), and mode acc equals mode out + the accumulator bit for bit."""
    n = 197
    q, k, v = _qkv(gen, 2, 12, n, 64, dtype)
    acc = torch.rand((2, n, n), device="cuda", generator=gen)
    first, _ = _attention(kind, q, k, v, "acc", acc)
    again, _ = _attention(kind, q, k, v, "acc", acc)
    out, _ = _attention(kind, q, k, v, "out", acc)
    torch.cuda.synchronize()
    for a, b2 in zip(first, again):
        assert torch.equal(a, b2)
    assert torch.equal(first[0], out[0] + acc)
    for a, o in zip(first[1:], out[1:]):
        assert torch.equal(a, o)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["none", "out", "acc"])
def test_attention_kernels_hd80_every_mode_with_ex(gen, mode, dtype):
    """OpenCLIP ViT-H/14's heads (16 of 80) at its 577 tokens: both kernels
    against their plain versions in every mode, surgery with and without
    ex, each launch counted under its entry point."""
    n = 577
    q, k, v = _qkv(gen, 2, 16, n, 80, dtype)
    acc = torch.rand((2, n, n), device="cuda", generator=gen)
    ex = (torch.rand((2, n, n), device="cuda", generator=gen)
          / n).to(dtype).float()
    with launches() as counts:
        _check_attention("plain", q, k, v, mode, acc)
        _check_attention("surgery", q, k, v, mode, acc)
        _check_attention("surgery", q, k, v, mode, acc, ex)
    assert counts == {build.typed("excel_plain_attention", dtype): 1,
                      build.typed("excel_surgery_attention", dtype): 2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["plain", "surgery"])
def test_attention_kernels_hd80_deterministic_and_acc_is_out_plus_acc(
        gen, kind, dtype):
    """At D = 80 as at 64: two launches give the same bits, with ex too,
    and mode acc equals mode out + the accumulator bit for bit."""
    n = 577
    q, k, v = _qkv(gen, 4, 16, n, 80, dtype)
    acc = torch.rand((4, n, n), device="cuda", generator=gen)
    ex = (torch.rand((4, n, n), device="cuda", generator=gen)
          / n).to(dtype).float() if kind == "surgery" else None
    first, _ = _attention(kind, q, k, v, "acc", acc, ex)
    again, _ = _attention(kind, q, k, v, "acc", acc, ex)
    out, _ = _attention(kind, q, k, v, "out", acc, ex)
    torch.cuda.synchronize()
    for a, b2 in zip(first, again):
        assert torch.equal(a, b2)
    assert torch.equal(first[0], out[0] + acc)
    for a, o in zip(first[1:], out[1:]):
        assert torch.equal(a, o)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["none", "out", "acc"])
@pytest.mark.parametrize("tokens", [729, 730, 100])
def test_attention_kernels_hd72_every_mode_with_ex(gen, tokens, mode, dtype):
    """SigLIP So400m/14's heads (16 of 72, 9 chunks of 16 bytes a row in
    bf16, held in the tiles as 80 with a zero chunk) at its 729 tokens and
    at ragged counts: both kernels against their plain versions in every
    mode, surgery with and without ex, each launch counted under its entry
    point."""
    n = tokens
    q, k, v = _qkv(gen, 2, 16, n, 72, dtype)
    acc = torch.rand((2, n, n), device="cuda", generator=gen)
    ex = (torch.rand((2, n, n), device="cuda", generator=gen)
          / n).to(dtype).float()
    with launches() as counts:
        _check_attention("plain", q, k, v, mode, acc)
        _check_attention("surgery", q, k, v, mode, acc)
        _check_attention("surgery", q, k, v, mode, acc, ex)
    assert counts == {build.typed("excel_plain_attention", dtype): 1,
                      build.typed("excel_surgery_attention", dtype): 2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["plain", "surgery"])
def test_attention_kernels_hd72_deterministic_and_acc_is_out_plus_acc(
        gen, kind, dtype):
    """At D = 72 as at 64 and 80: two launches give the same bits, with ex
    too, and mode acc equals mode out + the accumulator bit for bit."""
    n = 729
    q, k, v = _qkv(gen, 4, 16, n, 72, dtype)
    acc = torch.rand((4, n, n), device="cuda", generator=gen)
    ex = (torch.rand((4, n, n), device="cuda", generator=gen)
          / n).to(dtype).float() if kind == "surgery" else None
    first, _ = _attention(kind, q, k, v, "acc", acc, ex)
    again, _ = _attention(kind, q, k, v, "acc", acc, ex)
    out, _ = _attention(kind, q, k, v, "out", acc, ex)
    torch.cuda.synchronize()
    for a, b2 in zip(first, again):
        assert torch.equal(a, b2)
    assert torch.equal(first[0], out[0] + acc)
    for a, o in zip(first[1:], out[1:]):
        assert torch.equal(a, o)


def test_attention_kernels_keep_their_recorded_bits(gen):
    """The D = 32 and 64 kernels give the bits they gave before D = 80
    came, and the D = 80 ones the bits of their [B, H, N, D] context store
    (the contexts, now stored token-major, hashed in [B, H, N, D] order):
    tools/attention_ab.py's DIGEST_CASES (every mode, surgery with and
    without ex, fp32 and bf16, inputs drawn on the CPU from a seed)
    against the digests recorded from them
    (tests/torch_fixtures/attention_digests.json)."""
    import importlib.util
    import json
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "attention_ab", os.path.join(root, "tools", "attention_ab.py"))
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    with open(os.path.join(root, "tests", "torch_fixtures",
                           "attention_digests.json")) as f:
        recorded = json.load(f)
    assert ab.output_digests(torch, ak, ab.DIGEST_CASES) == recorded


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernels_on_a_side_stream(gen, dtype):
    """The kernels and their scratch follow PyTorch's current stream."""
    n = 401
    q, k, v = _qkv(gen, 2, 12, n, 64, dtype)
    acc = torch.rand((2, n, n), device="cuda", generator=gen)
    ref_p, _ = _attention("plain", q, k, v, "out", acc)
    ref_s, _ = _attention("surgery", q, k, v, "out", acc)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        got_p, _ = _attention("plain", q, k, v, "out", acc)
        got_s, _ = _attention("surgery", q, k, v, "out", acc)
    side.synchronize()
    for g, r in zip(got_p + got_s, ref_p + ref_s):
        assert torch.equal(g, r)


@pytest.mark.parametrize("tokens", [17, 197])
@pytest.mark.parametrize("mode", ["none", "out", "acc"])
def test_plain_attention_kernel_bf16(gen, tokens, mode):
    q, k, v = (torch.randn((2, 3, tokens, 64), device="cuda", generator=gen)
               .bfloat16() for _ in range(3))
    acc = torch.rand((2, tokens, tokens), device="cuda", generator=gen)
    kw = dict(need_weights=mode != "none")
    got = ak.fused_plain_attention(
        q, k, v, acc=acc.clone() if mode == "acc" else None, **kw)
    ref = ak.plain_attention_reference(
        q, k, v, acc=acc.clone() if mode == "acc" else None, **kw)
    torch.cuda.synchronize()
    assert got[0].dtype == torch.bfloat16
    _ctx_close(got[0], ref[0], q, k, v)
    if mode != "none":
        torch.testing.assert_close(got[1], ref[1], atol=ATOL, rtol=0)


@pytest.mark.parametrize("mode", ["none", "out", "acc"])
def test_surgery_attention_kernel_bf16(gen, mode):
    q, k, v = (torch.randn((2, 3, 197, 64), device="cuda", generator=gen)
               .bfloat16() for _ in range(3))
    acc = torch.rand((2, 197, 197), device="cuda", generator=gen)
    kw = dict(need_attn=mode != "none")
    got = ak.fused_surgery_attention(
        q, k, v, acc=acc.clone() if mode == "acc" else None, **kw)
    ref = ak.surgery_attention_reference(
        q, k, v, acc=acc.clone() if mode == "acc" else None, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], ref[0], atol=ATOL, rtol=0)
    _ctx_close(got[2], ref[2], q, k, v)
    if mode != "none":
        torch.testing.assert_close(got[1], ref[1], atol=ATOL, rtol=0)


def _canvas(gen, dtype, b=3, c=5, h=40, w=200):
    x = torch.rand((b, c, h, w), device="cuda", generator=gen).to(dtype)
    valid = torch.tensor([[40, 200], [25, 170], [9, 31]][:b], device="cuda",
                         dtype=torch.int32)
    return x, valid


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pad_clamp_kernel_bitwise(gen, dtype):
    x, valid = _canvas(gen, dtype)
    got = pk.pad_replicate_valid(x, valid, 24)
    ref = pk.pad_replicate_valid_reference(x, valid, 24)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def test_affinity_kernel(gen):
    """Same order of rounding; exp and the divisions by a Python scalar
    (which PyTorch's CUDA division takes as a product with the
    reciprocal) differ by an fp32 ulp, which can move a bf16 affinity by
    one bf16 ulp of its own size. The kernel writes bf16 only."""
    dil = (1, 2, 4, 8, 12, 24)
    img, valid = _canvas(gen, torch.float32, c=3)
    ip = pk.pad_replicate_valid(img, valid, 24)
    offsets = _offsets(dil)
    pos_w = [float(p) for p in _pos_weight(dil)]
    got = pk.par_affinity(ip, offsets, pos_w, 40, 200)
    ref = pk.par_affinity_reference(ip, offsets, pos_w, 40, 200)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.float(), atol=BF16_ATOL,
                               rtol=BF16_RTOL)
    with pytest.raises(NotImplementedError):
        pk.par_affinity(ip, offsets, pos_w, 40, 200, out_dtype=torch.float32)


def test_diffuse_valid_kernels_bitwise(gen):
    """The step kernel equals its plain version, and one resident launch of
    6 steps equals 6 step launches, bit for bit (bf16; 9 channels: two
    passes over the affinities, of 5 and 4 channels)."""
    dil = (1, 2, 4, 8, 12, 24)
    offsets = _offsets(dil)
    masks, valid = _canvas(gen, torch.bfloat16, c=9)
    mp = pk.pad_replicate_valid(masks, valid, 24)
    aff = torch.rand((3, len(dil) * 8, 40, 200), device="cuda", generator=gen)
    aff = (aff / aff.sum(dim=1, keepdim=True)).bfloat16()
    step = pk.par_diffuse_padded_valid(mp, aff, valid, offsets, 40, 200)
    ref = pk.par_diffuse_padded_valid_reference(mp, aff, valid, offsets, 40,
                                                200)
    m = mp
    for _ in range(6):
        m = pk.par_diffuse_padded_valid(m, aff, valid, offsets, 40, 200)
    res = pk.par_diffuse_valid_resident(mp, aff, valid, offsets, 40, 200, 6)
    torch.cuda.synchronize()
    assert torch.equal(step, ref)
    assert torch.equal(res, m)
    with pytest.raises(NotImplementedError):
        pk.par_diffuse_padded_valid(mp.float(), aff.float(), valid, offsets,
                                    40, 200)


def _diffuse_valid_case(gen, c, w, dil, hp_extra=8, wp=None):
    """bf16 canvas, affinities and extents of 4 images of height 40 and
    width w: one full, one ragged, one a single row, one a single column."""
    offs = _offsets(dil)
    pad = max(dil)
    valid = torch.tensor([[40, w], [25, w * 2 // 3 + 1], [1, w - 7], [33, 1]],
                         device="cuda", dtype=torch.int32)
    masks = torch.rand((4, c, 40, w), device="cuda", generator=gen).bfloat16()
    wp = wp or -(-(w + 2 * pad) // 128) * 128
    mp = pk._clamped_gather(masks, valid, pad, 40 + 2 * pad + hp_extra, wp)
    aff = torch.rand((4, len(offs), 40, w), device="cuda", generator=gen)
    aff = (aff / aff.sum(dim=1, keepdim=True)).bfloat16()
    return mp, aff, valid, offs


# pad 24 (the production dilations, K=48) and pad 3 (K=16: odd column
# offsets, whose mask pairs are not 4-byte aligned)
@pytest.mark.parametrize("dil", [(1, 2, 4, 8, 12, 24), (1, 3)])
@pytest.mark.parametrize("w", [61, 200, 512])
@pytest.mark.parametrize("c", [1, 4, 5, 8, 9])
def test_diffuse_valid_resident_edges_bitwise(gen, c, w, dil):
    """Resident == iterated step launches == plain version, bit for bit,
    for 1, 2, 7 and 20 steps: one pass over the affinities up to 8
    channels, two at 9; widths that break the 16-byte copies (61) and
    extents of one row or one column."""
    mp, aff, valid, offs = _diffuse_valid_case(gen, c, w, dil)
    m, plain = mp, mp
    for n in range(1, 21):
        m = pk.par_diffuse_padded_valid(m, aff, valid, offs, 40, w)
        plain = pk.par_diffuse_padded_valid_reference(plain, aff, valid, offs,
                                                      40, w)
        if n in (1, 2, 7, 20):
            res = pk.par_diffuse_valid_resident(mp, aff, valid, offs, 40, w,
                                                n)
            torch.cuda.synchronize()
            assert torch.equal(m, plain), n
            assert torch.equal(res, plain), n


def test_diffuse_valid_odd_canvas_and_unaligned_pointers(gen):
    """An odd canvas width and height, and tensors that start 2 bytes past
    a 16-byte boundary: every copy and store takes its element path."""
    dil = (1, 2, 4, 8, 12, 24)
    mp, aff, valid, offs = _diffuse_valid_case(gen, 5, 200, dil, hp_extra=1,
                                               wp=200 + 48 + 3)
    big_m = torch.empty((mp.numel() + 1,), device="cuda", dtype=mp.dtype)
    big_a = torch.empty((aff.numel() + 1,), device="cuda", dtype=aff.dtype)
    mp_u = big_m[1:].view(mp.shape).copy_(mp)
    aff_u = big_a[1:].view(aff.shape).copy_(aff)
    ref = pk.par_diffuse_valid_resident_reference(mp, aff, valid, offs, 40,
                                                  200, 7)
    got = pk.par_diffuse_valid_resident(mp_u, aff_u, valid, offs, 40, 200, 7)
    step = pk.par_diffuse_padded_valid(mp_u, aff_u, valid, offs, 40, 200)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert torch.equal(step, pk.par_diffuse_padded_valid_reference(
        mp, aff, valid, offs, 40, 200))


def test_diffuse_valid_deterministic_and_on_a_side_stream(gen):
    """Two launches give the same bits, and a launch on a side stream the
    same bits as on the default stream."""
    mp, aff, valid, offs = _diffuse_valid_case(gen, 4, 512,
                                               (1, 2, 4, 8, 12, 24))
    a = pk.par_diffuse_valid_resident(mp, aff, valid, offs, 40, 512, 20)
    b = pk.par_diffuse_valid_resident(mp, aff, valid, offs, 40, 512, 20)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        c = pk.par_diffuse_valid_resident(mp, aff, valid, offs, 40, 512, 20)
        s = pk.par_diffuse_padded_valid(mp, aff, valid, offs, 40, 512)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(s, pk.par_diffuse_padded_valid_reference(
        mp, aff, valid, offs, 40, 512))
    # beyond the kernel's table of 128 offsets
    with pytest.raises(NotImplementedError):
        pk.par_diffuse_padded_valid(mp, aff[:, :1].repeat(1, 129, 1, 1),
                                    valid, (offs * 3)[:129], 40, 512)


def test_surgery_attention_kernel_bf16_with_ex(gen):
    """The calibrated train pass: bf16 q/k/v with an ex mask of bf16 values
    carried in fp32 (zero CLS row and column), no weights."""
    q, k, v = (torch.randn((2, 3, 197, 64), device="cuda", generator=gen)
               .bfloat16() for _ in range(3))
    ex = torch.rand((2, 196, 196), device="cuda", generator=gen) / 196
    ex = torch.nn.functional.pad(ex.bfloat16().float(), (1, 0, 1, 0))
    got = ak.fused_surgery_attention(q, k, v, ex_attn=ex, need_attn=False)
    ref = ak.surgery_attention_reference(q, k, v, ex_attn=ex,
                                         need_attn=False)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], ref[0], atol=ATOL, rtol=0)
    _ctx_close(got[2], ref[2], q, k, v)


@pytest.mark.parametrize("c,h,w", [(5, 40, 56), (9, 40, 56), (1, 20, 61),
                                   (5, 64, 200)])
def test_row8_padded_hcw_step_via_diffuse_kernel(gen, c, h, w):
    """Pallas row 8 (full-extent fp32 step on the edge-padded [B, H+2P, C8,
    Wp] canvas) computed by row 5's kernel on the unpadded masks: 20
    chained steps within 1e-5 of the plain row 8."""
    dil = (1, 2, 4, 8, 12, 24)
    offs = _offsets(dil)
    masks = torch.rand((2, c, h, w), device="cuda", generator=gen)
    aff = torch.rand((2, len(offs), h, w), device="cuda", generator=gen)
    aff = aff / aff.sum(dim=1, keepdim=True)
    m_k = masks
    m_r = pk.pad_for_diffuse_hcw(masks, 24)
    offsets = pk.offsets_tensor(offs, "cuda")
    for _ in range(20):
        m_k = pk.par_diffuse(m_k, aff, offsets)
        m_r = pk.par_diffuse_padded_hcw_reference(m_r, aff, offs, h, w)
    torch.cuda.synchronize()
    interior = m_r[:, 24:24 + h, :c, 24:24 + w].permute(0, 2, 1, 3)
    torch.testing.assert_close(m_k, interior, atol=1e-5, rtol=0)


def test_row6_padded_step_via_valid_kernel_bitwise(gen):
    """Pallas row 6 (full-extent bf16 step, border kept by the step)
    computed by row 7's kernel with every extent the whole image: 3
    chained steps bit for bit."""
    dil = (1, 2, 4, 8, 12, 24)
    offs = _offsets(dil)
    masks = torch.rand((2, 5, 40, 56), device="cuda", generator=gen)
    aff = torch.rand((2, len(offs), 40, 56), device="cuda", generator=gen)
    aff = (aff / aff.sum(dim=1, keepdim=True)).bfloat16()
    full = torch.tensor([[40, 56]] * 2, device="cuda", dtype=torch.int32)
    m_k = m_r = pk.pad_for_diffuse(masks.bfloat16(), 24)
    for _ in range(3):
        m_k = pk.par_diffuse_padded_valid(m_k, aff, full, offs, 40, 56)
        m_r = pk.par_diffuse_padded_reference(m_r, aff, offs, 40, 56)
    torch.cuda.synchronize()
    assert torch.equal(m_k, m_r)


def test_denormalize_images_card_equals_cpu():
    """The PAR guidance of training on every byte value: the card's
    float64 products and sums round as the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from excel_tpu_torch.engine.pipeline import (denormalize_images,
                                                 normalize_images)

    u8 = torch.arange(256, dtype=torch.uint8)[None, :, None].expand(
        1, 256, 3).contiguous()
    cpu = denormalize_images(normalize_images(u8))
    card = denormalize_images(normalize_images(u8.cuda())).cpu()
    assert torch.equal(cpu, card)


# ---------------------------------------------------------------------------
# the mean-field CRF's message pass (row 5 at 72 offsets, fp32 and bf16) and
# the MSC shapes' launch attribution
# ---------------------------------------------------------------------------

def _crf_inputs(gen, c, dtype):
    from excel_tpu_torch.ops.crf_tpu import DEFAULT_DILATIONS
    from excel_tpu_torch.ops.crf_tpu import _offsets as crf_offsets

    offs = crf_offsets(DEFAULT_DILATIONS)
    q = torch.rand((2, c, 40, 300), device="cuda", generator=gen)
    q = (q / q.sum(dim=1, keepdim=True)).to(dtype)
    aff = torch.rand((2, len(offs), 40, 300), device="cuda", generator=gen)
    aff = (4.0 * aff / aff.sum(dim=1, keepdim=True)).to(dtype)
    return q, aff, pk.offsets_tensor(offs, "cuda")


# 1 to 81 channels: one to 21 channel passes, the last one partly filled
@pytest.mark.parametrize("c", [1, 2, 3, 8, 9, 21, 81])
def test_par_diffuse_bf16_kernel_bitwise(gen, c):
    """The bf16 entry point against its plain version (products rounded to
    bf16, fp32 sums in chunks of 8, a bf16 running output), bit for bit,
    at the CRF's 72 offsets with a pad (55) beyond the canvas height."""
    q, aff, offsets = _crf_inputs(gen, c, torch.bfloat16)
    with launches() as counts:
        got = pk.par_diffuse(q, aff, offsets)
        ref = pk.par_diffuse_reference(q, aff, offsets)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, ref)
    assert counts == {"excel_par_diffuse_bf16": 1}


def test_par_diffuse_fp32_kernel_at_crf_offsets_bitwise(gen):
    q, aff, offsets = _crf_inputs(gen, 21, torch.float32)
    got = pk.par_diffuse(q, aff, offsets)
    torch.cuda.synchronize()
    assert torch.equal(got, pk.par_diffuse_reference(q, aff, offsets))
    with pytest.raises(ValueError, match="share a dtype"):
        pk.par_diffuse(q, aff.bfloat16(), offsets)


@pytest.mark.parametrize("msg_dtype", [None, torch.bfloat16])
def test_crf_meanfield_card_matches_cpu(gen, msg_dtype):
    """The whole mean-field (valid extents, coarse level, 3 iterations) on
    the card (message pass through the kernel) against the CPU (its plain
    version). The build's exp and rsqrt differ by ulps between the devices:
    Q within 1e-4, argmax agreement >= 0.999."""
    from excel_tpu_torch.ops.crf_tpu import crf_meanfield

    img = torch.randint(0, 256, (2, 48, 160, 3), device="cuda",
                        generator=gen, dtype=torch.uint8)
    probs = torch.rand((2, 6, 48, 160), device="cuda", generator=gen) ** 3
    probs = probs / probs.sum(dim=1, keepdim=True)
    valid = torch.tensor([[48, 160], [37, 101]], device="cuda",
                         dtype=torch.int32)
    kw = dict(iters=3, msg_dtype=msg_dtype, coarse_stride=8)
    with launches() as counts:
        card = crf_meanfield(img, probs, valid_hw=valid, **kw).cpu()
    assert counts == {build.typed("excel_par_diffuse",
                                  msg_dtype or torch.float32): 3}
    cpu = crf_meanfield(img.cpu(), probs.cpu(), valid_hw=valid.cpu(), **kw)
    assert (card.argmax(1) == cpu.argmax(1)).float().mean() >= 0.999
    torch.testing.assert_close(card, cpu, atol=1e-4, rtol=0)


@pytest.mark.parametrize("tokens", [197, 577, 901])
def test_attention_none_mode_at_msc_tokens(gen, tokens):
    """Mode "none" (MSC's: no weights, surgery without ex) at the token
    counts of MSC scales 0.7, 1.2 and 1.5, bf16 and fp32, one launch of
    each entry point a call."""
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn((1, 12, tokens, 64), device="cuda",
                               generator=gen).to(dtype) for _ in range(3))
        with launches() as counts:
            ctx, w = ak.fused_plain_attention(q, k, v, need_weights=False)
            shared, attn, ctx_ori = ak.fused_surgery_attention(
                q, k, v, need_attn=False)
        torch.cuda.synchronize()
        assert w is None and attn is None
        assert counts == {build.typed("excel_plain_attention", dtype): 1,
                          build.typed("excel_surgery_attention", dtype): 1}
        ref_ctx, _ = ak.plain_attention_reference(q, k, v,
                                                  need_weights=False)
        ref_shared, _, ref_ori = ak.surgery_attention_reference(
            q, k, v, need_attn=False)
        _ctx_close(ctx, ref_ctx, q, k, v)
        _ctx_close(ctx_ori, ref_ori, q, k, v)
        torch.testing.assert_close(shared, ref_shared, atol=ATOL, rtol=0)


# -- pad-clamp and affinity: edges of their tiles and vectors ---------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pad", [3, 8, 16, 24])
@pytest.mark.parametrize("w", [61, 200, 512])
def test_pad_clamp_kernel_edges_bitwise(gen, dtype, pad, w):
    """16-byte vectors where P and W are multiples of the vector (4 fp32, 8
    bf16), the element path elsewhere (pad 3, w = 61); extents of the whole
    image, a ragged part and a single pixel."""
    x = torch.rand((3, 2, 40, w), device="cuda", generator=gen).to(dtype)
    valid = torch.tensor([[40, w], [25, w * 2 // 3 + 1], [1, 1]],
                         device="cuda", dtype=torch.int32)
    got = pk.pad_replicate_valid(x, valid, pad)
    ref = pk.pad_replicate_valid_reference(x, valid, pad)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pad_clamp_kernel_unaligned_and_on_a_side_stream(gen, dtype):
    """An input one element past a 16-byte boundary takes the element path;
    a launch on a side stream gives the same bits."""
    x, valid = _canvas(gen, dtype)
    big = torch.empty((x.numel() + 1,), device="cuda", dtype=dtype)
    x_u = big[1:].view(x.shape).copy_(x)
    ref = pk.pad_replicate_valid_reference(x, valid, 24)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got_u = pk.pad_replicate_valid(x_u, valid, 24)
        got_s = pk.pad_replicate_valid(x, valid, 24)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert torch.equal(got_u, ref) and torch.equal(got_s, ref)


def _affinity_dilations(k, pad):
    """Dilations of K = 8 x their count offsets whose reach is `pad`."""
    return {8: (), 16: (1,), 48: (1, 2, 3, 4, 5),
            64: (1, 2, 3, 4, 5, 6, 7)}[k] + (pad,)


def _affinity_inputs(gen, k, pad, h, w, slack=True):
    """A padded fp32 image of 3 images of h x w (extents: whole, ragged, one
    pixel), with (slack) or without the canvas's alignment slack."""
    dil = _affinity_dilations(k, pad)
    img = torch.rand((3, 3, h, w), device="cuda", generator=gen)
    valid = torch.tensor([[h, w], [max(h * 2 // 3, 1), max(w // 2, 1)],
                          [1, 1]], device="cuda", dtype=torch.int32)
    hp, wp = pk.padded_shape(h, w, pad) if slack else (h + 2 * pad,
                                                       w + 2 * pad)
    ip = pk._clamped_gather(img, valid, pad, hp, wp).contiguous()
    return ip, _offsets(dil), [float(p) for p in _pos_weight(dil)]


def _affinity_close(ip, offs, pos_w, h, w):
    """The kernel against its plain version run on the CPU, within one bf16
    ulp (exp differs by an fp32 ulp). On the CPU the plain version divides
    by K as the kernel does (IEEE division); on the card PyTorch multiplies
    by 1/K, and where the neighbours' variance cancels to nearly 0 (the
    replicated border) that ulp scales the logits, which the far offsets'
    tiny affinities show unmasked by their position terms (2 of 325,008
    values beyond one bf16 ulp at K=48, pad 24, 37 x 61)."""
    got = pk.par_affinity(ip, offs, pos_w, h, w)
    ref = pk.par_affinity_reference(ip.cpu(), offs, pos_w, h, w)
    torch.testing.assert_close(got.float().cpu(), ref.float(),
                               atol=BF16_ATOL, rtol=BF16_RTOL)
    return got


@pytest.mark.parametrize("slack", [True, False])
@pytest.mark.parametrize("pad", [8, 16, 24])
@pytest.mark.parametrize("k", [8, 16, 48, 64])
def test_affinity_kernel_edges(gen, k, pad, slack):
    """Within one bf16 ulp of the plain version (see test_affinity_kernel)
    for K = 8 ... 64 and pads 8 ... 24, at 40 x 200 (a ragged last tile
    down and across) and 37 x 61 (odd: bf16 pairs stored one by one), on a
    canvas with and without slack (an odd Wp: 61 + 2P)."""
    for h, w in ((40, 200), (37, 61)):
        _affinity_close(*_affinity_inputs(gen, k, pad, h, w, slack), h, w)


@pytest.mark.parametrize("pad,tiling", [(30, (8, 9216)), (33, (32, 19328)),
                                        (46, (16, 19328)), (52, (8, 19328))])
def test_affinity_kernel_smaller_tiles(gen, pad, tiling):
    """Pads whose slabs take 8- and 16-row tiles or the large channel
    plane (one block an SM); a pad beyond 52, where no slab fits, runs the
    direct kernel."""
    assert pk.affinity_tiling(pad) == tiling
    _affinity_close(*_affinity_inputs(gen, 8, pad, 40, 70), 40, 70)
    ip, offs, pos_w = _affinity_inputs(gen, 8, 53, 20, 30)
    with launches() as counts:
        _affinity_close(ip, offs, pos_w, 20, 30)
    assert counts == {"excel_par_affinity_direct_bf16": 1}


def _direct_affinity(ip, offs, pos_w, h, w):
    """The direct kernel through its entry point, at any shape."""
    out = torch.empty((ip.shape[0], len(offs), h, w), device="cuda",
                      dtype=torch.bfloat16)
    build.launch("excel_par_affinity_direct_bf16", ip, ip.data_ptr(),
                 pk.offsets_tensor(offs, "cpu").data_ptr(),
                 pk.position_terms(pos_w, 0.01, "cpu").data_ptr(),
                 out.data_ptr(), ip.shape[0], h, w, ip.shape[2], ip.shape[3],
                 len(offs), max(max(abs(d) for d in o) for o in offs), 0.3)
    return out


@pytest.mark.parametrize("k,pad", [(8, 56), (48, 64), (64, 56), (72, 24),
                                   (72, 40), (128, 64)])
def test_affinity_direct_kernel(gen, k, pad):
    """The direct kernel (pads the slab does not take, K beyond 64): within
    one bf16 ulp of the plain version (see test_affinity_kernel) at 40 x 200
    and 37 x 61, with and without the canvas's slack."""
    dil = {8: (), 48: (1, 2, 3, 4, 5), 64: (1, 2, 3, 4, 5, 6, 7),
           72: (1, 2, 3, 4, 5, 6, 7, 8), 128: tuple(range(1, 16))}[k] + (pad,)
    for h, w in ((40, 200), (37, 61)):
        for slack in (True, False):
            img = torch.rand((3, 3, h, w), device="cuda", generator=gen)
            valid = torch.tensor([[h, w], [h * 2 // 3, w // 2], [1, 1]],
                                 device="cuda", dtype=torch.int32)
            hp, wp = pk.padded_shape(h, w, pad) if slack else (
                h + 2 * pad, w + 2 * pad)
            ip = pk._clamped_gather(img, valid, pad, hp, wp).contiguous()
            offs = _offsets(dil)
            assert len(offs) == k
            assert pk.affinity_kernel(pad, k) == "direct"
            _affinity_close(ip, offs, [float(p) for p in _pos_weight(dil)],
                            h, w)


@pytest.mark.parametrize("k,pad", [(8, 8), (48, 24), (64, 52)])
def test_affinity_direct_kernel_equals_slab_kernel_bitwise(gen, k, pad):
    """Where both kernels take the shape, the same arithmetic gives the
    same bits, rare sums included (values near 1e-28, a spike of 1e12)."""
    h, w = 37, 200
    ip, offs, pos_w = _affinity_inputs(gen, k, pad, h, w)
    for img in (ip, ip * 1e-28, ip * 0 + 0.5):
        if img[0, 0, 0, 0] == 0.5:
            img[:, :, pad + 7, pad + 9] = 1e12
        slab = pk.par_affinity(img, offs, pos_w, h, w)
        direct = _direct_affinity(img, offs, pos_w, h, w)
        torch.cuda.synchronize()
        assert torch.equal(slab.isnan(), direct.isnan())
        assert torch.equal(slab.nan_to_num(), direct.nan_to_num())


def test_affinity_kernel_unaligned_side_stream_and_device_tables(gen):
    """An image one float past a 16-byte boundary; two launches and a
    launch on a side stream give the same bits; the entry point takes the
    offsets and position terms from device memory too (its copy waits for
    the stream) with the same result."""
    h, w, pad = 40, 200, 24
    ip, offs, pos_w = _affinity_inputs(gen, 48, pad, h, w)
    big = torch.empty((ip.numel() + 1,), device="cuda")
    ip_u = big[1:].view(ip.shape).copy_(ip)
    got = _affinity_close(ip_u, offs, pos_w, h, w)
    again = pk.par_affinity(ip, offs, pos_w, h, w)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        on_side = pk.par_affinity(ip, offs, pos_w, h, w)
    torch.cuda.current_stream().wait_stream(side)
    out = torch.empty_like(got)
    build.launch("excel_par_affinity_bf16", ip, ip.data_ptr(),
                 pk.offsets_tensor(offs, "cuda").data_ptr(),
                 pk.position_terms(pos_w, 0.01, "cuda").data_ptr(),
                 out.data_ptr(), ip.shape[0], h, w, ip.shape[2], ip.shape[3],
                 len(offs), pad, 0.3)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(got, on_side)
    assert torch.equal(got, out)


def test_affinity_kernel_rare_sums(gen):
    """Pixels whose sums of squared differences are subnormal (an image of
    values near 1e-28) or infinite (a spike of 1e12 on a flat image: its
    logits are -inf, its affinities NaN in both versions) take the
    kernel's out-of-line division by 3; a flat image (every sum 0) its
    fast one."""
    h, w, pad = 40, 200, 24
    ip, offs, pos_w = _affinity_inputs(gen, 48, pad, h, w)
    for img in (ip * 1e-28, torch.full_like(ip, 0.25), ip * 0 + 0.5):
        if img[0, 0, 0, 0] == 0.5:
            img[:, :, pad + 7, pad + 9] = 1e12
        got = pk.par_affinity(img, offs, pos_w, h, w)
        ref = pk.par_affinity_reference(img.cpu(), offs, pos_w, h, w)
        torch.testing.assert_close(got.float().cpu(), ref.float(),
                                   atol=BF16_ATOL, rtol=BF16_RTOL,
                                   equal_nan=True)


def test_to_device_stages_through_pinned_memory(gen):
    """The sweeps' host-to-card copies: equal arrays on the card, the
    staging tensor pinned (an asynchronous copy)."""
    import numpy as np

    from excel_tpu_torch.engine import evaluate as pev

    rng = np.random.default_rng(0)
    arrays = (rng.random((4, 64, 64, 3), dtype=np.float32),
              rng.integers(0, 255, (4, 96, 128)).astype(np.int32))
    pinned = []
    real = torch.Tensor.pin_memory

    def pin(self, *a, **k):
        out = real(self, *a, **k)
        pinned.append(out.is_pinned())
        return out

    torch.Tensor.pin_memory = pin
    try:
        got = pev._to_device(arrays, torch.device("cuda"))
    finally:
        torch.Tensor.pin_memory = real
    torch.cuda.synchronize()
    assert pinned == [True, True]
    for a, g in zip(arrays, got):
        assert g.is_cuda
        assert np.array_equal(g.cpu().numpy(), a)


# the fast preset's PAR beyond the affinity slab: pad 56 (K=56) and nine
# dilations (K=72, pad 40) take the padded route, as every 8-aligned pad
# does: pad-clamp, the direct affinity kernel, the resident diffusion with
# its table of up to 128 offsets; card against the CPU within one bf16 ulp
# of masks in [1, 2) (the affinities differ by a bf16 ulp at most,
# test_affinity_kernel; the diffusion agrees bit for bit)
@pytest.mark.parametrize("dil", [(1, 2, 4, 8, 12, 24, 56),
                                 (1, 2, 4, 8, 12, 16, 24, 32, 40)])
def test_par_refine_bf16_large_pads_card_matches_cpu(gen, dil):
    from excel_tpu_torch.ops.par import bf16_route, par_refine

    assert bf16_route(dil) == "padded"
    img = torch.randn((2, 3, 96, 128), device="cuda", generator=gen)
    masks = torch.rand((2, 5, 96, 128), device="cuda", generator=gen)
    valid = torch.tensor([[96, 128], [70, 101]], dtype=torch.int32,
                         device="cuda")
    with launches() as counts:
        got = par_refine(img, masks, dilations=dil, num_iter=20,
                         valid_hw=valid, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert counts == {"excel_pad_clamp_f32": 1, "excel_pad_clamp_bf16": 1,
                      "excel_par_affinity_direct_bf16": 1,
                      "excel_par_diffuse_valid_resident_bf16": 1}
    ref = par_refine(img.cpu(), masks.cpu(), dilations=dil, num_iter=20,
                     valid_hw=valid.cpu(), dtype=torch.bfloat16)
    torch.testing.assert_close(got.cpu(), ref, atol=2.0 ** -7, rtol=0)


@pytest.mark.parametrize("c", [1, 5, 9])
def test_diffuse_valid_resident_72_offsets_bitwise(gen, c):
    """Resident == plain version bit for bit at K=72 (nine dilations), the
    offset table beyond its former 64 entries, for 1 and 20 steps."""
    dil = (1, 2, 4, 8, 12, 16, 24, 32, 40)
    mp, aff, valid, offs = _diffuse_valid_case(gen, c, 200, dil)
    assert len(offs) == 72
    for n in (1, 20):
        res = pk.par_diffuse_valid_resident(mp, aff, valid, offs, 40, 200, n)
        ref = pk.par_diffuse_valid_resident_reference(mp, aff, valid, offs,
                                                      40, 200, n)
        torch.cuda.synchronize()
        assert torch.equal(res, ref), n


# -- the seg loss's upsample backward (csrc/upsample_linear.cu) --------------

# (B, C, h, w, H, W): the fast train step's logits [4, 21, 20, 20] -> 320
# and COCO's [4, 81, 28, 28] -> 448; 1 and 3 planes; factors 1, 2 and 16;
# unequal factors; widths that are no multiple of 4 (4-byte loads); 70
# columns at factor 32, whose output columns take two tiles of the kernel
UPSAMPLE_SHAPES = [(4, 21, 20, 20, 320, 320), (4, 81, 28, 28, 448, 448),
                   (1, 1, 5, 7, 5, 7), (1, 3, 6, 4, 12, 8),
                   (1, 3, 3, 5, 48, 80), (2, 3, 4, 5, 12, 35),
                   (1, 3, 7, 3, 14, 21), (1, 2, 3, 70, 6, 2240)]
# fp32 sums of up to ~4 s_y s_x terms in another order: 2e-6 of each cell's
# summed term magnitudes (the CPU's autograd reads at most 3.3e-7 of it
# against float64; one wrong tap weight, ~1e-3)
UPSAMPLE_TOL = 2e-6


def _upsample_close(got, g, in_hw, ref) -> None:
    from excel_tpu_torch.ops import upsample_kernels as uk

    gc = g.cpu()
    wy = uk.linear_taps(in_hw[0], g.shape[-2]).double()
    wx = uk.linear_taps(in_hw[1], g.shape[-1]).double()
    mag = torch.einsum("bcyx,xj,yi->bcij", gc.double().abs(), wx, wy)
    assert ((got.cpu().double() - ref.cpu().double()).abs()
            <= UPSAMPLE_TOL * mag).all()


@pytest.mark.parametrize("b,c,h,w,big_h,big_w", UPSAMPLE_SHAPES)
def test_upsample_linear_backward_kernel(gen, b, c, h, w, big_h, big_w):
    """The gather against its plain version and against F.interpolate's own
    autograd gradient (atomics); two launches give the same bits."""
    import torch.nn.functional as F

    from excel_tpu_torch.ops import upsample_kernels as uk

    g = torch.randn((b, c, big_h, big_w), device="cuda", generator=gen)
    with launches() as counts:
        got = uk.upsample_linear_backward(g, (h, w))
        again = uk.upsample_linear_backward(g, (h, w))
    x = torch.zeros((b, c, h, w), device="cuda", requires_grad=True)
    F.interpolate(x, size=(big_h, big_w), mode="bilinear",
                  align_corners=False).backward(g)
    torch.cuda.synchronize()
    assert counts == {"excel_upsample_linear_bwd_f32": 2}
    assert got.shape == (b, c, h, w) and torch.equal(got, again)
    _upsample_close(got, g, (h, w),
                    uk.upsample_linear_backward_reference(g.cpu(), (h, w)))
    _upsample_close(got, g, (h, w), x.grad)


def test_upsample_linear_backward_unaligned_side_stream_and_autograd(gen):
    """A gradient one element past a 16-byte boundary takes the 4-byte
    loads, a launch on a side stream gives the same bits, and
    `upsample_linear`'s autograd runs the kernel once a backward."""
    from excel_tpu_torch.ops import labels as plab
    from excel_tpu_torch.ops import upsample_kernels as uk

    g = torch.randn((4, 21, 320, 320), device="cuda", generator=gen)
    big = torch.empty((g.numel() + 1,), device="cuda")
    g_u = big[1:].view(g.shape).copy_(g)
    ref = uk.upsample_linear_backward(g, (20, 20))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got_u = uk.upsample_linear_backward(g_u, (20, 20))
        got_s = uk.upsample_linear_backward(g, (20, 20))
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert torch.equal(got_s, ref)
    _upsample_close(got_u, g, (20, 20), ref)

    x = torch.randn((4, 21, 20, 20), device="cuda", generator=gen,
                    requires_grad=True)
    with launches() as counts:
        plab.upsample_linear(x, (320, 320)).backward(g)
    torch.cuda.synchronize()
    assert counts == {"excel_upsample_linear_bwd_f32": 1}
    assert torch.equal(x.grad, ref)


# -- the encoder's residual add + LayerNorm (csrc/layer_norm.cu) -------------

# (B, N, C): ViT-B/16's lam batch [4, 401, 768] and ViT-H/14's [4, 577,
# 1280], the MSC token counts 197 and 901 at B=8 (2 x 4 images), and a
# ragged row count (21: the last block's rows half used) at a width that
# leaves lanes idle (160: 20 bf16 vectors, 40 fp32)
LN_SHAPES = [(4, 401, 768), (4, 577, 1280), (8, 197, 768), (8, 901, 768),
             (3, 7, 160), (4, 729, 1152), (4, 730, 1152), (3, 7, 144)]
# the normalised rows against the plain version's on the card, whose mean
# and variance are PyTorch's reductions in another order: fp32 within 2e-6
# of the output's largest magnitude; bf16 at most one bf16 ulp of the
# element apart, plus LN_BF16_CANCEL of the output's largest magnitude, and
# at least 99% of the elements equal. The second term: the two fp32 means
# and rsqrts differ by a few fp32 ulps, so the fp32 rows differ by ~1e-7 of
# their terms, and where (s - mean) rstd scale and bias cancel, the result
# is so small that this exceeds one bf16 ulp of it (on the card 0.99998 of
# the elements are equal, and 0-2 a tensor lie beyond one ulp, at |out|
# <= 3.5e-6)
LN_F32_TOL = 2e-6
LN_BF16_CANCEL = 2.0 ** -20
LN_BF16_MIN_EQUAL = 0.99


def _ln_inputs(gen, shape, dtype):
    from excel_tpu_torch.models import layers as L

    c = shape[-1]
    x = (3.0 * torch.randn(shape, device="cuda", generator=gen) + 0.5)
    y = torch.randn(shape, device="cuda", generator=gen)
    p = {"scale": 1.0 + 0.1 * torch.randn(c, device="cuda", generator=gen),
         "bias": 0.1 * torch.randn(c, device="cuda", generator=gen)}
    return L, x.to(dtype), y.to(dtype), p


def _ln_close(got, ref) -> None:
    if got.dtype == torch.float32:
        assert (got - ref).abs().max() <= LN_F32_TOL * ref.abs().max()
        return
    g, r = got.float(), ref.float()
    big = torch.maximum(g.abs(), r.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
    assert ((g - r).abs() <= ulp + LN_BF16_CANCEL * r.abs().max()).all()
    assert float((got == ref).float().mean()) >= LN_BF16_MIN_EQUAL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("residual", [True, False],
                         ids=["residual", "plain"])
@pytest.mark.parametrize("b,n,c", LN_SHAPES)
def test_layer_norm_kernel(gen, b, n, c, residual, dtype):
    """Both forms against the plain version (x + y then `layer_norm`) run
    on the card: the residual sums bit for bit, the normalised rows within
    the stated bound; two launches give the same bits."""
    L, x, y, p = _ln_inputs(gen, (b, n, c), dtype)
    with launches() as counts:
        if residual:
            s, out = L.add_layer_norm_fused(x, y, p)
            s2, out2 = L.add_layer_norm_fused(x, y, p)
            ref_s = x + y
        else:
            out, out2 = L.layer_norm_fused(x, p), L.layer_norm_fused(x, p)
            s = s2 = ref_s = x
    assert counts == {build.typed("excel_layer_norm", dtype): 2}
    ref = L.layer_norm(ref_s, p)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (b, n, c)
    assert torch.equal(s, ref_s) and torch.equal(s2, ref_s)
    assert torch.equal(out, out2)
    _ln_close(out, ref)


def test_layer_norm_kernel_unaligned_params_and_side_stream(gen):
    """scale and bias one float past a 16-byte boundary take the kernel's
    scalar loads and give the same bits; so does a launch on a side
    stream."""
    L, x, y, p = _ln_inputs(gen, (4, 577, 1280), torch.bfloat16)
    s, out = L.add_layer_norm_fused(x, y, p)
    big = torch.empty((2, 1281), device="cuda")
    pu = {"scale": big[0, 1:].copy_(p["scale"]),
          "bias": big[1, 1:].copy_(p["bias"])}
    assert pu["scale"].data_ptr() % 16 and pu["bias"].data_ptr() % 16
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        s_u, out_u = L.add_layer_norm_fused(x, y, pu)
        out_p = L.layer_norm_fused(s, p)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert torch.equal(s_u, s) and torch.equal(out_u, out)
    assert torch.equal(out_p, out)


def test_layer_norm_kernel_refuses_what_it_does_not_take(gen):
    L, x, y, p = _ln_inputs(gen, (2, 9, 768), torch.bfloat16)
    flat = torch.empty((x.numel() + 1,), device="cuda", dtype=x.dtype)
    unaligned = flat[1:].view(x.shape).copy_(x)
    with pytest.raises(ValueError, match="16-byte"):
        L.layer_norm_fused(unaligned, p)
    with pytest.raises(ValueError, match="16-byte"):
        L.add_layer_norm_fused(x, unaligned, p)
    with pytest.raises(ValueError, match="contiguous"):
        L.add_layer_norm_fused(x.transpose(0, 1), y.transpose(0, 1), p)
    with pytest.raises(ValueError, match="shape"):
        L.add_layer_norm_fused(x, y[:, :8], p)
    for c, dtype in ((100, torch.bfloat16), (4104, torch.bfloat16),
                     (2056, torch.float32), (6, torch.float32)):
        z = torch.zeros((2, 3, c), device="cuda", dtype=dtype)
        q = {"scale": torch.ones(c, device="cuda"),
             "bias": torch.zeros(c, device="cuda")}
        with pytest.raises(ValueError, match="width"):
            L.layer_norm_fused(z, q)
    with pytest.raises(NotImplementedError):
        L.layer_norm_fused(x.half(), p)
    with pytest.raises(ValueError, match="scale and bias"):
        L.layer_norm_fused(x, {"scale": p["scale"][:700],
                               "bias": p["bias"][:700]})


@pytest.mark.parametrize("tower", ["openai-vit-b-16", "openclip-vit-h-14"])
def test_vision_forward_launches_the_layer_norm_kernel(gen, tower):
    """The tiny towers' fp32 forward on the card: 2L + 2 launches a pass (3
    plain, the rest with the residual add), and the outputs of the plain
    chain of kernels within 1e-5 of their largest magnitude."""
    import dataclasses

    from excel_tpu_torch.config import tiny_config, with_backbone
    from excel_tpu_torch.models import clip as clip_mod
    from excel_tpu_torch.models import layers as L
    from excel_tpu_torch.models.params import init_clip_params

    cfg = with_backbone(tiny_config(), tower, tiny=True).clip
    cfg = dataclasses.replace(cfg, attn_out_layers=2)
    params = init_clip_params(cfg, torch.Generator().manual_seed(0),
                              device="cuda")
    for ln in [params["visual"]["ln_pre"], params["visual"]["ln_post"]] + [
            blk[k] for blk in params["visual"]["blocks"]
            for k in ("ln_1", "ln_2")]:
        ln["scale"] += 0.1 * torch.randn(ln["scale"].shape, device="cuda",
                                         generator=gen)
        ln["bias"] += 0.1 * torch.randn(ln["bias"].shape, device="cuda",
                                        generator=gen)
    images = torch.randn((2, cfg.image_size, cfg.image_size, 3),
                         device="cuda", generator=gen)
    with pytest.MonkeyPatch.context() as mp:
        plain = spy(mp, clip_mod, "layer_norm_fused")
        residual = spy(mp, clip_mod, "add_layer_norm_fused")
        with launches() as counts:
            got = clip_mod.vision_forward(params, images, cfg,
                                          attn_mode="mean")
    assert (len(plain), len(residual)) == (3, 2 * cfg.vision_layers - 1)
    assert counts["excel_layer_norm_f32"] == 2 * cfg.vision_layers + 2

    def add_ln(x, y, p, eps=1e-5):
        return x + y, L.layer_norm(x + y, p, eps)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(clip_mod, "layer_norm_fused", L.layer_norm)
        mp.setattr(clip_mod, "add_layer_norm_fused", add_ln)
        want = clip_mod.vision_forward(params, images, cfg, attn_mode="mean")
    torch.cuda.synchronize()
    for key in ("projected", "attn", "feats"):
        err = (got[key] - want[key]).abs().max() / want[key].abs().max()
        assert float(err) <= 1e-5, key


# -- the encoder's qkv bias add and head split (csrc/qkv_heads.cu) -----------

# (B, N, 3C, H): ViT-B/16's lam batch (D = 64), ViT-H/14's (D = 80), the
# MSC scale 1.5 at B=8 (2 x 4 images), and tiny ragged ones: one token,
# and tails of the 64-token tiles at D = 80 and 64 (17, 65 tokens), D = 32
QKV_SHAPES = [(4, 401, 2304, 12), (4, 577, 3840, 16), (8, 901, 2304, 12),
              (1, 1, 192, 2), (2, 17, 480, 2), (3, 65, 576, 3),
              (2, 63, 288, 3), (4, 729, 3456, 16), (2, 17, 432, 2),
              (3, 65, 216, 1)]


def _qkv_inputs(gen, b, n, c3, dtype):
    from excel_tpu_torch.models import layers as L

    c = c3 // 3
    y = torch.randn((b, n, c), device="cuda", generator=gen).to(dtype)
    p = {"qkv": {"w": (c ** -0.5 * torch.randn(
        (c3, c), device="cuda", generator=gen)).to(dtype),
        "b": 0.1 * torch.randn(c3, device="cuda", generator=gen)}}
    return L, y, p


def _qkv_bitwise(got, want, dtype) -> None:
    b, h, n, d = want[0].shape
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == (b, h, n, d)
        assert g.is_contiguous()
        assert torch.equal(g, w)
    # q, k, v: the three slices of one [3, B, H, N, D] buffer
    step = b * h * n * d * g.element_size()
    assert [t.data_ptr() - got[0].data_ptr() for t in got] == [0, step,
                                                               2 * step]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,n,c3,heads", QKV_SHAPES)
def test_qkv_heads_kernel_bitwise(gen, b, n, c3, heads, dtype):
    """The kernel against its plain version on the card (`qkv_projection`:
    the same product, PyTorch's bias add and three head-split copies) bit
    for bit, one launch a call."""
    L, y, p = _qkv_inputs(gen, b, n, c3, dtype)
    with launches() as counts:
        got = L.qkv_heads_fused(y, p, heads)
    want = L.qkv_projection(y, p, heads)
    torch.cuda.synchronize()
    assert counts == {build.typed("excel_qkv_heads", dtype): 1}
    _qkv_bitwise(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_qkv_heads_kernel_on_a_side_stream(gen, dtype):
    L, y, p = _qkv_inputs(gen, 4, 577, 3840, dtype)
    want = L.qkv_projection(y, p, 16)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = L.qkv_heads_fused(y, p, 16)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    _qkv_bitwise(got, want, dtype)


def test_qkv_heads_kernel_refuses_what_it_does_not_take(gen):
    L, y, p = _qkv_inputs(gen, 2, 9, 576, torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        L.qkv_heads_fused(y, p, 4)              # D = 48
    with pytest.raises(NotImplementedError):
        L.qkv_heads_fused(y.half(), p, 3)
    with pytest.raises(ValueError, match="bias"):
        L.qkv_heads_fused(y, {"qkv": dict(p["qkv"], b=p["qkv"]["b"][:575])},
                          3)
    big = torch.empty(577, device="cuda", dtype=torch.bfloat16)
    unaligned = big[1:].copy_(p["qkv"]["b"])
    with pytest.raises(RuntimeError, match="excel_qkv_heads_bf16"):
        L.qkv_heads_fused(y, {"qkv": dict(p["qkv"], b=unaligned)}, 3)


def _head_major(fn, i):
    """An attention wrapper whose context (output i) is laid out [B, H, N,
    D] as the kernels wrote it before their token-major store, so that
    `merge_heads` copies it."""
    def wrapper(*args, **kwargs):
        out = list(fn(*args, **kwargs))
        out[i] = out[i].contiguous()
        return tuple(out)
    return wrapper


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("tower", ["openai-vit-b-16", "openclip-vit-h-14"])
def test_vision_forward_keeps_the_head_split_chains_bits(gen, tower, dtype):
    """A pass at full width and depth on a small image (ViT-B/16 at 64 px,
    ViT-H/14 at 56 px: 17 tokens; seeded weights) through the qkv kernel and the
    token-major contexts gives the bits of the chain it replaced on the
    card: `qkv_projection` (PyTorch's bias add and head-split copies) and
    contexts laid out [B, H, N, D], merged by a copy. The qkv kernel
    launches L times a pass (32 a ViT-H pass)."""
    import dataclasses

    from excel_tpu_torch.config import voc_config, with_backbone
    from excel_tpu_torch.models import clip as clip_mod
    from excel_tpu_torch.models import layers as L
    from portbench.harness import weights as W

    cfg = with_backbone(voc_config(), tower).clip
    cfg = dataclasses.replace(cfg, image_size=4 * cfg.patch_size,
                              compute_dtype=dtype)
    params = W.clip_visual(cfg, 31, "cuda")
    images = torch.randn((2, cfg.image_size, cfg.image_size, 3),
                         device="cuda", generator=gen)
    with launches() as counts:
        got = clip_mod.vision_forward(params, images, cfg, attn_mode="mean")
    assert counts[build.typed("excel_qkv_heads", dtype)] == cfg.vision_layers
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(L, "qkv_heads_fused", L.qkv_projection)
        mp.setattr(L, "fused_plain_attention",
                   _head_major(L.fused_plain_attention, 0))
        mp.setattr(L, "fused_surgery_attention",
                   _head_major(L.fused_surgery_attention, 2))
        want = clip_mod.vision_forward(params, images, cfg, attn_mode="mean")
    torch.cuda.synchronize()
    for key in ("projected", "attn", "feats"):
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key


# -- EVA-02: the rotating head split (csrc/qkv_heads.cu's rope entry points)
# and the SwiGLU gate with its sub-LayerNorm (csrc/swiglu_gate.cu) ----------

# (B, N, 3C, H, grid): EVA-02-L/14's lam batch (D = 64, 24 x 24 patches),
# an MSC-like grid (10 x 10), and ragged ones: one patch, tails of the
# 64-token tiles at D = 32 and 80, a grid that is not square
ROPE_SHAPES = [(4, 577, 3072, 16, (24, 24)), (8, 101, 3072, 16, (10, 10)),
               (1, 2, 192, 1, (1, 1)), (3, 65, 192, 2, (8, 8)),
               (2, 17, 480, 2, (4, 4)), (2, 63, 384, 2, (2, 31))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,n,c3,heads,grid", ROPE_SHAPES)
def test_qkv_heads_rope_kernel_bitwise(gen, b, n, c3, heads, grid, dtype):
    """The rotating entry point against its plain version on the card
    (`qkv_projection` with the table: PyTorch's bias add, head-split
    copies and `apply_rope`'s fp32 products and sum) bit for bit, the CLS
    token and v unturned, one launch a call; the same bits twice."""
    L, y, p = _qkv_inputs(gen, b, n, c3, dtype)
    rope = L.rope_table(16, grid[0], grid[1], c3 // (3 * heads), y.device)
    with launches() as counts:
        got = L.qkv_heads_fused(y, p, heads, rope)
        again = L.qkv_heads_fused(y, p, heads, rope)
    want = L.qkv_projection(y, p, heads, rope)
    plain = L.qkv_projection(y, p, heads)
    torch.cuda.synchronize()
    assert counts == {build.typed("excel_qkv_heads_rope", dtype): 2}
    _qkv_bitwise(got, want, dtype)
    _qkv_bitwise(again, want, dtype)
    assert torch.equal(got[2], plain[2])
    for t, u in zip(got[:2], plain[:2]):
        assert torch.equal(t[:, :, 0], u[:, :, 0])
        # the patch at row 0, column 0 turns by 0: one patch stays as it is
        assert torch.equal(t[:, :, 1], u[:, :, 1])
        if n > 2:
            assert not torch.equal(t[:, :, 2:], u[:, :, 2:])


def test_qkv_heads_rope_kernel_on_a_side_stream_and_refusals(gen):
    L, y, p = _qkv_inputs(gen, 4, 577, 3072, torch.bfloat16)
    rope = L.rope_table(16, 24, 24, 64, y.device)
    want = L.qkv_projection(y, p, 16, rope)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = L.qkv_heads_fused(y, p, 16, rope)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    _qkv_bitwise(got, want, torch.bfloat16)
    for bad in (rope[:, :575], rope.double(), rope[..., :32],
                rope.transpose(1, 2).contiguous().transpose(1, 2)):
        with pytest.raises(ValueError, match="rotary table"):
            L.qkv_heads_fused(y, p, 16, bad)


# (rows, h, hp): EVA-02-L/14's lam batch padded as served, MSC-sized rows,
# a hidden with no padding, the tiny tower's odd 341 padded to 344, one
# row, the widest (4,096) and a width of one; hp a whole number of 16-byte
# vectors in both dtypes (models/params.pad_swiglu)
GATE_SHAPES = [(2308, 2730, 2736), (808, 2730, 2736), (5, 2736, 2736),
               (7, 341, 344), (1, 5, 8), (3, 4096, 4096), (2, 1, 8)]


def _gate_inputs(gen, rows, h, hp, dtype):
    from excel_tpu_torch.models import layers as L

    u = torch.randn((rows, 2 * hp), device="cuda", generator=gen)
    bias = 0.1 * torch.randn(2 * hp, device="cuda", generator=gen)
    u[:, h:hp] = 0.0
    u[:, hp + h:] = 0.0
    bias[h:hp] = 0.0
    bias[hp + h:] = 0.0
    ln = {"scale": 1.0 + 0.1 * torch.randn(h, device="cuda", generator=gen),
          "bias": 0.1 * torch.randn(h, device="cuda", generator=gen)}
    return L, u.to(dtype), bias.to(dtype), ln


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("rows,h,hp", GATE_SHAPES)
def test_swiglu_gate_kernel(gen, rows, h, hp, dtype):
    """The gate and sub-LayerNorm against its plain version on the card
    (`swiglu_gate`: PyTorch's bias add, silu, product and `layer_norm`)
    within the LayerNorm kernel's bound (`_ln_close`: the two means and
    rsqrts are sums in another order), the padding columns exactly 0, one
    launch a call, the same bits twice."""
    L, u, bias, ln = _gate_inputs(gen, rows, h, hp, dtype)
    with launches() as counts:
        got = L.swiglu_gate_fused(u, bias, ln)
        again = L.swiglu_gate_fused(u, bias, ln)
    want = L.swiglu_gate(u, bias, ln)
    torch.cuda.synchronize()
    assert counts == {build.typed("excel_swiglu_gate", dtype): 2}
    assert got.dtype == dtype and got.shape == (rows, hp)
    assert torch.equal(got, again)
    assert not got[:, h:].any()
    if h > 1:
        _ln_close(got[:, :h], want[:, :h])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_swiglu_gate_kernel_batched_and_side_stream(gen, dtype):
    """A [B, N, 2 hp] product on a side stream: the bits of the flat
    launch on the default stream."""
    L, u, bias, ln = _gate_inputs(gen, 2 * 577, 2730, 2736, dtype)
    want = L.swiglu_gate_fused(u, bias, ln)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got_b = L.swiglu_gate_fused(u.view(2, 577, -1), bias, ln)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert got_b.shape == (2, 577, 2736)
    assert torch.equal(got_b.view(want.shape), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_swiglu_gate_kernel_takes_16_byte_rows_only(gen, dtype):
    """The unpadded hidden (2,730: 5,460 bytes a bf16 row) and a product
    one element past a 16-byte boundary are refused before a launch."""
    L, u, bias, ln = _gate_inputs(gen, 4, 2730, 2730, dtype)
    with launches() as counts:
        with pytest.raises(ValueError, match="16-byte"):
            L.swiglu_gate_fused(u, bias, ln)
        _, u, bias, ln = _gate_inputs(gen, 4, 2730, 2736, dtype)
        flat = torch.empty(u.numel() + 1, device="cuda", dtype=dtype)
        shifted = flat[1:].view(u.shape).copy_(u)
        assert shifted.data_ptr() % 16
        with pytest.raises(ValueError, match="16-byte"):
            L.swiglu_gate_fused(shifted, bias, ln)
    assert counts == {}


def test_swiglu_gate_kernel_refuses_what_it_does_not_take(gen):
    L, u, bias, ln = _gate_inputs(gen, 4, 341, 344, torch.bfloat16)
    with pytest.raises(ValueError, match="h <= hp"):
        L.swiglu_gate_fused(u[:, :680].contiguous(), bias[:680], ln)
    with pytest.raises(ValueError, match="contiguous"):
        L.swiglu_gate_fused(u.t().contiguous().t(), bias, ln)
    with pytest.raises(ValueError, match="bias"):
        L.swiglu_gate_fused(u, bias[:687], ln)
    with pytest.raises(NotImplementedError):
        L.swiglu_gate_fused(u.half(), bias, ln)
    wide = torch.zeros((2, 2 * 4104), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="4096"):
        L.swiglu_gate_fused(wide, wide[0], {
            "scale": torch.ones(4104, device="cuda"),
            "bias": torch.zeros(4104, device="cuda")})


# -- the encoder MLP's fc bias add and activation (csrc/fc_act.cu) ----------

# (B, N, hidden): ViT-B/16's lam batch, ViT-H/14's, and ragged ones: 7
# rows at ViT-H's hidden, and a hidden of 33 bf16 / 66 fp32 vectors (no
# whole number of a block's 128)
FC_ACT_SHAPES = [(4, 401, 3072), (4, 577, 5120), (1, 7, 5120), (3, 5, 264),
                 (4, 729, 4304), (4, 1, 4304)]


def _fc_act_inputs(gen, b, n, hidden, dtype):
    """The fc product at 4x the unit scale, its first 65,536 elements every
    bf16 bit pattern (NaN and the infinities as 0, clamped to +-128, so
    that exp(-1.702 z) overflows and underflows and the subnormals occur),
    and a bias at 0.1x the unit scale."""
    from excel_tpu_torch.models import layers as L

    u = 4.0 * torch.randn((b, n, hidden), device="cuda", generator=gen)
    edge = torch.arange(-32768, 32768, device="cuda", dtype=torch.int32)
    edge = (edge.to(torch.int16).view(torch.bfloat16).float()
            .nan_to_num(0.0, 0.0, 0.0).clamp(-128.0, 128.0))
    flat = u.view(-1)
    k = min(flat.numel(), edge.numel())
    flat[:k] = edge[:k]
    bias = 0.1 * torch.randn(hidden, device="cuda", generator=gen)
    return L, u.to(dtype), bias.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("act", ["quick_gelu", "gelu", "gelu_tanh"])
@pytest.mark.parametrize("b,n,hidden", FC_ACT_SHAPES)
def test_fc_act_kernel_bitwise(gen, b, n, hidden, act, dtype):
    """The kernel against its plain version on the card (PyTorch's bias
    add, then `ACTIVATIONS[act]`: QuickGELU's seven eager passes or
    F.gelu, exact or approximate="tanh") bit for bit, one launch a call,
    the same bits twice."""
    L, u, bias = _fc_act_inputs(gen, b, n, hidden, dtype)
    with launches() as counts:
        got = L.fc_act_fused(u, bias, act)
        again = L.fc_act_fused(u, bias, act)
    want = L.ACTIVATIONS[act](u + bias)
    torch.cuda.synchronize()
    assert counts == {build.typed("excel_fc_act", dtype): 2}
    assert got.dtype == dtype and got.shape == (b, n, hidden)
    assert torch.equal(got, again)
    assert torch.equal(got, want)


@pytest.mark.parametrize("act", ["quick_gelu", "gelu", "gelu_tanh"])
def test_fc_act_kernel_bitwise_at_every_bf16_value(gen, act):
    """In bf16 the output is a function of z = T(u + b) alone: with a zero
    bias, every finite bf16 value of u (as a [256, 256] product) gives the
    plain chain's bits, compared as 16-bit words (the zeros' signs too)."""
    from excel_tpu_torch.models import layers as L

    u = torch.arange(-32768, 32768, device="cuda", dtype=torch.int32).to(
        torch.int16).view(torch.bfloat16).reshape(256, 256)
    u = torch.where(u.isfinite(), u, torch.zeros_like(u))
    bias = torch.zeros(256, device="cuda", dtype=torch.bfloat16)
    got = L.fc_act_fused(u, bias, act)
    want = L.ACTIVATIONS[act](u + bias)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_fc_act_kernel_flat_and_on_a_side_stream(gen, dtype):
    """A [rows, hidden] product on a side stream, and an fp32 bias that
    the wrapper rounds to the product's type: the bits of the batched
    launch on the default stream."""
    L, u, bias = _fc_act_inputs(gen, 2, 577, 5120, dtype)
    want = L.fc_act_fused(u, bias, "gelu")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = L.fc_act_fused(u.view(-1, 5120), bias.float(), "gelu")
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert torch.equal(got.view(want.shape), want)


def test_fc_act_kernel_refuses_what_it_does_not_take(gen):
    L, u, bias = _fc_act_inputs(gen, 2, 9, 256, torch.bfloat16)
    with launches() as counts:
        with pytest.raises(ValueError, match="activation"):
            L.fc_act_fused(u, bias, "relu")
        with pytest.raises(NotImplementedError):
            L.fc_act_fused(u.half(), bias, "gelu")
        with pytest.raises(ValueError, match="contiguous"):
            L.fc_act_fused(u.transpose(0, 1), bias, "gelu")
        with pytest.raises(ValueError, match="bias"):
            L.fc_act_fused(u, bias[:255], "gelu")
        with pytest.raises(ValueError, match="16-byte"):
            L.fc_act_fused(u[..., :250].contiguous(), bias[:250], "gelu")
        flat = torch.empty(u.numel() + 1, device="cuda", dtype=u.dtype)
        shifted = flat[1:].view(u.shape).copy_(u)
        with pytest.raises(ValueError, match="16-byte"):
            L.fc_act_fused(shifted, bias, "gelu")
        with pytest.raises(ValueError, match="backward"):
            L.fc_act_fused(u.float().requires_grad_(), bias, "gelu")
        with torch.no_grad():
            L.fc_act_fused(u.float().requires_grad_(), bias, "gelu")
    assert counts == {"excel_fc_act_f32": 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("tower", ["openai-vit-b-16", "openclip-vit-h-14"])
def test_vision_forward_keeps_the_mlp_chains_bits(gen, tower, dtype):
    """A pass at full width and depth on a small image (ViT-B/16 at 64 px,
    ViT-H/14 at 56 px: 17 tokens; seeded weights) through the fc_act
    kernel gives the bits of the chain it replaced on the card
    (`layers.mlp`: PyTorch's bias add and activation passes)."""
    import dataclasses

    from excel_tpu_torch.config import voc_config, with_backbone
    from excel_tpu_torch.models import clip as clip_mod
    from excel_tpu_torch.models import layers as L
    from portbench.harness import weights as W

    cfg = with_backbone(voc_config(), tower).clip
    cfg = dataclasses.replace(cfg, image_size=4 * cfg.patch_size,
                              compute_dtype=dtype)
    params = W.clip_visual(cfg, 31, "cuda")
    images = torch.randn((2, cfg.image_size, cfg.image_size, 3),
                         device="cuda", generator=gen)
    got = clip_mod.vision_forward(params, images, cfg, attn_mode="mean")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(clip_mod, "mlp", L.mlp)
        want = clip_mod.vision_forward(params, images, cfg, attn_mode="mean")
    torch.cuda.synchronize()
    for key in ("projected", "attn", "feats"):
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key


# launches of one vision pass by C entry point, at 17 tokens, by tower:
# ViT-B/16 and ViT-H/14 as before EVA-02 came (12 / 32 qkv head splits,
# 7 + 5 / 27 + 5 attention kernels, 2L + 2 LayerNorms) and an fc_act pass
# a block (12 / 32); EVA-02-L/14: 24 rotating head splits, 19 + 5
# attention kernels, 24 gates, and 78 LayerNorms (no ln_pre: 2L - 1
# residual, block 0's ln_1, ln_post, and an ln_inner a context: 19 + 2 x
# 5), and no fc_act (its SwiGLU's gate takes fc's bias); SigLIP So400m/14
# at 16 tokens (no CLS): 27 head splits, 22 + 5 attention kernels, 57
# LayerNorms (2L - 1 residual, block 0's ln_1, ln_post of both streams and
# the attention-pooling head's ln) and 28 fc_act passes (27 blocks and the
# head's MLP over its pooled and patch rows at once)
PASS_LAUNCHES = {
    "openai-vit-b-16": {"qkv_heads": 12, "plain_attention": 7,
                        "surgery_attention": 5, "layer_norm": 26,
                        "fc_act": 12},
    "openclip-vit-h-14": {"qkv_heads": 32, "plain_attention": 27,
                          "surgery_attention": 5, "layer_norm": 66,
                          "fc_act": 32},
    "eva02-clip-l-14-336": {"qkv_heads_rope": 24, "plain_attention": 19,
                            "surgery_attention": 5, "layer_norm": 78,
                            "swiglu_gate": 24},
    "siglip-so400m-14-384": {"qkv_heads": 27, "plain_attention": 22,
                             "surgery_attention": 5, "layer_norm": 57,
                             "fc_act": 28},
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("tower", sorted(PASS_LAUNCHES))
def test_vision_forward_launches_by_entry_point(gen, tower, dtype):
    """One pass at full width and depth on a small image (17 tokens,
    seeded weights served as the CLIs serve them) launches exactly
    PASS_LAUNCHES[tower] a pass; EVA-02's and SigLIP's outputs within 1e-5
    (fp32) or 0.05 (bf16: the LayerNorms' sums in another order move a
    bf16 ulp, 2^-8, here and there through 24 or 27 blocks) of their
    largest magnitude of the same pass through the plain versions of the
    head split and of EVA-02's gate or SigLIP's MLP chain (EVA-02's bf16
    reads 0.021 in `feats`)."""
    import dataclasses

    from excel_tpu_torch.config import voc_config, with_backbone
    from excel_tpu_torch.models import clip as clip_mod
    from excel_tpu_torch.models import layers as L
    from excel_tpu_torch.models.params import (cast_matmul_weights,
                                               pad_swiglu)
    from portbench.harness import weights as W
    from portbench.harness import weights_eva02, weights_siglip

    cfg = with_backbone(voc_config(), tower).clip
    cfg = dataclasses.replace(cfg, image_size=4 * cfg.patch_size,
                              compute_dtype=dtype)
    draw = {"eva02": weights_eva02, "siglip": weights_siglip}.get(cfg.block,
                                                                  W)
    params = pad_swiglu(draw.clip_visual(cfg, 31, "cuda"))
    if dtype == torch.bfloat16:
        params = cast_matmul_weights(params, dtype)
    images = torch.randn((2, cfg.image_size, cfg.image_size, 3),
                         device="cuda", generator=gen)
    with launches() as counts:
        got = clip_mod.vision_forward(params, images, cfg, attn_mode="mean")
    want_counts = {build.typed("excel_" + k, dtype): v
                   for k, v in PASS_LAUNCHES[tower].items()}
    assert counts == want_counts
    if cfg.block == "vit":
        return
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(L, "qkv_heads_fused", L.qkv_projection)
        mp.setattr(L, "swiglu_gate_fused", L.swiglu_gate)
        mp.setattr(clip_mod, "mlp", L.mlp)
        want = clip_mod.vision_forward(params, images, cfg, attn_mode="mean")
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 0.05
    for key in ("projected", "attn", "feats"):
        err = (got[key].float() - want[key].float()).abs().max() \
            / want[key].float().abs().max()
        assert float(err) <= tol, (key, float(err))
