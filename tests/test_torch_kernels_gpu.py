"""The port's CUDA kernels against their plain versions on a GPU.

These need a CUDA device and nvcc; elsewhere they skip. On a machine with
the card: python -m pytest -m cuda tests/test_torch_kernels_gpu.py -q
"""
import pytest
import torch

from excel_tpu_torch.models import attention_kernels as ak
from excel_tpu_torch.ops.par import _offsets, _replicate_valid
from excel_tpu_torch.ops import par_kernels as pk

pytestmark = pytest.mark.cuda

ATOL = 1e-4     # fp32 sums in another order


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU form)")
    return torch.Generator(device="cuda").manual_seed(0)


# N=17 and 197: tails of the 16/32-row query tiles and of the 64-key chunks
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
