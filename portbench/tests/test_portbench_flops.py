"""The operation and byte counts against hand counts."""

import pytest

from portbench.tests.common import ROOT  # noqa: F401
from portbench.harness import flops as F
from portbench.harness import peaks

def _clip():
    from excel_tpu_torch.config import voc_config
    return voc_config().clip

def test_encoder_flops_by_hand():
    c = _clip()
    n, w = 401, 768
    plain = 2 * n * w * 3 * w + 2 * 2 * n * n * w + 2 * n * w * w \
        + 2 * 2 * n * w * 4 * w
    surgery = 2 * n * w * 3 * w + 4 * 2 * n * n * w + 2 * n * n * w \
        + 2 * n * n * w + 2 * 2 * n * w * w + 2 * 2 * n * w * 4 * w
    patch = 2 * 400 * w * 768
    want = patch + 7 * plain + 5 * surgery + 2 * n * w * 512
    assert F.encoder_flops(c, 320) == pytest.approx(want, rel=1e-12)
    assert 80e9 < want < 84e9

def test_attention_layer_counts_by_hand():
    b, n, c = 4, 401, 768
    f, nb = F.attention_layer("plain", b, n, c, "bfloat16", True, False)
    assert f == b * (2 * n * c * 3 * c + 2 * 2 * n * n * c + 2 * n * c * c)
    assert nb == (2 * b * n * c * 2 + (4 * c * c + 4 * c) * 2
                  + 2 * b * n * n * 4)
    f2, nb2 = F.attention_layer("surgery", b, n, c, "bfloat16", False, True)
    assert f2 == b * (2 * n * c * 3 * c + 6 * 2 * n * n * c
                      + 2 * 2 * n * c * c)
    assert nb2 == (3 * b * n * c * 2 + (4 * c * c + 4 * c) * 2
                   + b * (n - 1) ** 2 * 2)

def test_par_layer_counts_by_hand():
    f, nb = F.par_layer(4, 5, 320, 320, 48, 20)
    px = 4 * 320 * 320
    assert nb == 4 * px * (3 + 5 + 5)
    assert f == px * (48 * 30 + 18 + 20 * 48 * 5 * 2)

def test_head_and_svc_flops_by_hand():
    from excel_tpu_torch.config import voc_config
    h = voc_config().head
    m, d, c = 400, 256, 768
    want = 12 * (2 * m * c * d + 2 * m * d * d) + 2 * m * 12 * d * d \
        + 3 * (2 * m * d * 3 * d + 2 * 2 * m * m * d + 2 * m * d * d
               + 2 * 2 * m * d * 4 * d) + 2 * m * d * 21
    assert F.head_flops(h, m, 21) == pytest.approx(want, rel=1e-12)
    assert F.svc_flops(400, 3) == 2 * 400 ** 3 + 2 * 400 * 400 * 3

def test_bound_takes_the_larger():
    assert peaks.bound_s(989e12, 1.0, 989e12) == (1.0, "operations")
    assert peaks.bound_s(1.0, 3.35e12, 989e12) == (1.0, "bytes")
