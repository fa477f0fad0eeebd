"""The port's tokenizer (excel_tpu_torch/text/tokenizer.py, no `regex`)
against the JAX package's (excel_tpu/text/tokenizer.py, `regex`): equal
token arrays, exactly, on every class and background name of both datasets,
their prompts, every shipped attribute descriptor and random Unicode text;
equal truncation and the same overflow error."""
import json
import os

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from excel_tpu.text import class_names as jax_names
from excel_tpu.text.tokenizer import _WORD_RE
from excel_tpu.text.tokenizer import tokenize as jax_tokenize
from excel_tpu_torch.text import class_names
from excel_tpu_torch.text.tokenizer import _split_words, get_tokenizer, tokenize

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _descriptors():
    out = []
    for name in ("pascal_voc", "ms_coco"):
        path = os.path.join(ROOT, "assets", "attributes",
                            f"{name}_descriptors.json")
        with open(path) as f:
            for strings in json.load(f).values():
                out += strings
    return out


def _names():
    out = []
    for ds in ("voc", "coco"):
        vocab = class_names.prompt_vocabulary(ds)
        assert vocab == jax_names.prompt_vocabulary(ds)
        out += vocab + class_names.class_list(ds)
        out += ["a clean origami {}.".format(n) for n in vocab]
    out += [t.format("cat") for t in class_names.IMAGENET_PROMPT_TEMPLATES]
    return out


@pytest.mark.parametrize("source", ["names_and_prompts", "descriptors"])
def test_tokens_equal_on_shipped_text(source):
    texts = _names() if source == "names_and_prompts" else _descriptors()
    assert len(texts) > 200
    got = tokenize(texts, truncate=True)
    ref = jax_tokenize(texts, truncate=True)
    assert got.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(got, ref)


def test_vocab_and_framing():
    tok = get_tokenizer()
    assert tok.vocab_size == 49408
    arr = tokenize(["a clean origami cat.", "it's 3 dogs & cats -- weird!"])
    assert arr.shape == (2, 77)
    assert (arr[:, 0] == tok.sot).all() and (arr.max(axis=1) == tok.eot).all()
    assert tok.decode(arr[0, 1:arr[0].argmax()]).strip() == \
        "a clean origami cat ."


def test_truncation_and_overflow():
    long = "cat " * 200 + "dog"
    np.testing.assert_array_equal(tokenize([long], truncate=True),
                                  jax_tokenize([long], truncate=True))
    assert tokenize([long], truncate=True)[0, -1] == get_tokenizer().eot
    with pytest.raises(RuntimeError, match="too long for context length"):
        tokenize([long])
    with pytest.raises(RuntimeError, match="too long for context length"):
        jax_tokenize([long])
    short = tokenize(["a cat"], context_length=8)
    np.testing.assert_array_equal(short, jax_tokenize(["a cat"],
                                                      context_length=8))


# Characters where a class test by `re` or by `str.isspace` alone would part
# from `regex`: No/Nl numbers, marks (U+0345 folds to a letter but is
# none of the classes), the long s that folds to 's', information
# separators that `str.isspace` calls spaces, letters assigned after this
# interpreter's Unicode version, html entities and contractions.
EDGE = ("\u00b2", "\u216b", "\u00bd", "\u0663", "\u0301", "\u0345",
        "\u017f", "\x1c", "\x1f", "\u00a0", "\u2028", "\U000105c0",
        "\U00010d40", "&amp;", "'S", "'ll", "'\u017f", "<|endoftext|>",
        "<|\u017ftartoftext|>", "\u01c5", "\u0130")


def test_split_words_on_edge_characters():
    for ch in EDGE:
        for text in (ch, "a" + ch + "b", ch + ch + "1" + ch, "'" + ch,
                     "x" + ch + "'re" + ch):
            assert _split_words(text) == _WORD_RE.findall(text), repr(text)


@settings(max_examples=300, deadline=None)
@given(st.lists(st.one_of(
    st.characters(codec="utf-8"),
    st.characters(whitelist_categories=("No", "Nl", "Nd", "Mn", "Lm", "Lo")),
    st.sampled_from(EDGE)), max_size=40).map("".join))
def test_tokens_equal_on_random_unicode(text):
    assert _split_words(text) == _WORD_RE.findall(text)
    np.testing.assert_array_equal(tokenize([text], truncate=True),
                                  jax_tokenize([text], truncate=True))
