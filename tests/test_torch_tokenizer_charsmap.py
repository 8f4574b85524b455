"""The t5 tokenizer's last steps against the JAX package's: the Precompiled
charsmap normalizer, byte fallback, and the cached HF tokenizer's
``tokenizer.json``.

The real t5-base ``spiece.model`` is not in the repository, so the
synthesized model carries a charsmap that the port's own darts builder
writes (``models/sentencepiece.build_charsmap``, ``SYNTHETIC_CHARSMAP``):
curly quotes, NBSP, full-width letters, ligatures, an ellipsis, a
zero-width space, tabs and newlines, and a decomposed e + combining acute.

- The port's normalizer equals ``tokenizers.normalizers.Precompiled`` on
  that charsmap over hypothesis-drawn strings of mapped and unmapped
  characters (combining marks and emoji among them, so the grapheme
  clusters matter).
- Ids, attention masks and word ids equal JAX's ``SentencePieceTokenizer``
  for a charsmap model, a byte-fallback model and one with both, and JAX's
  ``HFTokenizer`` for a ``tokenizer.json`` that ``tokenizers`` saved.
- ``make_tokenizer`` picks JAX's class for each asset layout.
"""
import os
import warnings

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from tokenizers import normalizers

from convofusion_tpu.models import sentencepiece as jax_sp
from convofusion_tpu.models import tokenizer as jax_tok
from convofusion_tpu_torch.models import sentencepiece as sp
from convofusion_tpu_torch.models import tokenizer as tok

PAD_TO = 48
TEXTS = [
    "It’s “fine”, café and naïve",
    "ﬁne ﬂat ＡＢＣ ｘ … good night",
    "café résumé ​zero width\ttab\nnewline",
    "日本語 ü ß à \U0001F600 emoji",
    "a</s>b <extra_id_3> ‘quoted’", "plain ascii text", "",
    "  runs   of    spaces  ", tok.UNCOND_TEXT,
]
# characters the charsmap maps, and others it leaves alone
MAPPED = sorted(set("".join(sp.SYNTHETIC_CHARSMAP)))
UNMAPPED = list("abcxyz ,.'-éüß中́̈‍") \
    + ["\U0001F600", "\U0001F3FB", "\r", "가", "ᄀ", "ᅡ"]


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    root = tmp_path_factory.mktemp("charsmap")
    paths = {}
    for name, kw in (("charsmap", dict(charsmap=True)),
                     ("bytes", dict(byte_fallback=True)),
                     ("both", dict(charsmap=True, byte_fallback=True))):
        paths[name] = sp.write_synthetic_spiece(
            str(root / name / "spiece.model"), **kw)
    return paths


def _assert_same(a, b):
    np.testing.assert_array_equal(a.input_ids, b.input_ids)
    np.testing.assert_array_equal(a.attention_mask, b.attention_mask)
    assert a.word_ids == b.word_ids


def test_charsmap_round_trip():
    """Each source string maps to its target through the trie; a
    malformed charsmap is refused."""
    blob = sp.build_charsmap(sp.SYNTHETIC_CHARSMAP)
    pre = sp.Precompiled(blob)
    for src, dst in sp.SYNTHETIC_CHARSMAP.items():
        assert pre.transform(src) == dst, src
    assert pre.transform("a") is None and pre.transform("é") is None
    for bad in (b"", b"\x00" * 16, b"\x08\x00\x00\x00\x00"):
        with pytest.raises(ValueError):
            sp.Precompiled(bad)


@settings(max_examples=300, deadline=None)
@given(st.lists(st.sampled_from(MAPPED + UNMAPPED), max_size=16))
def test_normalizer_equals_tokenizers_precompiled(chars):
    text = "".join(chars)
    blob = sp.build_charsmap(sp.SYNTHETIC_CHARSMAP)
    want = normalizers.Precompiled(blob).normalize_str(text)
    assert sp.precompiled(blob).normalize(text) == want


@pytest.mark.parametrize("name", ["charsmap", "bytes", "both"])
def test_ids_masks_and_word_ids_equal_jax(models, name):
    a = tok.SentencePieceTokenizer(models[name], max_length=PAD_TO)
    b = jax_tok.SentencePieceTokenizer(models[name], max_length=PAD_TO)
    _assert_same(a(TEXTS, pad_to=PAD_TO), b(TEXTS, pad_to=PAD_TO))
    _assert_same(a(TEXTS), b(TEXTS))
    assert a.vocab_size == b.vocab_size


@pytest.mark.parametrize("name", ["charsmap", "bytes"])
def test_tokenizer_json_equals_jax_hf_tokenizer(models, name, tmp_path):
    """A ``tokenizer.json`` saved by ``tokenizers`` (through transformers'
    ``save_pretrained`` of the JAX package's fast tokenizer), read by the
    port in pure Python."""
    with open(models[name], "rb") as f:
        fast = jax_sp.convert_t5_fast(jax_sp.parse_model_proto(f.read()))
    fast.save_pretrained(str(tmp_path))
    assert os.path.isfile(tmp_path / "tokenizer.json")
    a = tok.HFTokenizer(str(tmp_path), max_length=PAD_TO)
    b = jax_tok.HFTokenizer(str(tmp_path), max_length=PAD_TO)
    _assert_same(a(TEXTS, pad_to=PAD_TO), b(TEXTS, pad_to=PAD_TO))
    _assert_same(a(TEXTS), b(TEXTS))
    assert a.vocab_size == b.vocab_size


def test_make_tokenizer_picks_jax_class(models, tmp_path, monkeypatch):
    """The three layouts of a model directory, in JAX's order: its
    spiece.model, else its cached HF tokenizer (``tokenizer.json``), else
    the word-hash fallback with a warning; and the asset drop's
    ``t5-base/spiece.model`` for the bare name."""
    monkeypatch.setenv("CONVOFUSION_TPU_ASSETS", str(tmp_path / "assets"))

    def picked(path):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return (type(tok.make_tokenizer(path, 16)).__name__,
                    type(jax_tok.make_tokenizer(path, 16)).__name__)

    model_dir = tmp_path / "t5"
    model_dir.mkdir()
    assert picked(str(model_dir)) == ("WordHashTokenizer",
                                      "WordHashTokenizer")
    with open(models["charsmap"], "rb") as f:
        spiece = f.read()
    jax_sp.convert_t5_fast(jax_sp.parse_model_proto(spiece)).save_pretrained(
        str(model_dir))
    assert picked(str(model_dir)) == ("HFTokenizer", "HFTokenizer")
    (model_dir / "spiece.model").write_bytes(spiece)
    assert picked(str(model_dir)) == ("SentencePieceTokenizer",
                                      "SentencePieceTokenizer")
    drop = tmp_path / "assets" / "t5-base"
    drop.mkdir(parents=True)
    (drop / "spiece.model").write_bytes(spiece)
    assert picked("t5-base") == ("SentencePieceTokenizer",
                                 "SentencePieceTokenizer")


def test_tokenizer_json_in_the_hf_cache(models, tmp_path, monkeypatch):
    """The HF cache's snapshot layout, ``$HF_HOME/hub/models--t5-base/
    snapshots/<rev>/tokenizer.json``, for the bare model name."""
    monkeypatch.setenv("CONVOFUSION_TPU_ASSETS", str(tmp_path / "assets"))
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    assert tok.find_tokenizer_json("t5-base") is None
    snap = tmp_path / "hf" / "hub" / "models--t5-base" / "snapshots" / "a1"
    with open(models["charsmap"], "rb") as f:
        jax_sp.convert_t5_fast(jax_sp.parse_model_proto(
            f.read())).save_pretrained(str(snap))
    assert tok.find_tokenizer_json("t5-base") == str(snap / "tokenizer.json")
    assert isinstance(tok.make_tokenizer("t5-base", 16), tok.HFTokenizer)
