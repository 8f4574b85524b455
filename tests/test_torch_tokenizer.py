"""The port's SentencePiece tokenizer against the JAX package's.

JAX's ``SentencePieceTokenizer`` runs the ``tokenizers`` pipeline that
transformers' T5Converter builds (``convert_t5_fast``); the port's runs a
pure-Python copy of it (``models/sentencepiece.T5Pipeline``).  Both read
the same ``spiece.model``: the toy model of ``tests/test_tokenizer.py`` and
the synthesized 32k t5-geometry model.  Ids, attention masks and word ids
must be equal exactly (a word id off by one would move WEG's excited
token, ``focus_word_indices``), with and without ``pad_to``.
"""
import os
import random
import warnings

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from convofusion_tpu.models import tokenizer as jax_tok
from convofusion_tpu.models.sentencepiece import (
    write_synthetic_spiece as jax_write_synthetic,
)
from convofusion_tpu_torch.models import sentencepiece as sp
from convofusion_tpu_torch.models import tokenizer as tok
from test_tokenizer import toy_model

PAD_TO = 64
TEXTS = [
    "hello world", "so that the good thing", "Hello, World!",
    "Wait... WHAT?! (no way)", "it's 10:45 on 2024-03-01 and 99% sure",
    "  runs   of    spaces  ", "trailing spaces and tabs \t\n",
    "tab\tinside and new\nline", "unknown ~^|` chars {fused} [x]",
    "zzzqqq xxjj", "a</s>b", "<bos> literal <eos>", "x<unk>y",
    "hello<extra_id_0>world", "hello <extra_id_10> x",
    tok.UNCOND_TEXT, "", " ", "---", "A", "9",
    "the quick brown fox jumps over the lazy dog " * 12,
]


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    root = tmp_path_factory.mktemp("spiece")
    toy = root / "toy" / "spiece.model"
    toy.parent.mkdir()
    toy.write_bytes(sp.serialize_model_proto(toy_model()))
    synth = jax_write_synthetic(str(root / "t5" / "spiece.model"))
    return {"toy": str(toy), "synth": synth}


@pytest.fixture(scope="module")
def pairs(models):
    """(JAX, port) tokenizers per model, max_length 64 (the text pad)."""
    return {name: (jax_tok.SentencePieceTokenizer(path, max_length=PAD_TO),
                   tok.SentencePieceTokenizer(path, max_length=PAD_TO))
            for name, path in models.items()}


def _assert_same(a, b):
    np.testing.assert_array_equal(a.input_ids, b.input_ids)
    assert a.input_ids.dtype == b.input_ids.dtype == np.int32
    np.testing.assert_array_equal(a.attention_mask, b.attention_mask)
    assert a.word_ids == b.word_ids


@pytest.mark.parametrize("pad_to", [PAD_TO, 16, None])
@pytest.mark.parametrize("name", ["toy", "synth"])
def test_batch_matches_jax(pairs, name, pad_to):
    """Every text of TEXTS in one batch: ids, masks and word ids equal.
    The long text overruns 64 tokens: both keep the template's </s>."""
    j, p = pairs[name]
    a, b = j(TEXTS, pad_to=pad_to), p(TEXTS, pad_to=pad_to)
    _assert_same(a, b)
    long_row = len(TEXTS) - 1
    n = int(b.attention_mask[long_row].sum())
    assert n == (pad_to or PAD_TO)
    assert b.input_ids[long_row, n - 1] == p.tok.convert_tokens_to_ids("</s>")
    assert b.word_ids[long_row][n - 1] is None
    assert j.wrapped_texts(TEXTS) == p.wrapped_texts(TEXTS)


@pytest.mark.parametrize("name", ["toy", "synth"])
def test_special_ids_and_vocab_match_jax(pairs, name):
    """The runtime additions: <eos> and <bos> after the extra ids (32100
    and 32101 on a t5-geometry model), the same id space."""
    j, p = pairs[name]
    assert p.vocab_size == j.vocab_size
    for t in ("<pad>", "</s>", "<unk>", "<eos>", "<bos>", "<extra_id_0>",
              "<extra_id_99>"):
        assert p.tok.convert_tokens_to_ids(t) == \
            j.tok.convert_tokens_to_ids(t), t
    if name == "synth":
        assert p.tok.convert_tokens_to_ids("<eos>") == 32100
        assert p.tok.convert_tokens_to_ids("<bos>") == 32101


def test_word_ids_contract(pairs):
    """tests/test_tokenizer.py:62-98's contract on the port: <bos> is word
    0, content words from 1, subwords share their word, </s> is None."""
    _, p = pairs["toy"]
    tb = p(["hello world", "so that the good thing"], pad_to=16)
    assert tb.word_ids[0][:5] == [0, 1, 2, 3, None]
    assert tb.word_ids[1][:10] == [0, 1, 2, 3, 4, 4, 5, 5, 5, 6]
    maps = tb.word_map(p.wrapped_texts(["hello world",
                                        "so that the good thing"]))
    assert maps[0][:5] == ["<bos>", "hello", "world", "<eos>", ""]


@settings(max_examples=60, deadline=None)
@given(st.lists(st.text(alphabet=st.characters(max_codepoint=127),
                        max_size=40), min_size=1, max_size=4))
def test_random_ascii_matches_jax(pairs, texts):
    for j, p in pairs.values():
        _assert_same(j(texts, pad_to=None), p(texts, pad_to=None))


def test_viterbi_matches_tokenizers_unigram():
    """The port's UnigramEncoder against ``tokenizers``' Unigram on random
    vocabularies with unknown characters (unk fusion)."""
    from tokenizers import Tokenizer
    from tokenizers.models import Unigram

    rng = random.Random(0)
    chars = "abcdef"
    vocab, seen = [("<unk>", 0.0)], {"<unk>"}
    for _ in range(200):
        piece = "".join(rng.choice(chars) for _ in range(rng.randint(1, 4)))
        if piece not in seen:
            seen.add(piece)
            vocab.append((piece, -rng.random() * 8 - 0.1))
    for c in chars + sp.META:
        if c not in seen:
            seen.add(c)
            vocab.append((c, -10.0 - rng.random()))
    oracle = Tokenizer(Unigram(vocab, unk_id=0, byte_fallback=False))
    mine = sp.UnigramEncoder(vocab, unk_id=0)
    for _ in range(300):
        s = "".join(rng.choice(chars + "xz")
                    for _ in range(rng.randint(1, 30)))
        assert oracle.encode(s, add_special_tokens=False).ids == \
            mine.encode(s), s


def test_proto_round_trip_and_synthesis_match_jax(models):
    """The reader and writer on the toy model, and the synthesized model
    byte for byte the JAX package's."""
    from convofusion_tpu.models import sentencepiece as jax_sp

    with open(models["toy"], "rb") as f:
        data = f.read()
    m = sp.parse_model_proto(data)
    assert vars(m) == vars(jax_sp.parse_model_proto(data))
    assert m.pieces == toy_model().pieces
    assert sp.serialize_model_proto(m) == data
    with open(models["synth"], "rb") as f:
        assert sp.serialize_model_proto(sp.synthesize_spiece_model()) == \
            f.read()
    for text in ("hello world!", "a\tb\nc", "ﬁx", "a b​c"):
        assert sp.nmt_nfkc_normalize(text) == jax_sp.nmt_nfkc_normalize(text)


def test_charsmap_model_refuses_what_it_cannot_normalize(tmp_path):
    """A model with a Precompiled charsmap (the synthesized one's mappings
    on the toy vocab) tokenizes printable ASCII as without one, and the
    characters the port once refused exactly as JAX does; a charsmap whose
    trie is empty (on which ``tokenizers`` panics at the first text) is
    refused when the tokenizer is built."""
    model = toy_model()
    plain = tmp_path / "plain.model"
    plain.write_bytes(sp.serialize_model_proto(model))
    model.precompiled_charsmap = sp.build_charsmap(sp.SYNTHETIC_CHARSMAP)
    charsmap = tmp_path / "charsmap.model"
    charsmap.write_bytes(sp.serialize_model_proto(model))
    a = tok.SentencePieceTokenizer(str(plain), max_length=32)
    b = tok.SentencePieceTokenizer(str(charsmap), max_length=32)
    want = jax_tok.SentencePieceTokenizer(str(charsmap), max_length=32)
    _assert_same(a(["hello, world!"]), b(["hello, world!"]))
    texts = ["héllo", "tab\there", "ﬁx", "it’s “so”", "ｈｅｌｌｏ\u00a0x"]
    _assert_same(b(texts), want(texts))
    _assert_same(b(texts, pad_to=PAD_TO), want(texts, pad_to=PAD_TO))
    model.precompiled_charsmap = b"\x00" * 16
    broken = tmp_path / "broken.model"
    broken.write_bytes(sp.serialize_model_proto(model))
    with pytest.raises(ValueError, match="charsmap"):
        tok.SentencePieceTokenizer(str(broken), max_length=32)


def test_find_and_make_tokenizer(models, tmp_path, monkeypatch):
    """make_tokenizer: the asset drop's t5-base/spiece.model, a model
    directory, an HF cache snapshot; the word-hash fallback warns."""
    monkeypatch.setenv("CONVOFUSION_TPU_ASSETS", str(tmp_path / "assets"))
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    with pytest.warns(UserWarning, match="NOT match t5-base"):
        fallback = tok.make_tokenizer("t5-base", max_length=16)
    assert isinstance(fallback, tok.WordHashTokenizer)
    snap = tmp_path / "hf" / "hub" / "models--t5-base" / "snapshots" / "abc"
    snap.mkdir(parents=True)
    (snap / "spiece.model").write_bytes(open(models["toy"], "rb").read())
    assert tok.find_spiece("t5-base") == str(snap / "spiece.model")
    drop = tmp_path / "assets" / "t5-base"
    drop.mkdir(parents=True)
    (drop / "spiece.model").write_bytes(open(models["toy"], "rb").read())
    assert tok.find_spiece("t5-base") == str(drop / "spiece.model")
    assert tok.find_spiece(os.path.dirname(models["synth"])) == \
        models["synth"]
    assert isinstance(tok.make_tokenizer("t5-base", max_length=16),
                      tok.SentencePieceTokenizer)


def test_model_picks_its_tokenizer_as_jax_does(models, tmp_path,
                                                monkeypatch):
    """The repair: at the production vocab both packages build a
    SentencePiece tokenizer from $CONVOFUSION_TPU_ASSETS/t5-base/spiece.model
    and give equal prepare_text_batch arrays; a tiny vocab keeps the
    word-hash tokenizer; an explicit tokenizer wins."""
    import copy

    from convofusion_tpu.config.testing import tiny_config
    from convofusion_tpu.models.convofusion import Convofusion as JaxModel
    from convofusion_tpu_torch.config import TINY
    from convofusion_tpu_torch.models.convofusion import Convofusion

    drop = tmp_path / "t5-base"
    drop.mkdir()
    (drop / "spiece.model").write_bytes(open(models["synth"], "rb").read())
    monkeypatch.setenv("CONVOFUSION_TPU_ASSETS", str(tmp_path))
    jcfg = tiny_config("diffusion")
    jcfg.model.text_encoder.params["vocab_size"] = 32128
    pcfg = copy.deepcopy(TINY)
    pcfg["text_encoder"]["vocab_size"] = 32128
    jm = JaxModel(jcfg)
    pm = Convofusion(pcfg, device="cpu", seed=None)
    assert isinstance(jm.tokenizer, jax_tok.SentencePieceTokenizer)
    assert isinstance(pm.tokenizer, tok.SentencePieceTokenizer)
    spk = ["hello there friend", "we roll dice and laugh together"]
    lsn = ["a story about brave knights", ""]
    ja, _, jl = jm.prepare_text_batch(spk, lsn)
    pa, _, pl = pm.prepare_text_batch(spk, lsn)
    assert set(ja) == set(pa)
    for k in ja:
        np.testing.assert_array_equal(np.asarray(ja[k]), pa[k])
    assert jl.word_ids == pl.word_ids

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tiny = Convofusion(TINY, device="cpu", seed=None)
    assert isinstance(tiny.tokenizer, tok.WordHashTokenizer)
    mine = tok.WordHashTokenizer(vocab_size=1000, max_length=16)
    assert Convofusion(pcfg, device="cpu", seed=None,
                       tokenizer=mine).tokenizer is mine


def test_tokenizer_modules_import_no_tokenizer_packages():
    """The port's tokenizer stands alone: neither tokenizers, transformers
    nor sentencepiece is imported by its modules."""
    import ast
    import inspect

    for module in (sp, tok):
        tree = ast.parse(inspect.getsource(module))
        names = {alias.name.split(".")[0] for node in ast.walk(tree)
                 if isinstance(node, (ast.Import, ast.ImportFrom))
                 for alias in node.names}
        names |= {node.module.split(".")[0] for node in ast.walk(tree)
                  if isinstance(node, ast.ImportFrom) and node.module}
        assert not names & {"tokenizers", "transformers", "sentencepiece"}
