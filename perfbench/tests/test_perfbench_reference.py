"""The plain reference against the program on the CPU at a tiny size in
fp32: the tokenizer exactly, sampling and the first training steps to
rounding, through the harness's own drivers."""
import numpy as np
import pytest

from perfbench import harness
from perfbench.tests import tiny
from perfbench import traffic
from perfbench.reference.tokenizer import Tokenizer, write_spiece

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


def test_tokenizer_matches_the_program(tmp_path):
    from convofusion_tpu_torch.models.tokenizer import SentencePieceTokenizer

    path = write_spiece(str(tmp_path / "spiece.model"))
    texts = traffic.synthetic_texts(np.random.default_rng(3), 300) + [
        "-" * 10, "hello   world ", "xyzq!! zz", "a"]
    theirs = SentencePieceTokenizer(path, max_length=64)(texts, pad_to=64)
    ids, valid = Tokenizer(path)(texts, 64)
    np.testing.assert_array_equal(theirs.input_ids, ids)
    np.testing.assert_array_equal(theirs.attention_mask, valid)


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_program(cell, tmp_path):
    out = harness.run(tiny.context(cell, tmp_path))
    readings = out["rec"]["readings"]
    assert out["correct"], readings
    for name, value in readings.items():
        assert value <= 1e-4, (name, value)
