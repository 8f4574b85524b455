"""The asset manifest (``utils/assets.py``: ``sha256``, ``freeze``,
``verify``, ``--freeze`` / ``--verify``) against JAX's on the same trees:
equal manifests, equal verdicts and equal exit codes, each side reading
the other's manifest too."""
import shutil

import pytest

from convofusion_tpu.utils import assets as jax_assets
from convofusion_tpu_torch.utils import assets

SIDES = {"port": assets, "jax": jax_assets}


def _tree(root):
    (root / "t5-base").mkdir(parents=True)
    (root / "t5-base" / "spiece.model").write_bytes(b"not a real model")
    (root / "eval").mkdir()
    (root / "eval" / "last_499.bin").write_bytes(bytes(range(256)) * 9)
    (root / "notes.txt").write_text("dropped by hand\n")
    return root


def _edit(root, step):
    """The same change on either side's tree."""
    if step == "change":
        (root / "t5-base" / "spiece.model").write_bytes(b"tampered bytes!!")
    elif step == "add":
        (root / "stray.txt").write_text("x")
    elif step == "delete":
        (root / "eval" / "last_499.bin").unlink()


def test_freeze_and_verify_equal_jax(tmp_path):
    roots = {s: _tree(tmp_path / s) for s in SIDES}
    manifests = {s: SIDES[s].freeze(str(roots[s])) for s in SIDES}
    assert manifests["port"] == manifests["jax"]
    assert sorted(manifests["port"]) == ["eval/last_499.bin", "notes.txt",
                                         "t5-base/spiece.model"]
    assert (roots["port"] / "MANIFEST.json").read_bytes() == \
        (roots["jax"] / "MANIFEST.json").read_bytes()
    assert assets.sha256(str(roots["port"] / "notes.txt")) == \
        jax_assets.sha256(str(roots["jax"] / "notes.txt"))
    for step in ("none", "change", "add", "delete"):
        for s in SIDES:
            _edit(roots[s], step)
        got = {s: SIDES[s].verify(str(roots[s])) for s in SIDES}
        assert got["port"] == got["jax"], step
        # each side reads the other's manifest
        assert assets.verify(str(roots["jax"])) == got["jax"]
        assert jax_assets.verify(str(roots["port"])) == got["port"]
    assert got["port"] == {"t5-base/spiece.model": "changed",
                           "stray.txt": "untracked",
                           "eval/last_499.bin": "missing",
                           "notes.txt": "ok"}


@pytest.mark.parametrize("side", sorted(SIDES))
def test_verify_without_a_manifest_raises(tmp_path, side):
    with pytest.raises(FileNotFoundError):
        SIDES[side].verify(str(_tree(tmp_path)))


def test_main_exit_codes_equal_jax(tmp_path, monkeypatch, capsys):
    """0 / 1 / 2 as JAX: no manifest 2; frozen 0; an untracked file 0; a
    changed or missing file 1; the slot table 0."""
    base = _tree(tmp_path / "base")
    codes = {}
    for s, mod in SIDES.items():
        root = tmp_path / s
        shutil.copytree(base, root)
        monkeypatch.setenv(mod.ENV_VAR, str(root))
        seq = [mod.main([]), mod.main(["--verify"]), mod.main(["--freeze"]),
               mod.main(["--verify"])]
        for step in ("add", "change", "delete"):
            _edit(root, step)
            seq.append(mod.main(["--verify"]))
        codes[s] = seq
    assert codes["port"] == codes["jax"] == [0, 2, 0, 0, 0, 1, 1]
    out = capsys.readouterr().out
    assert "changed  t5-base/spiece.model" in out
    assert "missing  eval/last_499.bin" in out
