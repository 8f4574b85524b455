"""The asset-drop location for released artifacts, and its manifest.

A copy of ``convofusion_tpu/utils/assets.py:52-165``: ``assets_root``,
``asset_path``, the slot table (the port's own), and the integrity
manifest (``sha256``, ``freeze``, ``verify``).  The released files (the
``t5-base`` weights, the reference checkpoints) are not in the repository;
the moment one is dropped at its slot, the code that looks for it uses it.
Hashes are recorded at drop time: ``--freeze`` writes ``MANIFEST.json``
(sha256 and size a file) and ``--verify`` checks the tree against it, so a
re-provisioned machine can prove its assets are the bytes that produced
the recorded numbers.

Layout (root defaults to ``<repo>/assets``; override with the
``CONVOFUSION_TPU_ASSETS`` environment variable)::

    assets/
      t5-base/pytorch_model.bin     # T5 encoder weights, HF names
      t5-base/model.safetensors     #   (either format)
      checkpoints/*.ckpt            # released reference checkpoints
      eval/last_499.bin             # the released FID feature net

CLI::

    python -m convofusion_tpu_torch.utils.assets            # slot table
    python -m convofusion_tpu_torch.utils.assets --freeze   # MANIFEST.json
    python -m convofusion_tpu_torch.utils.assets --verify   # exit 0 / 1 / 2
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
from typing import Dict, Optional

ENV_VAR = "CONVOFUSION_TPU_ASSETS"

# tracked asset slots: relpath -> what uses it when present
SLOTS = {
    "t5-base/pytorch_model.bin":
        "real t5-base trunk weights (train/checkpoint.maybe_load_t5_assets)",
    "t5-base/model.safetensors": "the same weights, other format",
    "eval/last_499.bin":
        "released FID feature net (eval/run.py, paper-comparable FID)",
}


def assets_root() -> str:
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    # <repo>/assets: utils/ is two levels below the package root's parent
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(os.path.dirname(pkg), "assets")


def asset_path(rel: str) -> Optional[str]:
    """Absolute path of a dropped asset, or None if absent."""
    p = os.path.join(assets_root(), rel)
    return p if os.path.isfile(p) else None


def sha256(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def _walk(root: str):
    """(relative path with '/', full path) of every file under ``root``
    but the manifest."""
    for dirpath, _, files in os.walk(root):
        for fname in sorted(files):
            if fname == "MANIFEST.json":
                continue
            full = os.path.join(dirpath, fname)
            yield os.path.relpath(full, root).replace(os.sep, "/"), full


def freeze(root: Optional[str] = None) -> Dict[str, Dict]:
    """Record the sha256 and size of every file under the assets root in
    ``MANIFEST.json``; returns the records."""
    root = root or assets_root()
    manifest = {
        rel: {"sha256": sha256(full), "bytes": os.path.getsize(full)}
        for rel, full in _walk(root)
    }
    with open(os.path.join(root, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
    return manifest


def verify(root: Optional[str] = None) -> Dict[str, str]:
    """{relpath: 'ok' | 'missing' | 'changed' | 'untracked'} of the tree
    against ``MANIFEST.json``; raises FileNotFoundError without one."""
    root = root or assets_root()
    with open(os.path.join(root, "MANIFEST.json")) as f:
        manifest = json.load(f)
    present = dict(_walk(root))
    out = {}
    for rel, rec in manifest.items():
        full = present.pop(rel, None)
        if full is None:
            out[rel] = "missing"
        elif sha256(full) != rec["sha256"]:
            out[rel] = "changed"
        else:
            out[rel] = "ok"
    for rel in present:
        out[rel] = "untracked"
    return out


def main(argv=None) -> int:
    """The slot table; ``--freeze`` writes the manifest (0); ``--verify``
    checks it: 0 when every tracked file is unchanged (untracked files
    allowed), 1 when one is missing or changed, 2 without a manifest."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--freeze", action="store_true",
                    help="write MANIFEST.json (sha256 of every file)")
    ap.add_argument("--verify", action="store_true",
                    help="check files against MANIFEST.json")
    args = ap.parse_args(argv)
    root = assets_root()
    print(f"assets root: {root} "
          f"({'exists' if os.path.isdir(root) else 'ABSENT'})")
    if args.freeze:
        m = freeze(root)
        print(f"froze {len(m)} files into MANIFEST.json")
        return 0
    if args.verify:
        try:
            res = verify(root)
        except FileNotFoundError:
            print("no MANIFEST.json: run --freeze after dropping assets")
            return 2
        for rel, state in sorted(res.items()):
            print(f"  {state:>9}  {rel}")
        return 1 if any(v in ("missing", "changed") for v in res.values()) \
            else 0
    for rel, what in SLOTS.items():
        print(f"  [{'x' if asset_path(rel) else ' '}] {rel}: {what}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
