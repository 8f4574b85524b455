"""The asset-drop location for released artifacts.

A copy of ``assets_root``, ``asset_path`` and the slot table of
``convofusion_tpu/utils/assets.py:52-76``.  The released files (the
``t5-base`` weights, the reference checkpoints) are not in the repository;
the moment one is dropped at its slot, the code that looks for it uses it.

Layout (root defaults to ``<repo>/assets``; override with the
``CONVOFUSION_TPU_ASSETS`` environment variable)::

    assets/
      t5-base/pytorch_model.bin     # T5 encoder weights, HF names
      t5-base/model.safetensors     #   (either format)
      checkpoints/*.ckpt            # released reference checkpoints

``python -m convofusion_tpu_torch.utils.assets`` prints which slots are
filled.
"""
from __future__ import annotations

import os
from typing import Optional

ENV_VAR = "CONVOFUSION_TPU_ASSETS"

# tracked asset slots: relpath -> what uses it when present
SLOTS = {
    "t5-base/pytorch_model.bin":
        "real t5-base trunk weights (train/checkpoint.maybe_load_t5_assets)",
    "t5-base/model.safetensors": "the same weights, other format",
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


def main() -> int:
    root = assets_root()
    print(f"assets root: {root} "
          f"({'exists' if os.path.isdir(root) else 'ABSENT'})")
    for rel, what in SLOTS.items():
        print(f"  [{'x' if asset_path(rel) else ' '}] {rel}: {what}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
