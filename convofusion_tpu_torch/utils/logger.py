"""Experiment folder + logging setup.

A copy of ``convofusion_tpu/utils/logger.py:1-35`` (reference
convofusion/utils/logger.py:10-71): the experiment folder
FOLDER/<model_type>/<NAME>, a config snapshot, file and console logging;
sets ``cfg.TIME`` and ``cfg.FOLDER_EXP``.
"""
from __future__ import annotations

import logging
import time
from pathlib import Path


def create_logger(cfg, phase: str = "train"):
    root_dir = Path(cfg.FOLDER) / str(cfg.model.model_type) / str(cfg.NAME)
    root_dir.mkdir(parents=True, exist_ok=True)
    cfg.TIME = time.strftime("%Y-%m-%d-%H-%M-%S")
    cfg.FOLDER_EXP = str(root_dir)

    # config snapshot
    from convofusion_tpu_torch.config.omega import OmegaConf

    OmegaConf.save(cfg, root_dir / f"config_{phase}_{cfg.TIME}.yaml")

    logger = logging.getLogger("convofusion_tpu_torch")
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    fh = logging.FileHandler(root_dir / f"{phase}_{cfg.TIME}.log")
    fh.setFormatter(fmt)
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(fh)
    logger.addHandler(sh)
    logger.propagate = False
    return logger
