"""Model-type dispatch (``convofusion_tpu/models/get_model.py``): a merged
YAML config's ``model.model_type`` -> the model it names, built from
``config.from_cfg``."""
from __future__ import annotations

from convofusion_tpu_torch.config import from_cfg
from convofusion_tpu_torch.models.convofusion import Convofusion


def get_model(cfg, datamodule=None, phase: str = "train",
              dtype="float32", device=None, seed=0):
    """``cfg`` a merged config (``config.load_config``); the model of its
    ``TRAIN.STAGE`` on ``device`` (None: the card) with ``datamodule``
    attached.  ``phase`` is the reference's argument, unused there too."""
    modeltype = str(cfg.model.model_type)
    if modeltype == "convofusion":
        model = Convofusion(from_cfg(cfg), dtype=dtype, device=device,
                            seed=seed, stage=str(cfg.TRAIN.STAGE))
        model.datamodule = datamodule
        return model
    raise ValueError(f"Invalid model type {modeltype}.")
