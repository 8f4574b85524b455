"""FID feature extractor: the encoder half of the conv pose autoencoder.

Port of ``convofusion_tpu/eval/fid_net.py:30-149`` (reference
quant_eval/motion_autoencoder.py, ``PoseEncoderConv`` / ``HalfEmbeddingNet``
from the BEAT/CaMN repo): a 1-D conv + BatchNorm stack over (128, 189)
motion -> a 300-d feature.  The modules carry the released checkpoint's
names (``pose_encoder.net.0.0``, ..., ``pose_encoder.fc_mu``), so the
released ``experiments/eval/last_499.bin`` loads with ``load_state_dict``
once a DDP ``module.`` prefix is stripped (``load_torch_fidnet``).

As in the reference and JAX:
  * the convolutions run over (B, C, L), and the flatten before the MLP is
    channel-major;
  * the out_net's ``nn.LeakyReLU(True)`` sets negative_slope to True, i.e.
    1.0, an identity: kept, since the released weights were trained with it
    (motion_autoencoder.py:48-59);
  * BatchNorm runs in eval mode on its stored running statistics.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn


def _conv_block(cin: int, cout: int, k: int, stride: int = 1):
    return nn.Sequential(nn.Conv1d(cin, cout, k, stride=stride),
                         nn.BatchNorm1d(cout), nn.LeakyReLU(0.2, True))


class PoseEncoderConv(nn.Module):
    def __init__(self, length: int, dim: int, feature_length: int):
        super().__init__()
        b = feature_length
        self.net = nn.Sequential(
            _conv_block(dim, b, 3),
            _conv_block(b, 2 * b, 3),
            _conv_block(2 * b, 2 * b, 4, stride=2),
            nn.Conv1d(2 * b, b, 3))
        # 128 frames -> 59 after the VALID convolutions (lin0 = 59 * base)
        self.out_net = nn.Sequential(
            nn.Linear(59 * b, 20 * b), nn.BatchNorm1d(20 * b),
            nn.LeakyReLU(True),
            nn.Linear(20 * b, 4 * b), nn.BatchNorm1d(4 * b),
            nn.LeakyReLU(True),
            nn.Linear(4 * b, 2 * b), nn.BatchNorm1d(2 * b),
            nn.LeakyReLU(True),
            nn.Linear(2 * b, b))
        self.fc_mu = nn.Linear(b, b)

    def forward(self, poses: torch.Tensor) -> torch.Tensor:
        x = self.net(poses.transpose(1, 2))          # (B, base, 59)
        x = self.out_net(x.flatten(1))               # channel-major
        return self.fc_mu(x)


class HalfEmbeddingNet(nn.Module):
    """poses (B, 128, 189) -> features (B, 300); always in eval mode."""

    def __init__(self, pose_length: int = 128, pose_dim: int = 189,
                 feature_length: int = 300):
        super().__init__()
        self.base = feature_length
        self.pose_dim = pose_dim
        self.pose_length = pose_length
        self.pose_encoder = PoseEncoderConv(pose_length, pose_dim,
                                            feature_length)
        self.eval()

    def train(self, mode: bool = True):
        # BatchNorm must keep its running statistics: eval only
        return super().train(False)

    def init_params(self, seed: int = 0) -> Dict[str, torch.Tensor]:
        """JAX's random init (``init_params``, :40-75), the same numpy
        draws in the same order, as a state dict in this module's names
        (for tests, and FID without the released weights)."""
        rng = np.random.default_rng(seed)
        b, out = self.base, {}

        def conv(name, cin, cout, k):
            kernel = rng.normal(scale=1.0 / np.sqrt(cin * k),
                                size=(k, cin, cout)).astype(np.float32)
            out[f"{name}.weight"] = torch.from_numpy(
                np.ascontiguousarray(kernel.transpose(2, 1, 0)))
            out[f"{name}.bias"] = torch.zeros(cout)

        def bn(name, c):
            out[f"{name}.weight"] = torch.ones(c)
            out[f"{name}.bias"] = torch.zeros(c)
            out[f"{name}.running_mean"] = torch.zeros(c)
            out[f"{name}.running_var"] = torch.ones(c)
            out[f"{name}.num_batches_tracked"] = torch.zeros((),
                                                             dtype=torch.long)

        def lin(name, cin, cout):
            kernel = rng.normal(scale=1.0 / np.sqrt(cin),
                                size=(cin, cout)).astype(np.float32)
            out[f"{name}.weight"] = torch.from_numpy(
                np.ascontiguousarray(kernel.T))
            out[f"{name}.bias"] = torch.zeros(cout)

        e = "pose_encoder"
        conv(f"{e}.net.0.0", self.pose_dim, b, 3)
        bn(f"{e}.net.0.1", b)
        conv(f"{e}.net.1.0", b, 2 * b, 3)
        bn(f"{e}.net.1.1", 2 * b)
        conv(f"{e}.net.2.0", 2 * b, 2 * b, 4)
        bn(f"{e}.net.2.1", 2 * b)
        conv(f"{e}.net.3", 2 * b, b, 3)
        lin(f"{e}.out_net.0", 59 * b, 20 * b)
        bn(f"{e}.out_net.1", 20 * b)
        lin(f"{e}.out_net.3", 20 * b, 4 * b)
        bn(f"{e}.out_net.4", 4 * b)
        lin(f"{e}.out_net.6", 4 * b, 2 * b)
        bn(f"{e}.out_net.7", 2 * b)
        lin(f"{e}.out_net.9", 2 * b, b)
        lin(f"{e}.fc_mu", b, b)
        return out

    def forward(self, poses: torch.Tensor) -> torch.Tensor:
        return self.pose_encoder(poses)


def load_torch_fidnet(path: str) -> Dict[str, torch.Tensor]:
    """The released ``last_499.bin`` as a state dict for
    :class:`HalfEmbeddingNet`: its ``model_state`` (or the bare dict), a
    DDP ``module.`` prefix stripped (metric_eval.py:359-373), the pose
    encoder's entries kept."""
    states = torch.load(path, map_location="cpu", weights_only=False)
    sd = states["model_state"] if "model_state" in states else states
    sd = {(k[7:] if k.startswith("module.") else k): v
          for k, v in sd.items()}
    return {k: v for k, v in sd.items() if k.startswith("pose_encoder.")}
