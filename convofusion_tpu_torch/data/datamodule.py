"""Data modules and ``get_datasets`` (reference convofusion/data/base.py,
BEAT_DnD.py, get_data.py).

Port of ``convofusion_tpu/data/datamodule.py:1-198``: a host loader
(shuffle, batch, drop_last, shard, collate) whose batches are numpy, as
JAX's; the entry points tokenize and move them to the device.  Shuffles
draw from ``np.random.default_rng(seed)``, so the port and JAX give the
same order for a seed.  ``BEATDataModule`` hands its datasets one
``random.Random`` and one ``np.random.RandomState`` from ``SEED_VALUE``
(JAX's datasets draw from the globals).
"""
from __future__ import annotations

import os
import random
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from convofusion_tpu_torch.data.collate import (
    beatdnd_collate,
    beatdnd_vae_collate,
)
from convofusion_tpu_torch.data.dataset import (
    BEATAugReactionDataset,
    MotionDataset,
)
from convofusion_tpu_torch.utils.geometry import (
    euler_deg_to_6d,
    forward_kinematics_cont6d,
    rep6d_to_euler_deg,
)


class DataLoader:
    """Host-side loader: shuffle/batch/collate over an indexable dataset.

    ``shard=(index, count)`` partitions the (identically shuffled) index
    stream across hosts for multi-process SPMD — the per-host equivalent
    of torch's DistributedSampler under Lightning DDP (train.py:115-127):
    every host draws the same epoch permutation (same seed) and takes a
    disjoint stride of it, so the union of all hosts' batches is the
    epoch and ``batch_size`` stays the per-host size.
    """

    def __init__(self, dataset, batch_size: int, collate_fn: Callable,
                 shuffle: bool = False, drop_last: bool = False,
                 seed: int = 0, shard: Optional[tuple] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        self.shard = shard

    def _indices(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        if self.shard is not None:
            i, n = self.shard
            # pad the permutation to a multiple of n (wrap-around, like
            # torch DistributedSampler) so every host gets the SAME item
            # count — unequal counts would leave hosts executing
            # different numbers of collective steps, which deadlocks
            per_host = -(-len(idx) // n)
            if len(idx) < per_host * n:
                idx = np.concatenate(
                    [idx, idx[:per_host * n - len(idx)]])
            idx = idx[i::n]
        return idx

    def _n_items(self):
        n = len(self.dataset)
        if self.shard is not None:
            _, cnt = self.shard
            n = -(-n // cnt)  # padded per-host count, equal on all hosts
        return n

    def __len__(self):
        n = self._n_items()
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[dict]:
        idx = self._indices()
        for i in range(len(self)):
            sel = idx[i * self.batch_size:(i + 1) * self.batch_size]
            yield self.collate_fn([self.dataset[int(j)] for j in sel])


class BEATDataModule:
    """Picks MotionDataset (vae stage) vs BEATAugReactionDataset
    (diffusion) and exposes the rep converters (BEAT_DnD.py:24-60)."""

    name = "beatdnd"

    def __init__(self, cfg, batch_size: int, num_workers: int = 0,
                 collate_fn: Optional[Callable] = None, phase: str = "train",
                 **kwargs):
        self.cfg = cfg
        self.stage = cfg.TRAIN.STAGE
        self.batch_size = batch_size
        self.kwargs = kwargs
        self.Dataset = (MotionDataset if self.stage == "vae"
                        else BEATAugReactionDataset)
        self.collate_fn = collate_fn or (
            beatdnd_vae_collate if self.stage == "vae" else beatdnd_collate)
        self._datasets = {}
        seed = int(cfg.get("SEED_VALUE", 0))
        self.rng = random.Random(seed)
        self.np_rng = np.random.RandomState(seed)
        self._sample_set = self.get_sample_set({"split": "val",
                                                "debug": True})
        self.nfeats = self._sample_set.nfeats
        self.njoints = getattr(self._sample_set, "njoints", 63)

    def _split_files(self, split: str):
        roots = self.kwargs["split_root"]
        return [os.path.join(r, f"{split}.txt") for r in roots]

    def _make_dataset(self, split: str, debug=False, tiny=False):
        kw = dict(self.kwargs)
        kw.pop("split_root", None)
        return self.Dataset(
            split_file=self._split_files(split),
            debug=debug or bool(self.cfg.DEBUG),
            tiny=tiny, rng=self.rng, np_rng=self.np_rng,
            **kw,
        )

    def get_sample_set(self, overrides):
        return self._make_dataset(
            overrides.get("split", "val"),
            debug=overrides.get("debug", False))

    def dataset(self, split: str):
        if split not in self._datasets:
            self._datasets[split] = self._make_dataset(split)
        return self._datasets[split]

    def train_dataloader(self, seed: int = 0, shard: Optional[tuple] = None):
        return DataLoader(self.dataset("train"),
                          int(self.cfg.TRAIN.BATCH_SIZE),
                          self.collate_fn, shuffle=True, drop_last=True,
                          seed=seed, shard=shard)

    def val_dataloader(self, shard: Optional[tuple] = None,
                       drop_last: bool = False):
        return DataLoader(self.dataset("val"),
                          int(self.cfg.EVAL.BATCH_SIZE), self.collate_fn,
                          drop_last=drop_last, shard=shard)

    def test_dataloader(self, seed: int = 0):
        # NB the reference shuffles the test loader too (data/base.py:119)
        return DataLoader(self.dataset("test"),
                          int(self.cfg.TEST.BATCH_SIZE), self.collate_fn,
                          shuffle=True, seed=seed)

    # rep converters for visualization / eval (BEAT_DnD.py:39-60): numpy
    # in, numpy out, computed in torch on the CPU
    def euler2rep6d(self, feats):
        return euler_deg_to_6d(_tensor(feats), self.njoints).numpy()

    def rep6d2euler(self, feats):
        return rep6d_to_euler_deg(_tensor(feats), self.njoints).numpy()

    def rep6d2joints(self, feats_batch):
        tree = [list(c) for c in self.cfg.DATASET.BEATDND.KINEMATIC_TREE]
        offset = np.load(self.cfg.DATASET.BEATDND.OFFSET_NPY_PATH)
        flat = _tensor(feats_batch).reshape(-1, 3 + 6 * self.njoints)
        return forward_kinematics_cont6d(
            flat[:, 3:].reshape(-1, self.njoints, 6), flat[:, :3],
            _tensor(offset), tree).numpy()


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32))


DATASET_MODULES = {"beatdnd": BEATDataModule}


def get_datasets(cfg, phase: str = "train"):
    """Name -> datamodule list; injects NFEATS/NJOINTS into cfg
    (reference get_data.py:22-73)."""
    datasets = []
    for name in cfg.TRAIN.DATASETS:
        if name.lower() not in DATASET_MODULES:
            raise NotImplementedError(f"Dataset '{name}' unsupported")
        d = cfg.DATASET.BEATDND
        module = DATASET_MODULES[name.lower()](
            cfg=cfg,
            batch_size=int(cfg.TRAIN.BATCH_SIZE),
            num_workers=int(cfg.TRAIN.NUM_WORKERS),
            split_root=list(d.SPLIT_ROOT),
            dataset_path=list(d.ROOT),
            max_motion_length=int(cfg.DATASET.SAMPLER.MAX_LEN),
            min_motion_length=int(cfg.DATASET.SAMPLER.MIN_LEN),
            motion_rep=str(d.POSE_REP),
            unit_length=int(d.UNIT_LEN),
            sample_rate=int(d.SR),
            num_mels=int(d.N_MELS),
            hop_length=int(d.HOP_LEN),
            fps=int(d.FPS),
            face_joint_idx=list(d.FACE_JOINT_IDX),
            dataset_select=str(d.get("SELECT", "both")),
        )
        cfg.DATASET.NFEATS = module.nfeats
        cfg.DATASET.NJOINTS = module.njoints
        datasets.append(module)
    return datasets
