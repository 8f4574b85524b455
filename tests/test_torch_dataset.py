"""The port's BEAT/DnD datasets, collates, loader and data module against
the JAX package, on one on-disk fixture tree.

Everything here is host numpy on both sides and is held exactly: the
fixture trees byte for byte, the datasets' name lists and every item field
by field (JAX's ``__getitem__`` draws from the global ``random`` /
``np.random``, the port's from its own ``random.Random`` /
``np.random.RandomState``: both are seeded alike), both collates, the
loader's order and sharding for one seed, and ``get_datasets``' test
loader.
"""
import os
import random

import numpy as np
import pytest

from convofusion_tpu.config import load_config as jax_load_config
from convofusion_tpu.data import collate as jax_collate
from convofusion_tpu.data import datamodule as jax_dm
from convofusion_tpu.data import dataset as jax_ds
from convofusion_tpu.data import fixture as jax_fixture
from convofusion_tpu_torch.config import DEFAULTS_DIR, load_config
from convofusion_tpu_torch.data import collate, datamodule, dataset, fixture

KW = dict(max_motion_length=128, min_motion_length=128, motion_rep="pos",
          unit_length=4, sample_rate=16000, num_mels=80, hop_length=512,
          fps=25, face_joint_idx=[18, 13, 9, 5])


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The port's fixture pair, and JAX's from the same arguments."""
    root = tmp_path_factory.mktemp("data")
    port = fixture.make_fixture_pair(str(root / "port"), n_files=1)
    jax = jax_fixture.make_fixture_pair(str(root / "jax"), n_files=1)
    return port, jax


def _kw(roots, split="test"):
    return dict(KW, split_file=[os.path.join(r, f"{split}.txt")
                                for r in roots], dataset_path=list(roots))


def _same(a, b, where="item"):
    """Equal values, recursively: arrays exactly (dtype included)."""
    if isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(b, dict):
        assert a.keys() == b.keys(), where
        for k in b:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(b, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(b, float) and np.isnan(b):
        assert np.isnan(a), where
    else:
        assert a == b, (where, a, b)


def test_fixture_trees_match_jax(trees):
    port, jax = trees
    for p_root, j_root in zip(port, jax):
        p_files = sorted(os.path.relpath(os.path.join(d, f), p_root)
                         for d, _, fs in os.walk(p_root) for f in fs)
        j_files = sorted(os.path.relpath(os.path.join(d, f), j_root)
                         for d, _, fs in os.walk(j_root) for f in fs)
        assert p_files == j_files
        for rel in p_files:
            with open(os.path.join(p_root, rel), "rb") as f, \
                    open(os.path.join(j_root, rel), "rb") as g:
                assert f.read() == g.read(), rel


@pytest.fixture(scope="module")
def reaction_sets(trees):
    port, _ = trees
    kw = _kw(port)
    return (jax_ds.BEATAugReactionDataset(**kw),
            dataset.BEATAugReactionDataset(
                **kw, rng=random.Random(5), np_rng=np.random.RandomState(5)))


def test_reaction_dataset_items_match_jax(reaction_sets):
    """Every item, twice round, field by field; one listener made silent
    on both sides first, so the noise mel draw is compared too."""
    j, p = reaction_sets
    assert p.name_list == j.name_list and len(p) == len(j) >= 8
    silent = p.name_list[1]
    for ds in (j, p):
        ds.data_dict[silent]["active_passive_bit"] = [
            np.zeros_like(a) for a in ds.data_dict[silent]
            ["active_passive_bit"]]
    _same(p.data_dict, j.data_dict, "data_dict")
    random.seed(5)
    np.random.seed(5)
    for _ in range(2):
        for i in range(len(j)):
            _same(p[i], j[i], f"item {j.name_list[i]}")
    item = p[1]
    assert item[8] == "" and (item[4] < -79.98).all()


def test_collate_matches_jax(reaction_sets):
    j, p = reaction_sets
    random.seed(1)
    np.random.seed(1)
    p.rng.seed(1)
    p.np_rng.seed(1)
    want = jax_collate.beatdnd_collate([j[i] for i in (3, 0, 5, 1)])
    got = collate.beatdnd_collate([p[i] for i in (3, 0, 5, 1)])
    _same(got, want, "batch")
    assert got["melspec_lsn"].shape == (4, 161, 80)


def test_motion_dataset_and_vae_collate_match_jax(trees):
    port, _ = trees
    kw = _kw(port, "train")
    j, p = jax_ds.MotionDataset(**kw), dataset.MotionDataset(**kw)
    assert p.name_list == j.name_list and len(p) >= 10
    for i in range(len(j)):
        _same(p[i], j[i], f"clip {j.name_list[i]}")
    _same(collate.beatdnd_vae_collate([p[i] for i in range(5)]),
          jax_collate.beatdnd_vae_collate([j[i] for i in range(5)]),
          "vae batch")


@pytest.mark.parametrize("shuffle,drop_last,shard", [
    (True, False, None), (True, True, None), (False, False, None),
    (True, False, (1, 3)), (True, True, (0, 2))])
def test_loader_order_and_sharding_match_jax(shuffle, drop_last, shard):
    items = list(range(23))
    kw = dict(batch_size=4, collate_fn=list, shuffle=shuffle,
              drop_last=drop_last, seed=11, shard=shard)
    j, p = jax_dm.DataLoader(items, **kw), datamodule.DataLoader(items, **kw)
    assert len(p) == len(j)
    for _ in range(2):           # the second epoch draws a new order
        assert list(p) == list(j)


def test_sem_table_reads_as_pandas_does(tmp_path):
    """The semantic table without pandas: the columns typed as
    ``pd.read_csv`` types them (an integer, a float, a text column with a
    missing cell), blank lines skipped."""
    pd = pytest.importorskip("pandas")
    path = tmp_path / "sem.txt"
    path.write_text("beat_align\t0.0\t1.5\t1.5\t1\thello\n\n"
                    "iconic_gesture\t1.5\t2.25\t0.75\t2\t\n"
                    "deictic\t2.25\t4\t1.75\t3\tdragons\n")
    want = pd.read_csv(path, sep="\t", names=list(dataset.SEM_COLUMNS))
    got = dataset.read_sem_table(str(path))
    for name in dataset.SEM_COLUMNS:
        _same(got[name], list(want[name]), name)
        assert [type(v) for v in got[name]] == \
            [type(v) for v in want[name]], name


def _test_cfg(load, roots, seed):
    cfg = load(os.path.join(DEFAULTS_DIR, "config_cf_beatdnd.yaml"))
    cfg.DATASET.BEATDND.ROOT = list(roots)
    cfg.DATASET.BEATDND.SPLIT_ROOT = list(roots)
    cfg.TEST.BATCH_SIZE = 3
    cfg.SEED_VALUE = seed
    return cfg


def test_datamodule_test_loader_matches_jax(trees):
    """get_datasets -> the test loader (shuffled, as the reference's):
    the same batches; NFEATS / NJOINTS injected; the rep converters."""
    port, _ = trees
    pc = _test_cfg(load_config, port, 7)
    jc = _test_cfg(jax_load_config, port, 7)
    pm = datamodule.get_datasets(pc, "test")[0]
    jm = jax_dm.get_datasets(jc, "test")[0]
    assert (pc.DATASET.NFEATS, pc.DATASET.NJOINTS) == (189, 63)
    assert (jc.DATASET.NFEATS, jc.DATASET.NJOINTS) == (189, 63)
    random.seed(7)
    np.random.seed(7)
    want = list(jm.test_dataloader())
    got = list(pm.test_dataloader())
    assert len(got) == len(want) >= 3
    _same(got, want, "loader")
    feats = np.random.default_rng(0).uniform(
        -170, 170, size=(5, 63 * 3)).astype(np.float32)
    rep = pm.euler2rep6d(feats)
    np.testing.assert_allclose(rep, jm.euler2rep6d(feats), atol=1e-5)
    np.testing.assert_allclose(pm.rep6d2euler(rep), jm.rep6d2euler(rep),
                               atol=1e-3)
