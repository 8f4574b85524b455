"""BEAT + DnD dataset loading and canonicalization.

Port of ``convofusion_tpu/data/dataset.py:1-531`` (reference
convofusion/data/beat_dnd/dataset.py: BEATAugReactionDataset :72-732 for
the diffusion stage, MotionDataset :737-972 for the VAE stage):
everything loaded at construction, BEAT joints resampled 120 -> 25 fps,
root first, cm -> mm, 128-frame chunks, the ``process_motion``
canonicalization (:523-574), mel / dB features, TextGrid word windows,
BEAT semantic annotations, active/passive bits from a -45 dB threshold per
16-frame chunk (:477-492).  Items are numpy arrays, featurized on the host.

Two differences from the JAX package, neither in what an item holds:
``__getitem__`` draws the listener index and the silent listener's noise
mel from the dataset's own ``random.Random`` and
``np.random.RandomState`` (JAX draws from the global ``random`` and
``np.random``, which run the same Mersenne Twister: seeding the globals
and the generators alike gives equal items); and the semantic annotation
table is read with the stdlib ``csv`` module, typing its columns as pandas'
``read_csv`` does (JAX reads it with pandas).
"""
from __future__ import annotations

import csv
import glob
import os
import random
from os.path import join as pjoin
from typing import Dict, List, Optional, Sequence

import numpy as np

from convofusion_tpu_torch.data.audio import (
    amplitude_to_db,
    load_wav,
    mel_db,
    normalize,
)
from convofusion_tpu_torch.data.text import parse_textgrid
from convofusion_tpu_torch.utils.quaternion import qbetween_np, qrot_np

DND_SPEAKERS = ["anne", "ben", "chris", "jack", "lilas"]
BEAT_SPEAKERS = [
    "wayne", "scott", "solomon", "lawrence", "stewart", "carla", "sophie",
    "catherine", "miranda", "kieks", "nidal", "zhao", "lu", "zhang",
    "carlos", "jorge", "itoi", "daiki", "jaime", "li", "ayana", "luqi",
    "hailing", "kexin", "goto", "reamey", "yingqing", "tiffnay", "hanieh",
    "katya",
]
SPEAKER_NAMES = DND_SPEAKERS + BEAT_SPEAKERS


def process_motion(motions: Sequence[np.ndarray],
                   face_joint_idx=(18, 13, 9, 5),
                   njoints: int = 63) -> List[np.ndarray]:
    """Canonicalize raw 67-joint position clips (dataset.py:523-574):
    keep 63 joints, mm->m, floor, root-xz origin, face Z+, root-relative
    joints, wrist-relative hands, x3 scale, flatten to (T, 189)."""
    ret = []
    for motion in motions:
        motion = motion[:, list(range(0, 23)) + list(range(24, 44))
                        + list(range(46, 66)), :]
        motion = motion / 1000.0

        floor_height = motion.min(axis=0).min(axis=0)[1]
        motion = motion.copy()
        motion[:, :, 1] -= floor_height

        root_pos_init = motion[0]
        root_pose_init_xz = root_pos_init[0] * np.array([1, 0, 1])
        motion = motion - root_pose_init_xz

        r_hip, l_hip, sdr_r, sdr_l = face_joint_idx
        across = (root_pos_init[r_hip] - root_pos_init[l_hip]) + (
            root_pos_init[sdr_r] - root_pos_init[sdr_l])
        across = across / np.sqrt((across**2).sum(axis=-1))[..., np.newaxis]
        forward_init = np.cross(np.array([[0, 1, 0]]), across, axis=-1)
        forward_init = forward_init / np.sqrt(
            (forward_init**2).sum(axis=-1))[..., np.newaxis]
        target = np.array([[0, 0, 1]])
        root_quat_init = qbetween_np(forward_init, target)
        root_quat_init = np.ones(motion.shape[:-1] + (4,)) * root_quat_init

        motion = np.array(qrot_np(root_quat_init, motion))
        motion[:, 1:, :] = motion[:, 1:, :] - motion[:, :1, :]
        motion[:, 23:43, :] = motion[:, 23:43, :] - motion[:, [7], :]
        motion[:, 43:, :] = motion[:, 43:, :] - motion[:, [11], :]
        motion = motion * 3.0

        ret.append(motion.reshape(-1, njoints * 3).astype(np.float32))
    return ret


def resample_motion_fps(motion: np.ndarray, fps_in: float = 120.0,
                        fps_out: float = 25.0) -> np.ndarray:
    """Linear interpolation over frames (dataset.py:146-152)."""
    xp = np.arange(0, len(motion), fps_in / fps_out)
    if xp[-1] > len(motion) - 1:
        xp = xp[:-1]
    base = np.arange(len(motion), dtype=np.float64)
    flat = motion.reshape(len(motion), -1)
    out = np.empty((len(xp), flat.shape[1]), flat.dtype)
    for j in range(flat.shape[1]):
        out[:, j] = np.interp(xp, base, flat[:, j])
    return out.reshape((len(xp),) + motion.shape[1:])


def check_audio(audio: np.ndarray, max_motion_length: int = 128,
                fps: int = 25, sr: int = 16000,
                threshold: float = -45.0) -> np.ndarray:
    """Per-16-frame-chunk active bit from peak dB (dataset.py:477-492)."""
    n_chunks = max_motion_length // 16
    chunklen = int((16 / fps) * sr)
    bits = []
    for i in range(n_chunks):
        chunk = audio[i * chunklen:(i + 1) * chunklen]
        if len(chunk) == 0:
            bits.append(0)
            continue
        db = amplitude_to_db(chunk, ref=1.0)
        bits.append(1 if np.max(db) > threshold else 0)
    return np.array(bits, np.int32)


def uncond_mel_np(shape) -> np.ndarray:
    mel = -90.0 * np.ones(shape, np.float32)
    mel[..., 40:45] = 0.0
    return mel


def beat_extract_text(text_path: str, frame_idx: int, length: int,
                      fps: int = 25):
    """Word window + segments for a frame span (dataset.py:383-401)."""
    td = parse_textgrid(text_path)
    start_sec = frame_idx / fps
    end_sec = (frame_idx + length) / fps
    seg = [
        [[float(s) - start_sec, float(e) - start_sec], t]
        for s, e, t in zip(td["start"], td["end"], td["text"])
        if s >= start_sec and e <= end_sec
    ]
    sel = np.where((td["start"] >= start_sec) & (td["end"] <= end_sec))[0]
    return " ".join(td["text"][sel]), seg


SEM_COLUMNS = ("name", "start_time", "end_time", "duration", "score",
               "keywords")
# pandas' default missing-value strings (pandas/_libs/parsers.pyx)
_NA_STRINGS = frozenset((
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"))


def _typed_column(cells: List[str]) -> List:
    """A column's cells typed as pandas' ``read_csv`` types them, as a
    Series iterates them: all integers (no missing cell) -> int; all
    numbers -> float, NaN for a missing cell; else str, NaN for a missing
    cell."""
    na = [c in _NA_STRINGS for c in cells]
    present = [c for c, m in zip(cells, na) if not m]
    for cast in ((int,) if present and not any(na) else ()) + (float,):
        try:
            vals = iter([cast(c) for c in present])
        except ValueError:
            continue
        return [float("nan") if m else next(vals) for m in na]
    return [float("nan") if m else c for c, m in zip(cells, na)]


def read_sem_table(path: str) -> Dict[str, List]:
    """A BEAT semantic annotation file, what ``pd.read_csv(path,
    sep="\\t", names=SEM_COLUMNS)`` reads: column -> typed values; blank
    lines skipped, short rows padded with missing cells."""
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f, delimiter="\t") if r]
    cells = [[r[i] if i < len(r) else "" for r in rows]
             for i in range(len(SEM_COLUMNS))]
    return {name: _typed_column(col) for name, col in zip(SEM_COLUMNS, cells)}


def beat_extract_sem(sem_path: str, frame_idx: int, length: int,
                     fps: int = 25):
    """Per-frame semantic score + keyword info (dataset.py:404-456); zeros
    and no info where the table cannot be read."""
    try:
        sem_all = read_sem_table(sem_path)
    except Exception:
        return np.zeros(length, np.float32), []

    scores = np.zeros(length, np.float32)
    starts = np.asarray(sem_all["start_time"], float)
    ends = np.asarray(sem_all["end_time"], float)
    vals = np.asarray(sem_all["score"], float)
    for i in range(length):
        t = (frame_idx + i) / fps
        hit = np.where((starts <= t) & (t <= ends))[0]
        if len(hit):
            scores[i] = vals[hit[0]]

    info = []
    for name, s, e, word in zip(sem_all["name"], starts, ends,
                                sem_all["keywords"]):
        span_start, span_end = frame_idx / fps, (frame_idx + length) / fps
        if s <= span_end and e >= span_start and not (
                e < span_start or s > span_end):
            # overlap with the chunk window at any frame
            covered = any(
                s <= (frame_idx + k) / fps <= e for k in range(length))
            if not covered:
                continue
            if "beat" in str(name):
                cls = "beat"
            elif any(x in str(name)
                     for x in ("deictic", "iconic", "metaphoric")):
                cls = "semantic"
            else:
                continue
            info.append({
                "name": cls,
                "start": max(0.0, s - span_start),
                "end": min(length / fps, e - span_start),
                "word": word,
            })
    return scores, info


class BEATAugReactionDataset:
    """Diffusion-stage dataset over BEAT chunks + DnD utterance sets."""

    def __init__(self, split_file, max_motion_length, min_motion_length,
                 motion_rep, unit_length, dataset_path, debug=False,
                 tiny=False, rng: Optional[random.Random] = None,
                 np_rng: Optional[np.random.RandomState] = None, **kwargs):
        assert motion_rep == "pos"
        # __getitem__'s draws (the JAX package draws from the globals)
        self.rng = rng if rng is not None else random.Random(0)
        self.np_rng = np_rng if np_rng is not None \
            else np.random.RandomState(0)
        self.max_motion_length = max_motion_length
        self.min_motion_length = min_motion_length
        self.njoints = 63
        self.face_joint_idx = kwargs["face_joint_idx"]
        self.SR = kwargs["sample_rate"]
        self.N_MELS = kwargs["num_mels"]
        self.HOP_LEN = kwargs["hop_length"]
        self.FPS = kwargs["fps"]
        self.dataset_select = kwargs.get("dataset_select", "both")
        self.motion_rep = motion_rep
        self.speaker_names = SPEAKER_NAMES
        self.dnd_speaker_names = DND_SPEAKERS

        data_dict: Dict[str, Dict] = {}
        name_list: List[str] = []

        beat_split_file, dnd_split_file = split_file
        beat_dataset_path, dnd_dataset_path = dataset_path
        self.dnd_dataset_path = dnd_dataset_path

        # ---------------------------------------------------------- BEAT
        beat_split = _load_split(beat_split_file)
        if debug:
            beat_split = beat_split[:10]
        if tiny:
            beat_split = beat_split[:5]
        motion_paths = sorted(
            p for p in glob.glob(os.path.join(beat_dataset_path, "*/*.npy"))
            if "euler" not in p)
        if self.dataset_select == "dnd":
            motion_paths = []

        for motion_path in motion_paths:
            motion_name = os.path.basename(motion_path)[:-4]
            if motion_name not in beat_split:
                continue
            orig = np.load(motion_path)
            motion = resample_motion_fps(orig, 120.0, self.FPS)
            if motion.shape[0] < self.max_motion_length:
                raise ValueError(f"{motion_path} too short")
            motion = motion[:, [3] + list(range(0, 3))
                            + list(range(4, motion.shape[1])), :]
            motion = motion * 10.0
            motion = motion[:len(motion)
                            - len(motion) % self.max_motion_length]
            chunks = np.array_split(
                motion, len(motion) // self.max_motion_length, axis=0)
            text_path = motion_path.replace(".npy", ".TextGrid")
            audio_path = motion_path.replace(".npy", ".wav")
            sem_path = motion_path.replace(".npy", ".txt")
            full_audio, _ = load_wav(audio_path, self.SR)

            for idx, chunk in enumerate(chunks):
                start_idx = idx * self.max_motion_length
                motion_lsn = process_motion(
                    [chunk], self.face_joint_idx, self.njoints)[0]
                text_lsn, seg_lsn = beat_extract_text(
                    text_path, start_idx, self.max_motion_length, self.FPS)
                start = int(start_idx / self.FPS * self.SR)
                win = int(self.max_motion_length / self.FPS * self.SR)
                audio_lsn = full_audio[start:start + win]
                if len(audio_lsn) < win:
                    continue
                audio_lsn = normalize(audio_lsn)
                sem_lsn, sem_info = beat_extract_sem(
                    sem_path, start_idx, self.max_motion_length, self.FPS)
                apb = check_audio(audio_lsn, self.max_motion_length,
                                  self.FPS, self.SR)
                melspec_lsn = mel_db(audio_lsn, self.SR, self.HOP_LEN,
                                     self.N_MELS)
                key = "beat+" + motion_name + "/" + str(idx)
                data_dict[key] = {
                    "motion_spk": np.zeros_like(motion_lsn),
                    "motions_lsn": [motion_lsn],
                    "melspec_spk": uncond_mel_np(melspec_lsn.shape),
                    "melspecs_lsn": [melspec_lsn],
                    "text_spk": "-" * 10,
                    "texts_lsn": [text_lsn],
                    "audio_spk": np.zeros_like(audio_lsn),
                    "audios_lsn": [audio_lsn],
                    "active_passive_bit": [apb],
                    "seg_lsn": seg_lsn,
                    "seg_spk": "-" * 10,
                    "sem_lsn": sem_lsn,
                    "sem_info": sem_info,
                }
                name_list.append(key)

        # ----------------------------------------------------------- DnD
        dnd_split = _load_split(dnd_split_file)
        if debug:
            dnd_split = dnd_split[:10]
        if tiny:
            dnd_split = dnd_split[:5]
        set_paths = sorted(glob.glob(os.path.join(dnd_dataset_path, "*/*")))
        if self.dataset_select == "beat":
            set_paths = []

        for set_path in set_paths:
            set_name = "/".join(set_path.split("/")[-2:])
            if set_name not in dnd_split:
                continue
            try:
                motion_spk = np.load(pjoin(set_path, "motion_spk.npy"))
                if motion_spk.shape[0] != self.max_motion_length:
                    continue
                motions_l = [
                    np.load(pjoin(set_path, f"motion_lsn{i}.npy"))
                    for i in range(1, 5)
                ]
            except FileNotFoundError:
                continue
            processed = process_motion(
                [motion_spk] + motions_l, self.face_joint_idx, self.njoints)
            motion_spk, motions_l = processed[0], processed[1:]

            audio_spk = load_wav(pjoin(set_path, "audio_spk.wav"),
                                 self.SR)[0]
            if len(audio_spk) < (self.max_motion_length / self.FPS) * self.SR:
                continue
            audios_l = []
            for i in range(1, 5):
                p = pjoin(set_path, f"audio_lsn{i}.wav")
                a = load_wav(p, self.SR)[0] if os.path.exists(p) else \
                    np.zeros(0, np.float32)
                audios_l.append(
                    np.zeros_like(audio_spk) if len(a) == 0 else a)
            max_len = max(len(audio_spk), *[len(a) for a in audios_l])
            audio_spk = _pad_to(audio_spk, max_len)
            audios_l = [_pad_to(a, max_len) for a in audios_l]

            melspec_spk = mel_db(audio_spk, self.SR, self.HOP_LEN,
                                 self.N_MELS)
            melspecs_l = [mel_db(a, self.SR, self.HOP_LEN, self.N_MELS)
                          for a in audios_l]
            apbs = [check_audio(a, self.max_motion_length, self.FPS,
                                self.SR) for a in audios_l]
            texts_l = []
            for i in range(1, 5):
                with open(pjoin(set_path, f"text_lsn{i}.txt")) as f:
                    texts_l.append(f.read())
            with open(pjoin(set_path, "text_spk.txt")) as f:
                text_spk = f.read()

            uncond_sem = -1.0 * np.ones(self.max_motion_length, np.float32)
            # l1/l3 always included; l2/l4 only when active
            # (dataset.py:306-368)
            include = [True, apbs[1].sum() != 0, True, apbs[3].sum() != 0]
            for li in range(4):
                if not include[li]:
                    continue
                key = f"dnd+{set_name}_l{li + 1}"
                data_dict[key] = {
                    "motion_spk": motion_spk,
                    "motions_lsn": [motions_l[li]],
                    "melspec_spk": melspec_spk,
                    "melspecs_lsn": [melspecs_l[li]],
                    "text_spk": text_spk,
                    "texts_lsn": [texts_l[li]],
                    "audio_spk": audio_spk,
                    "audios_lsn": [audios_l[li]],
                    "active_passive_bit": [apbs[li]],
                    "sem_lsn": uncond_sem,
                    "sem_info": [],
                    "seg_lsn": None,
                    "seg_spk": None,
                }
                name_list.append(key)

        self.data_dict = data_dict
        self.name_list = name_list
        self.nfeats = self.njoints * 3

    def __len__(self):
        return len(self.name_list)

    def __getitem__(self, idx):
        name = self.name_list[idx]
        data = self.data_dict[name]
        dataset_name, path_name = name.split("+")

        lsn_idx = self.rng.randrange(len(data["motions_lsn"]))
        motion_lsn = data["motions_lsn"][lsn_idx]
        audio_lsn = data["audios_lsn"][lsn_idx]
        melspec_lsn = data["melspecs_lsn"][lsn_idx]
        text_lsn = data["texts_lsn"][lsn_idx]
        apb = data["active_passive_bit"][lsn_idx]

        if dataset_name == "beat":
            spk_name = "BEAT"
            lsn_name = path_name.split("/")[0].split("_")[1]
            seg_lsn, seg_spk = data["seg_lsn"], data["seg_spk"]
            other_mlsns = None
        else:
            name_idx = int(path_name[-1]) - 1
            set_path_name = path_name[:-3]
            spk = [x for x in self.dnd_speaker_names if x in path_name]
            lsns = [x for x in self.dnd_speaker_names if x not in path_name]
            spk_name = spk[0]
            lsn_name = lsns[name_idx]
            seg_lsn = _load_segments(
                pjoin(self.dnd_dataset_path, set_path_name,
                      f"seg_lsn{name_idx + 1}.txt"))
            seg_spk = _load_segments(
                pjoin(self.dnd_dataset_path, set_path_name, "seg_spk.txt"))
            # reference dataset.py:704: remaining listeners zipped against
            # the remaining motions of this entry (with the shipped
            # one-listener-per-entry layout this is {}, never None)
            motions = data["motions_lsn"]
            other_mlsns = dict(zip(
                lsns[:lsn_idx] + lsns[lsn_idx + 1:],
                motions[:lsn_idx] + motions[lsn_idx + 1:]))

        lsn_id = self.speaker_names.index(lsn_name) + 1

        if apb.sum() == 0:
            audio_lsn = np.zeros_like(audio_lsn)
            melspec_lsn = (-80.0 + 0.01 * self.np_rng.rand(
                *melspec_lsn.shape)).astype(np.float32)
            text_lsn = ""

        # reference dataset.py:697-698
        if np.any(np.isnan(data["motion_spk"])) or np.any(
                np.isnan(motion_lsn)):
            raise ValueError("nan in motion")

        combined_audio = sum(data["audios_lsn"]) + data["audio_spk"]
        return (
            data["motion_spk"], motion_lsn.shape[0], motion_lsn,
            data["melspec_spk"], melspec_lsn, data["audio_spk"], audio_lsn,
            data["text_spk"].strip(), text_lsn.strip(), apb,
            dataset_name + "/" + path_name, spk_name, lsn_name, lsn_id,
            other_mlsns, combined_audio, seg_lsn, seg_spk,
            data["sem_lsn"], data["sem_info"],
        )


class MotionDataset:
    """VAE-stage dataset: every BEAT chunk + every DnD person as an
    independent (motion, length, name) clip (dataset.py:737-972)."""

    def __init__(self, split_file, max_motion_length, min_motion_length,
                 motion_rep, unit_length, dataset_path, debug=False,
                 tiny=False, rng=None, np_rng=None, **kwargs):
        # rng / np_rng: accepted for the data module's sake; nothing is
        # drawn here
        assert motion_rep == "pos"
        self.max_motion_length = max_motion_length
        self.njoints = 63
        self.face_joint_idx = kwargs["face_joint_idx"]
        self.dataset_select = kwargs.get("dataset_select", "both")
        fps = kwargs.get("fps", 25)

        beat_split_file, dnd_split_file = split_file
        beat_dataset_path, dnd_dataset_path = dataset_path

        raw: Dict[str, np.ndarray] = {}
        beat_split = _load_split(beat_split_file)
        if debug:
            beat_split = beat_split[:10]
        if tiny:
            beat_split = beat_split[:5]
        motion_paths = sorted(
            p for p in glob.glob(os.path.join(beat_dataset_path, "*/*.npy"))
            if "euler" not in p)
        if self.dataset_select == "dnd":
            motion_paths = []
        for motion_path in motion_paths:
            motion_name = os.path.basename(motion_path)[:-4]
            if motion_name not in beat_split:
                continue
            motion = resample_motion_fps(np.load(motion_path), 120.0, fps)
            if motion.shape[0] < self.max_motion_length:
                raise ValueError(f"{motion_path} too short")
            motion = motion[:, [3] + list(range(0, 3))
                            + list(range(4, motion.shape[1])), :] * 10.0
            motion = motion[:len(motion)
                            - len(motion) % self.max_motion_length]
            for idx, chunk in enumerate(np.array_split(
                    motion, len(motion) // self.max_motion_length, axis=0)):
                raw[f"beat/{motion_name}/{idx}"] = chunk

        dnd_split = _load_split(dnd_split_file)
        if debug:
            dnd_split = dnd_split[:10]
        if tiny:
            dnd_split = dnd_split[:5]
        set_paths = sorted(glob.glob(os.path.join(dnd_dataset_path, "*/*")))
        if self.dataset_select == "beat":
            set_paths = []
        for set_path in set_paths:
            set_name = "/".join(set_path.split("/")[-2:])
            if set_name not in dnd_split:
                continue
            try:
                clips = [np.load(pjoin(set_path, "motion_spk.npy"))] + [
                    np.load(pjoin(set_path, f"motion_lsn{i}.npy"))
                    for i in range(1, 5)]
            except FileNotFoundError:
                continue
            if clips[0].shape[0] != self.max_motion_length:
                continue
            for idx, chunk in enumerate(clips):
                raw[f"dnd/{set_name}/{idx}"] = chunk

        self.data = {
            k: process_motion([v], self.face_joint_idx, self.njoints)[0]
            for k, v in raw.items()
        }
        self.name_list = list(self.data)
        self.nfeats = self.njoints * 3

    def __len__(self):
        return len(self.name_list)

    def __getitem__(self, idx):
        name = self.name_list[idx]
        motion = self.data[name]
        if np.any(np.isnan(motion)):
            raise ValueError("nan in motion")
        return motion, motion.shape[0], name


def _load_split(path) -> List[str]:
    return list(np.loadtxt(path, dtype=str, ndmin=1))


def _pad_to(a: np.ndarray, n: int) -> np.ndarray:
    if len(a) < n:
        return np.concatenate([a, np.zeros(n - len(a), a.dtype)])
    return a


def _load_segments(path: str):
    if not os.path.exists(path):
        return None
    with open(path) as f:
        rows = [ln.split("\t") for ln in f.readlines()]
    return [[[float(r[0]), float(r[1])], r[2].strip()] for r in rows
            if len(r) >= 3 and r[2].strip() != "-"]
