"""Result dumps: per-sample directories of un-normalized gt / pred / speaker
motion .npy, wavs, texts, attention maps, word maps, focus words, semantic
info and meta, the layout the evaluation reads.

Port of ``convofusion_tpu/models/results.py:17-151`` (reference
``convofusion/models/modeltype/base.py:128-358``).  The semantic-info table
is written with the stdlib ``csv`` module, byte for byte what pandas'
``DataFrame(rows).to_csv(index=False, sep="\\t")`` writes.
"""
from __future__ import annotations

import csv
import math
import numbers
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from convofusion_tpu_torch.data.audio import save_wav

ATT_NAMES = {
    "spkemb": "att_spk",
    "alsn": "att_alsn",
    "tlsn": "att_tlsn",
    "apb": "att_apb",
    "lsnemb": "att_lsnemb",
}


def unnormalize_motion(flat: np.ndarray, njoints: int = 63) -> np.ndarray:
    """(T, J*3) canonical features -> (T, J, 3) keypoints: undoes the
    wrist-relative hands, root-relative joints and x3 scaling
    (base.py:203-227)."""
    pts = flat.reshape(-1, njoints, 3).copy() / 3.0
    pts[:, 43:, :] = pts[:, 43:, :] + pts[:, [11], :]
    pts[:, 23:43, :] = pts[:, 23:43, :] + pts[:, [7], :]
    pts[:, 1:, :] = pts[:, 1:, :] + pts[:, :1, :]
    return pts


def save_vae_results(output_dir: str, gt, pred, lengths, names,
                     njoints: int = 63):
    """Stage-1 dump: gt.npy / pred.npy per sample (base.py:1188)."""
    for i in range(len(gt)):
        d = Path(output_dir) / str(names[i])
        d.mkdir(parents=True, exist_ok=True)
        n = int(lengths[i])
        np.save(d / "gt.npy", unnormalize_motion(
            np.asarray(gt[i][:n]), njoints))
        np.save(d / "pred.npy", unnormalize_motion(
            np.asarray(pred[i][:n]), njoints))


def _missing(v) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


def _column_cells(values: List) -> List[str]:
    """A column's cells as pandas writes them: its dtype is inferred from
    the values (a missing key or None or NaN is NaN, written empty); bool
    and integer columns without NaN print as such, numeric columns as
    float64 (3 -> '3.0'), anything else as str()."""
    present = [v for v in values if not _missing(v)]
    complete = len(present) == len(values)

    def is_bool(v):
        return isinstance(v, (bool, np.bool_))

    def is_int(v):
        return isinstance(v, numbers.Integral) and not is_bool(v)

    def is_real(v):
        return isinstance(v, numbers.Real) and not is_bool(v)

    if present and complete and all(map(is_bool, present)):
        return [str(bool(v)) for v in values]
    if present and complete and all(map(is_int, present)):
        return [str(int(v)) for v in values]
    if present and all(map(is_real, present)):
        return ["" if _missing(v) else repr(float(v)) for v in values]
    return ["" if _missing(v) else str(v) for v in values]


def write_sem_info(path, rows: List[Dict]):
    """``pd.DataFrame(rows).to_csv(path, index=False, sep="\\t")``: the
    columns in order of first appearance, one line a row."""
    columns = list(dict.fromkeys(k for row in rows for k in row))
    cells = [_column_cells([row.get(c) for row in rows]) for c in columns]
    with open(path, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t", lineterminator="\n")
        w.writerow(columns)
        w.writerows(zip(*cells))


def save_generation_results(
    output_dir: str,
    gt, pred, lengths, names,
    texts_lsn: List[str], texts_spk: List[str],
    audios_lsn=None, audios_spk=None,
    motion_spk=None,
    spk_names=None, lsn_names=None, apb=None,
    melspec_lsn=None,
    att_maps: Optional[Dict] = None,
    att_timesteps=None,
    word_maps: Optional[Dict] = None,
    focus_words=None,
    sem_lsn=None, sem_info=None,
    njoints: int = 63, sr: int = 16000,
    save_plots: bool = False,
):
    """Stage-2 dump, one directory a sample (base.py:128-358).
    ``att_maps``: dict stream -> (steps, B, layers, Tq, Tk), saved as
    <att_name>/att_<t>.npy.  ``save_plots`` draws the listener's mel
    spectrogram with matplotlib, imported only then."""
    for i in range(len(pred)):
        d = Path(output_dir) / str(names[i])
        d.mkdir(parents=True, exist_ok=True)
        n = int(lengths[i])

        np.save(d / "gt.npy", unnormalize_motion(
            np.asarray(gt[i][:n]), njoints))
        np.save(d / "pred.npy", unnormalize_motion(
            np.asarray(pred[i][:n]), njoints))
        if motion_spk is not None:
            np.save(d / "spk_motion.npy", unnormalize_motion(
                np.asarray(motion_spk[i][:n]), njoints))

        with open(d / "lsn_text.txt", "w") as f:
            f.write(texts_lsn[i])
        with open(d / "spk_text.txt", "w") as f:
            f.write(texts_spk[i])

        if audios_lsn is not None:
            save_wav(str(d / "lsn_audio.wav"), np.asarray(audios_lsn[i]),
                     sr)
        if audios_spk is not None:
            save_wav(str(d / "spk_audio.wav"), np.asarray(audios_spk[i]),
                     sr)
            if audios_lsn is not None:
                save_wav(str(d / "combined_audio.wav"),
                         np.asarray(audios_lsn[i])
                         + np.asarray(audios_spk[i]), sr)

        if word_maps is not None:
            with open(d / "lsn_wordmap.txt", "w") as f:
                f.write(",".join(word_maps["lsn"][i]))
            with open(d / "spk_wordmap.txt", "w") as f:
                f.write(",".join(word_maps["spk"][i]))

        if att_maps is not None:
            for stream, arr in att_maps.items():
                att_dir = d / ATT_NAMES[stream]
                att_dir.mkdir(exist_ok=True)
                arr = np.asarray(arr)
                steps = (att_timesteps if att_timesteps is not None
                         else range(arr.shape[0]))
                for si, t in enumerate(steps):
                    np.save(att_dir / f"att_{int(t)}.npy", arr[si, i])

        if focus_words is not None and len(focus_words) > i:
            with open(d / "focus_words_lsn.txt", "w") as f:
                f.write("\n".join(
                    [",".join(x) if isinstance(x, (list, tuple)) else str(x)
                     for x in focus_words[i]]))

        if sem_lsn is not None:
            np.save(d / "sem_lsn.npy", np.asarray(sem_lsn[i]))
        if sem_info is not None and len(sem_info) > i and sem_info[i]:
            write_sem_info(d / "sem_info_lsn.csv", sem_info[i])

        if melspec_lsn is not None and save_plots:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            plt.figure(figsize=(10, 4))
            plt.imshow(np.asarray(melspec_lsn[i]).T[::-1], vmin=-90,
                       vmax=0)
            plt.colorbar()
            plt.savefig(d / "lsn_melspec.png")
            plt.close()

        if apb is not None or spk_names is not None:
            with open(d / "meta.txt", "w") as f:
                f.write(
                    f"lsn: {lsn_names[i] if lsn_names else '?'}\n"
                    f"spk: {spk_names[i] if spk_names else '?'}\n"
                    f"active_passive_bit: "
                    f"{np.asarray(apb[i]).tolist() if apb is not None else '?'}")
