"""Transcription backends + word-segment / transcription tooling.

Port of ``convofusion_tpu/scripts/transcribe.py`` (host only).  Reference: scripts/transcribe_beat.py and scripts/dnd_create_word_segments.py
use OpenAI whisper ("medium.en", word timestamps).  Whisper is not shipped
in zero-egress environments, so the backend is pluggable:

  * ``WhisperTranscriber`` — used automatically when ``whisper`` imports
  * ``NullTranscriber`` — placeholder producing empty text (keeps the
    pipeline runnable; real transcripts can be dropped in later)

``transcribe_tree`` mirrors transcribe_beat.py (per-wav whisper json);
``write_word_segments`` mirrors dnd_create_word_segments.py's
``seg_*.txt`` tab-separated (start, end, word) files.
"""
from __future__ import annotations

import glob
import json
import os
from typing import List, Tuple

import numpy as np

from convofusion_tpu_torch.data.audio import load_wav

WordSegment = Tuple[float, float, str]


class NullTranscriber:
    name = "null"

    def __call__(self, audio: np.ndarray, sr: int = 16000
                 ) -> Tuple[str, List[WordSegment]]:
        return "", []


class WhisperTranscriber:
    name = "whisper"

    def __init__(self, model_name: str = "medium.en"):
        import whisper

        self.model = whisper.load_model(model_name)

    def __call__(self, audio: np.ndarray, sr: int = 16000
                 ) -> Tuple[str, List[WordSegment]]:
        if sr != 16000:
            # whisper assumes 16 kHz raw input; transcribing at another
            # rate pitch-shifts the audio and scales all timestamps
            from convofusion_tpu_torch.data.audio import resample_linear

            audio = resample_linear(audio, sr, 16000)
        result = self.model.transcribe(
            audio.astype(np.float32), word_timestamps=True)
        words: List[WordSegment] = []
        for seg in result["segments"]:
            for w in seg.get("words", []):
                words.append((float(w["start"]), float(w["end"]),
                              str(w["word"]).strip()))
        return result["text"], words


def default_transcriber():
    """Whisper where it imports and loads, else :class:`NullTranscriber`."""
    try:
        return WhisperTranscriber()
    except Exception:  # noqa: BLE001 - no whisper, or its model won't load
        return NullTranscriber()


def write_word_segments(path: str, words: List[WordSegment]):
    """seg_*.txt layout consumed by the dataset (dataset.py:645-651):
    tab-separated start, end, word; '-' rows are skipped by the loader."""
    with open(path, "w") as f:
        if not words:
            f.write("0.0\t0.0\t-\n")
            return
        for s, e, w in words:
            f.write(f"{s}\t{e}\t{w if w else '-'}\n")


def transcribe_tree(src_dir: str, out_dir: str, transcriber=None,
                    sr: int = 16000):
    """Per-wav word-timestamp json dump (transcribe_beat.py)."""
    transcriber = transcriber or default_transcriber()
    for audio_path in sorted(glob.glob(os.path.join(src_dir, "*/*.wav"))):
        y, _ = load_wav(audio_path, sr)
        text, words = transcriber(y, sr)
        rel = "/".join(audio_path.split("/")[-2:])
        # splitext, not str.replace: a directory containing '.wav'
        # would otherwise be mangled too
        dest = os.path.join(out_dir, os.path.splitext(rel)[0] + ".json")
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        with open(dest, "w") as f:
            json.dump({"text": text,
                       "words": [list(w) for w in words]}, f)


def create_word_segments(dataset_dir: str, transcriber=None,
                         sr: int = 16000):
    """seg_spk.txt / seg_lsn{i}.txt next to each utterance set's wavs
    (dnd_create_word_segments.py)."""
    transcriber = transcriber or default_transcriber()
    wavs = sorted(glob.glob(os.path.join(dataset_dir, "*/*/audio_*.wav")))
    for wav in wavs:
        y, _ = load_wav(wav, sr)
        _, words = transcriber(y, sr)
        base = os.path.splitext(os.path.basename(wav))[0]
        seg_path = os.path.join(os.path.dirname(wav),
                                base.replace("audio_", "seg_", 1) + ".txt")
        write_word_segments(seg_path, words)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["beat", "dnd"], required=True)
    ap.add_argument("--src", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.mode == "beat":
        transcribe_tree(args.src, args.out or
                        os.path.join(args.src, "whisper_transcription"))
    else:
        # dnd mode writes seg_*.txt NEXT TO the source wavs (the layout
        # the dataset loader expects) — an --out dir is not applicable
        if args.out:
            ap.error("--out is not supported with --mode dnd: seg files "
                     "are written next to the source wavs")
        create_word_segments(args.src)
