"""DnD sessions -> 5.12 s utterance-set dataset.

Port of ``convofusion_tpu/scripts/make_utterance_dataset.py``; the silence
scans run on ``device`` (``scripts/silence.py``), everything else on the
host.  Reference: scripts/dnd_make_utterance_dataset.py — split each session's
speaker audio on silence (min 1000 ms, -45 dBFS, keep 10 ms), tile each
speech utterance into ``num_frames``-frame chunks, and write per-chunk
utterance sets: motion_spk.npy + 4 listener motions, audio wavs, texts
(transcribed), in the layout the BEATAugReactionDataset loader consumes.

Deviations from the reference, documented:
  * the speaker role rotates over every person with active speech in the
    window (the reference fixes roles per session file layout)
  * transcription uses the pluggable backend (whisper when available)

Run: python -m convofusion_tpu_torch.scripts.make_utterance_dataset
     --sessions <dir> --out <dir> [--device cpu]
"""
from __future__ import annotations

import argparse
import glob
import os
from os.path import join as pjoin

import numpy as np

from convofusion_tpu_torch.data.audio import load_wav, save_wav
from convofusion_tpu_torch.scripts.silence import (
    detect_silence,
    split_on_silence,
)
from convofusion_tpu_torch.scripts.transcribe import (
    default_transcriber,
    write_word_segments,
)


def process_session(session_path: str, output_folder: str,
                    num_frames: int = 128, fps: int = 25,
                    sr: int = 16000, transcriber=None, device=None) -> int:
    """One session dir with person_<i>.wav + person_<i>.npy (25 fps motion)
    for 5 people -> utterance sets under output_folder/<session>/set_*/ ;
    the silence scans on ``device``."""
    transcriber = transcriber or default_transcriber()
    session = os.path.basename(session_path.rstrip("/"))

    wavs = sorted(glob.glob(pjoin(session_path, "person_*.wav")))
    if len(wavs) != 5:
        print(f"skip {session}: expected 5 person wavs, got {len(wavs)}")
        return 0
    audio = [load_wav(w, sr)[0] for w in wavs]
    motion = [np.load(w.replace(".wav", ".npy")) for w in wavs]

    window_ms = int(num_frames / fps * 1000)
    window_samples = int(num_frames / fps * sr)
    n_sets = 0

    for spk_idx in range(5):
        # utterances of this person = nonsilent stretches of their track
        _, ranges = split_on_silence(
            audio[spk_idx], sr, min_silence_len=1000,
            silence_thresh=-45.0, keep_silence=10, device=device)
        for start_ms, end_ms in ranges:
            if end_ms - start_ms < window_ms:
                continue
            for chunk_ms in range(start_ms, end_ms - window_ms + 1,
                                  window_ms):
                s_sample = int(chunk_ms * sr / 1000)
                s_frame = int(chunk_ms * fps / 1000)
                a_spk = audio[spk_idx][s_sample:s_sample + window_samples]
                m_spk = motion[spk_idx][s_frame:s_frame + num_frames]
                if len(a_spk) < window_samples or \
                        len(m_spk) < num_frames:
                    continue
                # per-person tracks can differ in length by a few
                # frames; every listener slice must be full-length too,
                # or the loader gets mis-shaped motion_lsn arrays
                if any(len(motion[p]) < s_frame + num_frames
                       or len(audio[p]) < s_sample + window_samples
                       for p in range(5) if p != spk_idx):
                    continue
                # the reference discards windows whose speaker track has
                # internal silence gaps (dnd_make_utterance_dataset.py:237)
                if len(detect_silence(a_spk, sr, min_silence_len=200,
                                      silence_thresh=-40.0,
                                      device=device)) > 1:
                    continue

                set_dir = pjoin(output_folder, session,
                                f"set_{n_sets:04d}_p{spk_idx}")
                os.makedirs(set_dir, exist_ok=True)
                np.save(pjoin(set_dir, "motion_spk.npy"), m_spk)
                save_wav(pjoin(set_dir, "audio_spk.wav"), a_spk, sr)
                text, words = transcriber(a_spk, sr)
                with open(pjoin(set_dir, "text_spk.txt"), "w") as f:
                    f.write(text)
                write_word_segments(pjoin(set_dir, "seg_spk.txt"), words)

                li = 0
                for p in range(5):
                    if p == spk_idx:
                        continue
                    li += 1
                    a = audio[p][s_sample:s_sample + window_samples]
                    m = motion[p][s_frame:s_frame + num_frames]
                    np.save(pjoin(set_dir, f"motion_lsn{li}.npy"), m)
                    save_wav(pjoin(set_dir, f"audio_lsn{li}.wav"), a, sr)
                    t, w = transcriber(a, sr)
                    with open(pjoin(set_dir, f"text_lsn{li}.txt"),
                              "w") as f:
                        f.write(t)
                    write_word_segments(
                        pjoin(set_dir, f"seg_lsn{li}.txt"), w)
                n_sets += 1
    return n_sets


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", required=True,
                    help="dir of session dirs with person_<i>.{wav,npy}")
    ap.add_argument("--out", required=True)
    ap.add_argument("--num_frames", type=int, default=128,
                    help="128 for 5.12s sets; 768 for 30s long-form sets")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the host; default the card")
    args = ap.parse_args(argv)
    total = 0
    for session in sorted(glob.glob(pjoin(args.sessions, "*/"))):
        total += process_session(session, args.out, args.num_frames,
                                 device=args.device)
    print(f"wrote {total} utterance sets to {args.out}")
    return total


if __name__ == "__main__":
    main()
