"""3-D skeleton visualization of generated gesture clips.

Port of ``convofusion_tpu/scripts/visualize.py`` (host only; matplotlib is
imported inside the call).  Reference: scripts/visualize.py (matplotlib
3D animation + ffmpeg audio mux).  Renders a result dir's pred/gt npy files to mp4 (ffmpeg when
present) or an animated gif / png contact sheet.

Run: python -m convofusion_tpu_torch.scripts.visualize --npy <pred.npy>
     [--audio <lsn_audio.wav>] [--out clip.mp4]
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess

import numpy as np

# kinematic tree over the canonical 63 joints (configs assets BONES)
DEFAULT_BONES = [
    (0, 4), (4, 3), (3, 2), (2, 1), (0, 18), (18, 19), (19, 20), (20, 21),
    (21, 22), (0, 13), (13, 14), (14, 15), (15, 16), (16, 17), (3, 9),
    (9, 10), (10, 11), (3, 5), (5, 6), (6, 7),
]


def render_clip(joints: np.ndarray, out_path: str, fps: int = 25,
                bones=DEFAULT_BONES, title: str = "", stride: int = 1):
    """joints (T, J, 3) -> animation file (.mp4 / .gif) or .png sheet."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import animation

    joints = joints[::stride]
    t, j, _ = joints.shape
    fig = plt.figure(figsize=(5, 5))
    ax = fig.add_subplot(111, projection="3d")
    center = joints.reshape(-1, 3).mean(0)
    radius = max(1e-3, np.abs(joints - center).max())

    def setup():
        ax.clear()
        ax.set_xlim(center[0] - radius, center[0] + radius)
        ax.set_ylim(center[2] - radius, center[2] + radius)
        ax.set_zlim(center[1] - radius, center[1] + radius)
        ax.set_title(title)
        ax.set_axis_off()

    def draw(frame):
        setup()
        pts = joints[frame]
        ax.scatter(pts[:, 0], pts[:, 2], pts[:, 1], s=4, c="k")
        for a, b in bones:
            if a < j and b < j:
                ax.plot([pts[a, 0], pts[b, 0]], [pts[a, 2], pts[b, 2]],
                        [pts[a, 1], pts[b, 1]], c="tab:blue", lw=1.5)
        return []

    if out_path.endswith(".png"):
        # contact sheet of 8 evenly spaced frames
        idx = np.linspace(0, t - 1, 8).astype(int)
        fig2, axes = plt.subplots(1, 8, figsize=(24, 3),
                                  subplot_kw={"projection": "3d"})
        for a_i, f in zip(axes, idx):
            pts = joints[f]
            a_i.scatter(pts[:, 0], pts[:, 2], pts[:, 1], s=2, c="k")
            for a, b in bones:
                if a < j and b < j:
                    a_i.plot([pts[a, 0], pts[b, 0]],
                             [pts[a, 2], pts[b, 2]],
                             [pts[a, 1], pts[b, 1]], c="tab:blue", lw=1)
            a_i.set_axis_off()
        fig2.savefig(out_path, dpi=120, bbox_inches="tight")
        plt.close(fig2)
        plt.close(fig)
        return out_path

    anim = animation.FuncAnimation(fig, draw, frames=t,
                                   interval=1000 / fps * stride)
    writer = ("ffmpeg" if out_path.endswith(".mp4")
              and shutil.which("ffmpeg") else "pillow")
    if writer == "pillow" and out_path.endswith(".mp4"):
        out_path = out_path[:-4] + ".gif"
    anim.save(out_path, writer=writer, fps=max(1, int(fps / stride)))
    plt.close(fig)
    return out_path


def mux_audio(video_path: str, audio_path: str, out_path: str) -> str:
    """ffmpeg audio mux (visualize.py's final step); no-op without ffmpeg."""
    if not shutil.which("ffmpeg"):
        return video_path
    subprocess.run(
        ["ffmpeg", "-y", "-i", video_path, "-i", audio_path, "-c:v",
         "copy", "-c:a", "aac", "-shortest", out_path],
        check=True, capture_output=True)
    return out_path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--npy", required=True)
    ap.add_argument("--audio", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--fps", type=int, default=25)
    ap.add_argument("--stride", type=int, default=1)
    args = ap.parse_args(argv)
    joints = np.load(args.npy)
    if joints.ndim == 2:
        joints = joints.reshape(len(joints), -1, 3)
    out = args.out or os.path.splitext(args.npy)[0] + ".mp4"
    out = render_clip(joints, out, args.fps, stride=args.stride,
                      title=os.path.basename(os.path.dirname(args.npy)))
    if args.audio and out.endswith(".mp4"):
        out = mux_audio(out, args.audio,
                        os.path.splitext(out)[0] + "_av.mp4")
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
