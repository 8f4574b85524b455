"""A cell's pieces at a size the CPU runs in seconds, for the tests."""
from __future__ import annotations

import copy
import time

from perfbench import harness


def tiny_model(model: dict, steps: int = 4) -> dict:
    m = copy.deepcopy(model)
    m["latent_dim"] = [1, 32]
    m["text_pad_len"] = 16
    m["denoiser"].update(num_layers=3, ff_size=64, text_encoded_dim=64)
    m["motion_vae"].update(num_layers=3, ff_size=64)
    m["text_encoder"].update(latent_dim=64, d_model=32, d_ff=64,
                             num_layers=2, num_heads=4, d_kv=8)
    m["audio_encoder"].update(latent_dim=64)
    m["scheduler"]["num_inference_timesteps"] = steps
    return m


def context(cell: str, tmp_path, seed: int = 11, dtype: str = "float32",
            trace: bool = False, batch: int = 4,
            steps: int = 4) -> harness.Context:
    bench = harness.manifest()
    w = harness.workload(cell, bench)
    config = harness.config(w["config"], bench)
    config = {**config, "model": tiny_model(config["model"], steps),
              "compute_dtype": dtype}
    traffic = {**harness.traffic(w["traffic"]), "batch": batch, "pool": 3}
    return harness.Context(workload=cell, seed=seed, seconds=0.5,
                           trace=trace, device="cpu", config=config,
                           traffic=traffic, workdir=str(tmp_path),
                           t_start=time.perf_counter())
