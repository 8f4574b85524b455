"""The trace summary names an idle gap by the program's own span: a tiny
DDIM-2 sampling call of the port under the CPU profiler, with a kernel put
halfway into the second reverse step's denoiser call."""
import copy
import json

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from convofusion_tpu_torch.config import TINY
from convofusion_tpu_torch.data.synthetic import (
    prepare_arrays,
    synthetic_raw_batch,
)
from convofusion_tpu_torch.models.convofusion import Convofusion
from perfbench import trace

LABEL = "pb_window"


def test_summary_names_a_gap_by_a_program_span(tmp_path):
    cfg = copy.deepcopy(TINY)
    cfg["scheduler"].update(variant="ddim", num_inference_timesteps=2)
    m = Convofusion(cfg, device="cpu", seed=0)
    batch, _, _ = prepare_arrays(m, synthetic_raw_batch(0, 2))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(LABEL):
            m.sample(batch, torch.Generator().manual_seed(0),
                     num_inference_steps=2)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    den = sorted((e for e in events["traceEvents"]
                  if e.get("cat") == "user_annotation"
                  and e["name"] == "denoiser"), key=lambda e: e["ts"])
    assert len(den) == 2
    mid = float(den[1]["ts"]) + float(den[1]["dur"]) / 2
    events["traceEvents"].append({"cat": "kernel", "name": "k", "ph": "X",
                                  "ts": mid, "dur": 1.0})
    summary = trace.summarize(events, LABEL)
    assert any(name.startswith("denoiser/")
               for name, _ in summary["idle_gaps"]), summary["idle_gaps"]
