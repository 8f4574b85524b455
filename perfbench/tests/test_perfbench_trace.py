"""The trace reader on a hand-made Chrome trace."""
import pytest

from perfbench import trace


def ev(cat, name, ts, dur):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "ph": "X"}


def test_busy_launches_kernels_and_gaps():
    events = [
        ev("user_annotation", "pb_window", 0, 100),
        ev("user_annotation", "step", 0, 90),
        ev("cpu_op", "aten::mm", 5, 10),
        ev("cuda_runtime", "cudaLaunchKernel", 6, 1),
        ev("cuda_runtime", "cudaGraphLaunch", 30, 1),
        ev("cuda_runtime", "cudaMemcpyAsync", 31, 1),
        ev("cuda_runtime", "cudaLaunchKernel", 150, 1),   # outside
        ev("kernel", "gemm", 10, 20),
        ev("kernel", "gemm", 25, 10),                     # overlaps
        ev("gpu_memcpy", "Memcpy HtoD", 50, 10),
        ev("cpu_op", "aten::copy_", 45, 20),
    ]
    s = trace.summarize({"traceEvents": events}, "pb_window")
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(35e-6)        # [10, 35) + [50, 60)
    assert s["launches"] == 2
    assert s["kernels"]["gemm"][0] == 2
    assert s["device_ops"][0][0] == "gemm"
    gaps = dict(s["idle_gaps"])
    assert gaps["step/aten::mm"] == pytest.approx(10e-6)     # [0, 10)
    assert gaps["step/aten::copy_"] == pytest.approx(15e-6)  # [35, 50)
    assert gaps["pb_window/python"] == pytest.approx(40e-6)  # [60, 100)
