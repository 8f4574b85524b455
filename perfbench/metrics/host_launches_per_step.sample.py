"""Kernel launch calls on the host (cudaLaunchKernel and the like; a
graph launch counts one) in the profiled call, per reverse step."""


def read(rec):
    tr = rec.get("trace")
    if tr is None or "trace_calls" not in rec:
        return None
    return tr["launches"] / (rec["trace_calls"] * rec["steps_per_call"])
