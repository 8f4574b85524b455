"""Share of a training step in which no kernel, copy or memset runs on
the device: the device's busy seconds a profiled step (the union of
their intervals in the trace) over the window's mean unprofiled step.
The profiler slows the host, not the device, so its own window would
overstate the idle share."""


def read(rec):
    tr = rec.get("trace")
    if tr is None or "trace_steps" not in rec:
        return None
    busy = tr["busy_s"] / rec["trace_steps"]
    return 100.0 * (1.0 - busy / (rec["window_s"] / rec["steps"]))
