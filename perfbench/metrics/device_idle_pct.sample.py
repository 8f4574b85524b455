"""Share of a sampling call in which no kernel, copy or memset runs on the
device: the device's busy seconds in one profiled call (the union of
their intervals in the trace) over the mean unprofiled call of the
window.  The profiler slows the host, not the device, so its own window
would overstate the idle share."""


def read(rec):
    tr = rec.get("trace")
    if tr is None or "trace_calls" not in rec:
        return None
    busy = tr["busy_s"] / rec["trace_calls"]
    return 100.0 * (1.0 - busy / (rec["window_s"] / rec["calls"]))
