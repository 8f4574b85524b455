"""Seconds from the process's start to the window: imports, weights,
model build, the kernel's load or build, warm-up (host clock)."""


def read(rec):
    return rec["setup_s"]
