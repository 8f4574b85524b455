"""128-frame clips returned by the calls of the window, over the window's
seconds, the last call's tail included (host clock)."""


def read(rec):
    return rec["clips"] / rec["window_s"] if "clips" in rec else None
