"""Batch rows of the optimizer steps of the window, over the window's
seconds until the device finished the last step (host clock)."""


def read(rec):
    return rec["train_rows"] / rec["window_s"] if "train_rows" in rec \
        else None
