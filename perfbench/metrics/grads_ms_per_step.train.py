"""Milliseconds of ``Trainer.compute_grads`` (forward, losses, backward),
synchronised before and after, mean of three steps."""


def read(rec):
    spans = rec.get("spans", {}).get("grads")
    return 1e3 * sum(spans) / len(spans) if spans else None
