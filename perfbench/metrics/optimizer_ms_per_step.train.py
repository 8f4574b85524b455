"""Milliseconds of ``Trainer.apply_grads`` (AdamW on the fp32 masters and
the copy into the bf16 weights), synchronised, mean of three steps."""


def read(rec):
    spans = rec.get("spans", {}).get("optimizer")
    return 1e3 * sum(spans) / len(spans) if spans else None
