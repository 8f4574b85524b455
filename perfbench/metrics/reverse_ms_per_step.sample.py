"""Milliseconds a reverse step: the ``diffusion_reverse`` span of one call
split at its layer boundaries with synchronises, over its steps."""


def read(rec):
    spans = rec.get("spans", {})
    if "reverse" not in spans:
        return None
    return 1e3 * sum(spans["reverse"]) / len(spans["reverse"]) / \
        rec["steps_per_call"]
