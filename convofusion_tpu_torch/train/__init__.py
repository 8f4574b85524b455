"""Training of both stages (port of ``convofusion_tpu/train``)."""
