"""Training losses (port of ``convofusion_tpu/losses``)."""
