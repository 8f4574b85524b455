"""See the package docstring of convofusion_tpu_torch."""
