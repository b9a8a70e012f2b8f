"""Triplane decoder and plane super-resolution (counterparts of
nvsr_tpu.models)."""
