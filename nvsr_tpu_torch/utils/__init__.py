"""Host-side utilities (counterparts of nvsr_tpu/utils/)."""
