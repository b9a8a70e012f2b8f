"""Plain PyTorch numerics of the eval render (counterparts of nvsr_tpu.ops)."""
