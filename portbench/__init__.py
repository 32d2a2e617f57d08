"""The port's benchmark: p3achygo_tpu_torch self-play on one NVIDIA card (run.py)."""
