"""Driving, tracing and checking one cell of the benchmark."""
