"""Elementwise physics, the plain nearest-hit twin and the CUDA kernel."""
