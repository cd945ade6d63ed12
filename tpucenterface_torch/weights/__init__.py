"""Weights: safetensors reading (`io`), BatchNorm folding (`fold`) and the
JAX-layout -> module carry-across (`convert`)."""
