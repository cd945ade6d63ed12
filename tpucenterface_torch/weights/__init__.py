"""Weights: safetensors, scales and packed artifacts (`io`), BatchNorm
folding (`fold`), the JAX-layout -> module carry-across (`convert`), and the
torch `.pth` importer (`port`) with its reference twin (`torch_twin`)."""
