"""Fused operators of the port (mirrors `tpucenterface/ops/`)."""
