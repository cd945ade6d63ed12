"""Decode: the reference torch decode (`reference`) and the fused CUDA decode
kernel with its plain version (`fused_decode`)."""
