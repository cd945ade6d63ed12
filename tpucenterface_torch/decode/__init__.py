"""Decode: the reference torch decode (`reference`) and the fused CUDA decode
kernel with its plain version (`fused_decode`)."""

from tpucenterface_torch.decode.reference import boxes_to_original, decode_feats

__all__ = ["decode_feats", "boxes_to_original"]
