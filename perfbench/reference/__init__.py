"""The benchmark's plain reference: CenterFace-style detection in float32.

Plain PyTorch and NumPy only. It imports nothing of the measured program (nor
of the JAX package) and takes none of what the program derives from the
weights: it reads the raw variables (kernels, BatchNorm parameters and
running statistics, unfolded) and the raw uint8 frames, and works out the
normalisation, the letterbox, the network, the decode, the inverse letterbox
and the test-time-augmentation merge itself. Matrix products and
convolutions run in float32 with TF32 off (`float32_exact`).

The network is the architecture's that the configuration names
(`<arch>.py`, found by `registry.reference`); `model.py` holds what the
architectures share, `detect.py` everything around the network.
"""
