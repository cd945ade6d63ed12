"""Training: losses, the train step and state, the loop with checkpoints and
exports, metrics logging (`tpucenterface/train/` of the JAX package)."""
