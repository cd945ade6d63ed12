"""Evaluation: the WIDER AP protocol (`wider_eval`), flip and multi-scale
test-time augmentation (`tta`), bucketed batched runners (`batch_runner`) and
AP over in-memory records (`synth_eval`). Host-side numpy around the
Detector's programs."""
