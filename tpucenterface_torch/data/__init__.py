"""Data: WIDER records and parsers (`wider`), target rendering (`targets`),
augmentation (`augment`), the batch pipeline (`loader`) and the procedural
scene generator (`synth`)."""
