"""images_per_s.tta: `images_per_s` in the TTA cells, where it moves `images_per_s.tta`."""

from perfbench.registry import reader

read = reader("images_per_s")
