"""idle_share.tta: `idle_share` in the TTA cells, where it moves `images_per_s.tta`."""

from perfbench.registry import reader

read = reader("idle_share")
