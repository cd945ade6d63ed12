"""preprocess_launched_ms_per_image.tta: `preprocess_launched_ms_per_image` in the TTA cells, where it moves `images_per_s.tta`."""

from perfbench.registry import reader

read = reader("preprocess_launched_ms_per_image")
