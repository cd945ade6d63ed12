"""mbconv_roofline.tta: `mbconv_roofline` in the TTA cells, where it moves `images_per_s.tta`."""

from perfbench.registry import reader

read = reader("mbconv_roofline")
