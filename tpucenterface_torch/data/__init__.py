"""Data: the WIDER annotation record (`wider.WiderImage`)."""
