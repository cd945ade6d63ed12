"""Command-line entry points of the port (`python -m tpucenterface_torch.cli.<name>`)."""
