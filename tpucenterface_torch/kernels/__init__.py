"""Build and load the port's CUDA sources (`build`)."""
