"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version, and the ``ops`` dispatch that picks between them by the device of
the tensors it is given."""
