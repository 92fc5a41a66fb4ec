"""Hand-written CUDA kernels of the sketch passes, their plain PyTorch
versions, and the device-dispatching wrappers (``ops``)."""
