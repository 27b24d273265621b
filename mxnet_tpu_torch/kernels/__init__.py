"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (counterpart of mxnet_tpu/pallas_kernels/)."""
