"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version. :mod:`repro_torch.kernels.ops` dispatches by device: CPU tensors
go to the plain version, CUDA tensors to the kernel (or raise)."""
