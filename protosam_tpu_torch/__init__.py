"""protosam_tpu_torch — the ProtoSAM slice pipeline and the ALPNet
training path in PyTorch, with hand-written CUDA kernels for NVIDIA
Hopper.

The port of ``protosam_tpu`` (JAX/Pallas on a TPU), which stays the
reference: same module layout, reference PyTorch ``state_dict`` key names.
Importing this package imports torch and numpy only, never JAX; the CUDA
kernels build on first use (``protosam_tpu_torch.kernels``).
"""

__version__ = "0.1.0"
