"""PyTorch + CUDA port of weclip_tpu for NVIDIA Hopper.

The module layout mirrors ``weclip_tpu`` so every module has a counterpart
there.  Plain tensor code is PyTorch; each TPU (Pallas) kernel on the ported
path is a hand-written CUDA kernel under ``csrc/``, built at first use by
``weclip_tpu_torch.kernels``.  The package imports neither JAX nor anything
from ``weclip_tpu``.
"""
