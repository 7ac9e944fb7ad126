"""PyTorch + CUDA port of multi_modal_image_fusion_tpu for NVIDIA Hopper.

The JAX package beside this one is the reference. This package imports
torch and numpy, never jax, flax or the JAX package. Public functions keep
the reference's NHWC layout; module and parameter names follow the
reference PyTorch state dict, so reference `.pth` files load directly.

Entry points run on the CUDA card unless the caller asks for the CPU
(`--device cpu`); on a CUDA tensor each kernel wrapper launches its
hand-written kernel (ops/cuda/) or raises, and only CPU tensors take the
plain PyTorch versions.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
