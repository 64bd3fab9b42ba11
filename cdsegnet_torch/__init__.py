"""CDSegNet in PyTorch for NVIDIA Hopper GPUs.

A port of the JAX package `cdsegnet_tpu`, module for module: each module here
carries the name of its JAX counterpart. Plain tensor code is PyTorch; the
masked patch-attention forward is a CUDA kernel written for ``sm_90a``
(`cdsegnet_torch/csrc/patch_attention_fwd.cu`), built with ``nvcc`` at first
use into ``cdsegnet_torch/_build/``.

Entry points run on the GPU unless the caller passes ``device="cpu"``; on the
CPU every kernel is replaced by its plain PyTorch version.
"""

__version__ = "0.1.0"
