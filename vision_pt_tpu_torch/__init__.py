"""PyTorch and CUDA port of ``vision_pt_tpu`` for NVIDIA Hopper GPUs.

It mirrors the JAX package's module paths (``vision_pt_tpu_torch/x/y.py`` is
the counterpart of ``vision_pt_tpu/x/y.py``), imports nothing of JAX or of the
JAX package, and keeps the JAX package's NHWC image layout at its public
functions. Entry points run on the CUDA device unless the caller passes
``device="cpu"``.
"""
