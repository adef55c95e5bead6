"""PyTorch/CUDA port of the PandaDB reproduction.

Mirrors the JAX package module for module.  Plain tensor code is PyTorch;
each Pallas kernel of the reference becomes a CUDA kernel written by hand
for Hopper (``csrc/``), built with ``nvcc`` at first use.  Entry points run
on the CUDA card unless the caller passes ``device="cpu"``.
"""
