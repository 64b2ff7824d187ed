"""PyTorch / CUDA port of the data-local engine, for an NVIDIA H100.

The JAX package ``repro`` stays the reference; this package mirrors its
layout module for module and imports nothing of it (nor of JAX).  Entry
points run on the CUDA card unless the caller passes ``device="cpu"``.
"""
