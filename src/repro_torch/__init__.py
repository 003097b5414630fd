"""PyTorch/CUDA port of the ShadowSync system, beside the JAX package ``repro``.

It mirrors ``repro``'s layout module for module and imports nothing of it.
Entry points run on the CUDA card unless the caller asks for the CPU; there
the kernel wrappers take their plain PyTorch versions, and only there.
"""
