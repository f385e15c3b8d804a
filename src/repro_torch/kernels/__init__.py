"""Hopper kernels, their plain PyTorch versions and the storage codec.

Importing this package builds nothing: a kernel is compiled (``_build``)
the first time a CUDA tensor reaches it.
"""
