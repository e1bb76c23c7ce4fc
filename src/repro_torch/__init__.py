"""InferSpark's VMP stack in PyTorch, for one NVIDIA H100.

The port of the JAX package ``repro`` (which stays the reference): the same
DSL, compiler and model zoo, a full-batch VMP runtime on torch tensors, and
hand-written Hopper kernels for its hot loop (``kernels/``).  It imports
``torch`` and numpy, never ``jax`` and nothing of ``repro``.
"""
