"""Hopper kernels of the port and their plain PyTorch versions.

``ops`` dispatches by the tensor's device; ``ref`` holds the plain versions;
``fused_zstats`` (CUDA C++, ``csrc/zstats.cu``), ``dirichlet_expectation``
and ``vmp_zstep`` (Triton) hold the kernels and their wrappers.
"""
