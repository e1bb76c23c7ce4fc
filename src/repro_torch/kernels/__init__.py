"""Hopper kernels of the port and their plain PyTorch versions.

``ops`` dispatches by the tensor's device; ``ref`` holds the plain versions;
``fused_zstats`` and ``fused_zmap`` (CUDA C++, ``csrc/zstats.cu``),
``flash_attention`` (CUDA C++, ``csrc/flash_attention.cu``),
``dirichlet_expectation`` and ``vmp_zstep`` (Triton) hold the kernels and
their wrappers; ``build`` compiles the CUDA sources.
"""
