"""Hand-written Hopper kernels of the port, each beside its plain version.

``csrc/*.cu`` holds the CUDA sources; ``build`` compiles and loads them at
first use; ``flash_attention``, ``decode_attention`` and ``int8_matmul`` hold
the wrappers; ``ref`` holds the plain PyTorch versions.
"""
