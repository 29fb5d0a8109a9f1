"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

Sources are in ``csrc/``; ``build.build(name)`` compiles one with ``nvcc``
into ``_build/`` at first use. Importing this package builds nothing.
"""
