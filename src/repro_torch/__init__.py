"""PyTorch/CUDA port of the epidemic simulator in ``repro``.

Module for module the layout of ``repro`` (the JAX/Pallas reference, which
this package never imports). Plain tensor code is PyTorch; the interaction
pass runs a hand-written CUDA kernel for Hopper on the card and its plain
PyTorch version on the CPU.
"""
