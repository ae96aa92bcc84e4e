"""PyTorch/CUDA port of the `repro` package for one NVIDIA H100.

The JAX package (`repro`) stays the reference; this package imports
`torch`, never `jax`, and nothing of `repro`. Entry points run on the card
(``device="cuda"``) unless the caller asks for the CPU, where every kernel
runs its plain PyTorch version.
"""
