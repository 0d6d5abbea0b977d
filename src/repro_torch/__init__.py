"""PyTorch + CUDA port of the PIMCQG query path (beside the JAX package
``repro``, which stays the reference). Imports torch and numpy only."""
