"""PyTorch/CUDA port of the NIMBLE reproduction (the JAX package is ``repro``).

Imports torch and numpy only, never JAX or ``repro``.  Entry points run on
the card (``device="cuda"``) unless the caller asks for ``"cpu"``.
"""
