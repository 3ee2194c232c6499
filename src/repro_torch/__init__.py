"""PyTorch/CUDA port of the W1A8 BNN detector (`repro` is the JAX reference).

Module names mirror the JAX package so each port module's counterpart is
found at the same path under ``repro``. The port imports ``torch`` and never
``jax`` or ``repro``; only the tests import both. Entry points run on the
card (``device="cuda"``) unless the caller passes ``device="cpu"``.
"""
