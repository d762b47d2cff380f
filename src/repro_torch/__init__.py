"""PyTorch/CUDA port of the HSGD e-health federation (``repro``'s twin).

The module layout mirrors ``repro`` so each function's counterpart sits at
the same path. The package imports ``torch`` and ``numpy`` only; the JAX
package is the reference that the parity tests hold this one against.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
