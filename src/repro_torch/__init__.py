"""PyTorch/CUDA port of ``repro``: the effect handlers, the distributions
and iterative NUTS in eager PyTorch, with the hot kernels written by hand
for Hopper (``csrc/``).  It imports ``torch`` and ``numpy`` and nothing of
JAX or of the ``repro`` package.

Entry points run on ``"cuda"`` unless the caller passes ``device="cpu"``.
"""
