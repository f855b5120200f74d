"""Hand-written Hopper kernels of the port and their plain PyTorch versions
(see ``ops.py`` for the table of ops)."""
