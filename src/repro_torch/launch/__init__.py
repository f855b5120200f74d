"""Launchers of the port (``repro/launch`` of the JAX package): the step
factories of ``steps`` (train, prefill, serve), ``train.main`` and
``serve.main``.  The multi-pod dry-run and the mesh wait for the multi-GPU
item (ROADMAP.md)."""
