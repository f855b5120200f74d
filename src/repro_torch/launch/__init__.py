"""Launchers of the port (``repro/launch`` of the JAX package): the step
factories of ``steps`` (train, prefill, serve), ``train.main`` and
``serve.main``, and ``mesh.make_inference_mesh`` (the MCMC executor's
device mesh).  The multi-pod dry-run and the LM meshes wait for the LM slice
of the multi-GPU item (ROADMAP.md)."""
