"""Launchers of the port (``repro/launch`` of the JAX package): the step
factories of ``steps`` (train, prefill, serve), ``train.main`` (with
``--mesh``) and ``serve.main``, and the device meshes of ``mesh``: the MCMC
executor's (``make_inference_mesh``) and the LM's (``make_production_mesh``,
``make_host_mesh``).  The multi-pod dry-run is not ported (ROADMAP.md)."""
