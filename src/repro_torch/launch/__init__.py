"""Launchers of the port: the serving half of the JAX package's
``repro/launch`` (``steps.make_prefill_step``/``make_serve_step`` and
``serve.main``).  Training waits for its slice."""
