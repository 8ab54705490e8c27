"""dqnlint plugins of the port: one module per check, discovered by
``dist_dqn_tpu_torch.analysis.registry.discover()`` (a pkgutil walk —
adding a check is adding a file here that calls ``register(SomeCheck())``
at import time; no central list to edit)."""
