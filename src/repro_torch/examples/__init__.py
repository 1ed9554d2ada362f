"""Walkthroughs of the port, the twins of the JAX package's
``examples/``: ``quickstart``, ``runtime_deadline``,
``serve_progressive``, ``train_lm`` and ``fault_tolerance``.  Each keeps
its twin's steps and assertions, runs on the card unless ``--device cpu``
is passed, and is run as ``python -m repro_torch.examples.<name>``.
"""
