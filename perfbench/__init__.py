"""The benchmark of the PyTorch and CUDA port (``repro_torch``): a
data-driven harness, its plain references and its yardstick.  See
``README.md``; ``run.py`` is the command."""
