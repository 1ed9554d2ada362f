"""Entry points and the launch layer: ``serve`` (progressive serving with
a layered LM head), ``train`` (training on one device), ``steps`` (the step
functions), ``mesh`` and ``sharding`` (device meshes and the sharding
rules on ``torch.distributed``) and ``fault`` (elastic restore and coded
data parallelism)."""

from repro_torch.launch import mesh, sharding  # noqa: F401
