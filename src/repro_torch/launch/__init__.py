"""Entry points: ``serve`` (progressive serving with a layered LM head),
``train`` (training on one device) and ``steps`` (the step functions)."""
