"""Entry points: ``serve`` (progressive serving with a layered LM head)."""
