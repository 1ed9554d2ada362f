"""Model configs (``base``), one module per architecture, and ``registry``."""
