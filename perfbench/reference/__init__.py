"""Plain float32 references, one module per family, found by the
``reference`` key of a configuration file.  They import neither the port
nor JAX."""
