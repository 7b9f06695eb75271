"""Plain float32 references, one module a model family, named by each
configuration file's ``reference`` key."""
