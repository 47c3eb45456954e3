"""LM serving on the port: ``generate`` (static batch) and ``ServeLoop``
(continuous batching) in ``serve/engine.py``."""
