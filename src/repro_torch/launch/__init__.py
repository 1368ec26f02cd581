"""Entry points of the port: ``serve`` (prefill + greedy decode)."""
