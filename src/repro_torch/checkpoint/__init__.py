"""Atomic, self-describing pytree checkpoints (the counterpart of
``repro.checkpoint``)."""
from .checkpoint import restore, save

__all__ = ["restore", "save"]
