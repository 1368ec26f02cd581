"""Optimizers on the port's pytrees (the counterpart of
``repro/optim``)."""
