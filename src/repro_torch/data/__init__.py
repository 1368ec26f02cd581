"""Synthetic data and federated client splits of the paper's experiments
(the counterpart of ``repro/data``)."""
