"""Examples of ``repro_torch.api`` (the counterparts of the reference's
``examples/``). Each runs as ``python -m repro_torch.examples.<name>``;
importing one runs nothing."""
