"""The paper's figure reproductions on the port (the counterparts of the
reference's ``benchmarks/run.py``, ``fig1_dictlearn.py`` and
``fig2_control_variates.py``). Each script runs as
``python -m repro_torch.benchmarks.<name>``; importing one runs nothing."""
