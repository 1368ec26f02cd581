"""The federated LM trainer (the counterpart of ``repro.fed``)."""
