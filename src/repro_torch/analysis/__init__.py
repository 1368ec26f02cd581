"""Analysis tools of the port: ``hb``, the happens-before checker that the
scheduler's population and snapshot writer report to."""
