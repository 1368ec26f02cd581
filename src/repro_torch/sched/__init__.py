"""Population and cohort scheduling (the counterpart of ``repro.sched``).

``ClientPopulation`` holds per-client persistent state on the host (the
control-variate arena, the per-client seeds, the participation counters);
``CohortScheduler`` streams cohorts of C clients through the driver's
``step(..., cohort=...)``, synchronously (one full cohort is bit for bit
``api.run``) or asynchronously with a bounded-staleness buffer
(``FederationSpec.max_staleness`` / ``staleness_weight``).
"""
from .population import ClientPopulation  # noqa: F401
from .scheduler import CohortScheduler, cohort_ids  # noqa: F401
from . import staleness  # noqa: F401
