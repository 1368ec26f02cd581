"""The port's driver API (the counterpart of ``repro.api``)."""
from .driver import (CohortPartial, CohortSlice, DriverState, apply_partial,
                     centralized_init, centralized_step, finalize_partial,
                     history_list, init, local_rows, mean_oracle_diag,
                     resolve_device, run, step, tier_boundary,
                     variates_at_init)
from .problem import MMProblem, as_problem
from .schedule import decaying_stepsize, resolve_schedule, schedule_length
from .spec import FederationSpec, participation_draw
from .topology import Topology
