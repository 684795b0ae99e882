"""Runtime: fault injection (``chaos``), the straggler balancer
(``straggler``), checkpoint/restart with elastic re-pairing and stateful
VW migration (``fault_tolerance``)."""
from .chaos import ChaosEvent, ChaosSchedule  # noqa: F401
from .fault_tolerance import (FaultTolerantRunner, FTConfig,  # noqa: F401
                              VWStateMigrator, plan_remesh)
from .straggler import DelegationBalancer, StragglerConfig  # noqa: F401
