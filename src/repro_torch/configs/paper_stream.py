"""The paper's own experimental configuration (simulation scale), a copy
of ``repro.configs.paper_stream``.

Matches §VII: 10 workers × 10 virtual workers, ε=0.01, thresholds
0.75/0.85, WP-like workload, ρ=0.8 provisioning.
"""
from repro_torch.core.cg import CGConfig
from repro_torch.core.streams import TW_TRACE, WP_TRACE  # noqa: F401

PAPER_CG = CGConfig(
    n_workers=10, alpha=10, eps=0.01,
    theta_busy=0.85, theta_idle=0.75,
    slot_len=10_000, max_moves_per_slot=8, inner="PORC",
    block_size=0,   # the paper routes one message per unit time — keep
                    # the exact oracle here; block_size>1 is the runtime
                    # fast path with its own staleness floor
)

RHO = 0.8                       # provisioning point (workers at 80%)
STORM_WORKERS = 24              # Fig 14/15 deployment
STORM_SOURCES = 8
SERVICE_MS_SWEEP = (0.1, 0.25, 0.5, 1.0)
CPULIMIT_FRACTION = 0.3         # two executors limited to 30%
