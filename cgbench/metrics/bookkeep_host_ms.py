"""bookkeep_host_ms: host self time of the port's span ``cg.run`` (its
wall time less ``cg.route`` and ``cg.delegate``: arrivals, queues,
latency, imbalance, the state rebuild, the final stacks) a slot, over the
traced half of a --trace 1 run (host_clock, with the profiler's cost on
each op)."""
from cgbench.harness.spans import per_slot_ms


def read(rec):
    return per_slot_ms(rec, "cg.run", self_time=True)
