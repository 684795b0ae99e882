"""route_host_ms: host wall time of the port's span ``cg.route`` (the
slot's routing, ``_route_slot``) a slot, over the traced half of a
--trace 1 run (host_clock, with the profiler's cost on each op)."""
from cgbench.harness.spans import per_slot_ms


def read(rec):
    return per_slot_ms(rec, "cg.route")
