"""slot_cpu_ms: the harness thread's CPU time inside each call into
cg.run, a mean over the window's slots (host_clock; the untraced part of a
--trace 1 run)."""


def read(rec):
    return rec.mean_cpu_ms()
