"""device_idle: the share of the traced window in which no operation ran
on the card (torch.profiler: the union of kernels, copies and sets)."""


def read(rec):
    return rec.idle_pct()
