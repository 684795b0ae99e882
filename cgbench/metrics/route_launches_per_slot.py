"""route_launches_per_slot: launches of the port's routing kernels (its own
launch counters, summed) over the window's slots."""


def read(rec):
    if rec.window.slots == 0 or not rec.launches:
        return None
    return sum(rec.launches.values()) / rec.window.slots
