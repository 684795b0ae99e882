"""msgs_per_s: every message routed in the closed-loop window over the
window's seconds (the window closes when the device has finished)."""


def read(rec):
    w = rec.window
    if w.kind != "closed" or w.seconds <= 0:
        return None
    return w.slots * rec.cell.slot_len / w.seconds
