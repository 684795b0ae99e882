"""slot_mfu: the least time of a whole slot's work (routing and
delegation, cgbench.harness.roofline.slot_work) over the slot's wall time
in the untraced window, in %. It bounds what any kernel's share can buy."""
from cgbench.harness import roofline


def read(rec):
    if rec.window.slots == 0 or not rec.device_kind:
        return None
    bound, _ = roofline.bound_s(*roofline.slot_work(rec.cell.cg))
    return 100.0 * bound / rec.slot_wall_s()
