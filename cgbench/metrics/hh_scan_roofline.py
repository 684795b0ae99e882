"""hh_scan_roofline: the heavy-hitter branch of porc_multisource_scan
(porc_multisource_cluster_kernel<true, ...>): the least time of the
traced slots' routing work (cgbench.harness.roofline.hh_scan_work) over
the kernel's device time, in %."""
from cgbench.harness import roofline

KERNEL = r"porc_multisource_cluster_kernel<true"


def read(rec):
    return rec.kernel_roofline(KERNEL, roofline.hh_scan_work)
