"""The benchmark's general machinery: cell specs, the traffic generator,
the measured loops, trace reading, the roofline arithmetic, the
correctness check and the module isolation check. Nothing here belongs
to one configuration, traffic mix or metric."""
