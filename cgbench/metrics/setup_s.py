"""setup_s: seconds from the start of the process to the first measured
slot: imports, the kernels built or loaded, the stream made on the
device, the warm-up slots."""


def read(rec):
    return rec.setup_s
