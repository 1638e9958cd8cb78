"""me_refine_roofline: me_refine's share of its roofline over the
profiled stretch's launches (see _roofline.py)."""
from portbench.metrics._roofline import share

KERNELS = ("me_refine",)


def read(run):
    return share(run, "me_refine")
