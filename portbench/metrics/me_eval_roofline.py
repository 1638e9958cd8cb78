"""me_eval_roofline: me_eval's share of its roofline (pair and
one-list modes) over the profiled stretch's launches (see
_roofline.py)."""
from portbench.metrics._roofline import share

KERNELS = ("me_eval",)


def read(run):
    return share(run, "me_eval")
