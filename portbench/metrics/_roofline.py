"""Shared arithmetic of the <kernel>_roofline readers: over the
launches of the profiled stretch, the sum of each launch's bound time
(the larger of its bytes over the HBM rate and its operations over the
float32 rate, counted from its shapes by rooflines/<kernel>.py) over the
sum of its device time in the profiler's kernel records."""
from portbench.peaks import bound_s


def share(run, kernel: str):
    st = run.stretch
    if st is None:
        return None
    works = st.launches.get(kernel, [])
    name = run.roofline(kernel).KERNEL_NAME
    recs = [d for n, _, d in st.kernels if name in n]
    if not works or len(recs) != len(works):
        return None
    dev = sum(recs) * 1e-9
    return 100.0 * sum(bound_s(b, o) for b, o in works) / dev
