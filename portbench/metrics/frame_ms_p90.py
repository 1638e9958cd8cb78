"""frame_ms_p90: the 90th percentile (nearest rank), over every frame of
the window, of the time from the frame's yield to the program to the end
of its finalize_frame: the host-paced low-delay tail. Only a stream feed
yields frames one by one."""
import math

SPANS = {"entropy": ("encoder", "finalize_frame")}


def read(run):
    ends = {s.frame: s.t1 for s in run.spans("entropy")
            if s.frame is not None}
    lat = sorted(ends[k] - t for k, t in run.yielded.items() if k in ends)
    if not lat:
        return None
    return 1e3 * lat[math.ceil(0.9 * len(lat)) - 1]
