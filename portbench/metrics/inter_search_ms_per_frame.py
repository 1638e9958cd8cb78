"""inter_search_ms_per_frame: a B frame's device work outside its
wavefront: the span around MdInterPipeline.submit_inter_b less its
_recon_md child, both synchronized at both ends, over the window's B
frames."""

SPANS = {"inter": ("pipeline", "submit_inter_b"),
         "wavefront": ("pipeline", "_recon_md")}


def read(run):
    waves = run.spans("wavefront")
    own = []
    for s in run.spans("inter"):
        child = sum(w.t1 - w.t0 for w in waves
                    if w.t0 >= s.t0 and w.t1 <= s.t1)
        own.append(s.t1 - s.t0 - child)
    return 1e3 * sum(own) / len(own) if own else None
