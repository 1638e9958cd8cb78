"""entropy_ms_per_frame: the API and entropy-coding layer's time a frame,
the span around Encoder.finalize_frame (materializing the decisions,
the native or Python slice writer, the headers and SEI), synchronized at
both ends, over the window's frames."""

SPANS = {"entropy": ("encoder", "finalize_frame")}


def read(run):
    d = [s.t1 - s.t0 for s in run.spans("entropy")]
    return 1e3 * sum(d) / len(d) if d else None
