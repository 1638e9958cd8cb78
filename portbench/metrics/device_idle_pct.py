"""device_idle_pct: the share of the profiled stretch (a fixed number of
wave steps, or of frames, after the window) in which no operation ran on
the device: 100 x (1 - busy_s / window_s)."""


def read(run):
    st = run.stretch
    if st is None or st.window_s <= 0 or st.busy_s <= 0:
        return None
    return 100.0 * (1.0 - st.busy_s / st.window_s)
