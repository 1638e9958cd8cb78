"""fps: every frame coded in the window over all of the window's time,
which ends with the last whole unit."""


def read(run):
    if not run.window_frames or run.window_s <= 0:
        return None
    return len(run.window_frames) / run.window_s
