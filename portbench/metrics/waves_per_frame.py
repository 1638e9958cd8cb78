"""waves_per_frame: the program's counter info["n_waves"], the waves of a
picture's wavefront, averaged over the window's frames."""


def read(run):
    w = [run.coded[k]["info"]["n_waves"] for k in run.window_frames]
    w = [int(x) for x in w if x is not None]
    return sum(w) / len(w) if w else None
