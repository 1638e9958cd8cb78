"""kbit_per_frame: the mean coded size of the cell's quality frames (the
first frames of the window, the same frames on every run of a seed),
each frame's access unit, headers and SEI included."""


def read(run):
    sizes = [8 * len(run.coded[k]["chunk"]) / 1000.0
             for k in run.quality if k < len(run.coded)]
    return sum(sizes) / len(sizes) if sizes else None
