"""kbit_per_b_frame: the mean coded size of the cell's quality frames
that are B pictures (the first frames of the window, the same frames on
every run of a seed), each frame's access unit, headers and SEI
included. Apart from kbit_per_frame because a B picture's size follows
the content's motion and occlusions, which the seed arranges, and so
spreads more from seed to seed than an intra picture's."""


def read(run):
    sizes = [8 * len(run.coded[k]["chunk"]) / 1000.0
             for k in run.quality if k < len(run.coded)
             and run.coded[k]["info"]["slice_type"] == 0]
    return sum(sizes) / len(sizes) if sizes else None
