"""The device's idle time inside a CG iteration, in ms: the window's idle
stretches charged to the program's ``cg.iteration`` spans and the spans
inside them (the two products, their launches, the stop test's read-back),
over the number of those spans."""
from genobench import spans


def read(run):
    got = spans.idle_inside(run, {"cg.iteration"})
    return None if got is None else got[0] / got[1] / 1e6
