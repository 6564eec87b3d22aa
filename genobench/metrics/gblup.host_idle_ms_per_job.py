"""The device's idle time in the GBLUP entry outside its CG solves, in ms
a job: the window's idle stretches charged to the program's ``gblup``
spans and the spans inside them, but not to a ``cg`` span or anything
inside one (the design matrix, the copies back, the host solve for beta,
the g_hat matvec), over the number of ``gblup`` spans."""
from genobench import spans


def read(run):
    got = spans.idle_inside(run, {"gblup"}, excluding={"cg"})
    return None if got is None else got[0] / got[1] / 1e6
