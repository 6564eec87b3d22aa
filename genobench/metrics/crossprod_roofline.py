"""The integer GRM crossproduct's share of its roofline over the window:
the summed bounds of its launches (their triangle's operations against the
int8 peak, or their bytes against HBM) over the summed device time of its
kernel (``crossprod_kernel``), in %."""
from genobench import roofline


def read(run):
    if run.trace is None:
        return None
    p = run.peaks
    bounds = []
    for name, zq, _ in run.launch_log:
        if name == "crossprod":
            ops, nbytes = roofline.crossprod_work(*run.real_dims(zq))
            bounds.append(roofline.bound_s(ops, nbytes, p["int8"], p["hbm"]))
    return roofline.share(bounds, run.trace.family_seconds("crossprod"),
                          "crossprod")
