"""The tall kernel's share of its roofline over the window: the summed
bounds of its launches (2 contract x out x cols operations against the
bf16 peak, or the packed words, B and the output against HBM) over the
summed device time of its kernels (pre-pass, mma, split reduction), in %."""
from genobench import roofline


def read(run):
    if run.trace is None:
        return None
    p = run.peaks
    bounds = []
    for name, zq, b in run.launch_log:
        if name == "tall_dgemm":
            _, out = run.real_dims(zq)
            ops, nbytes = roofline.tall_work(b[0], out, b[1])
            bounds.append(roofline.bound_s(ops, nbytes, p["bf16"], p["hbm"]))
    return roofline.share(bounds, run.trace.family_seconds("tall_dgemm"),
                          "tall_dgemm")
