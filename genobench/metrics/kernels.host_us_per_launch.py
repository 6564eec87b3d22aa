"""The host's time a kernel launch, in us: the mean length of the
program's launcher spans (one a call of a ``_kernels`` launcher, named by
its entry of ``_kernels.LAUNCHES``) in the window."""
from genobench import spans


def read(run):
    got = spans.program_spans(run)
    if not got:
        return None
    from miraculix_tpu_torch import _kernels

    lengths = [e - s for name, s, e, _ in got.values()
               if name in _kernels.LAUNCHES]
    return sum(lengths) / len(lengths) / 1e3 if lengths else None
