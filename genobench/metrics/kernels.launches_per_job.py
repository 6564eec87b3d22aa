"""Kernel launches a job: the change of the sum of the port's launch
counters (``_kernels.LAUNCHES``) over the window, over the jobs it
completed."""


def read(run):
    if not run.completed:
        return None
    return sum(run.launches.values()) / run.completed
