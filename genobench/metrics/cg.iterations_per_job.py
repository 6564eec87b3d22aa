"""CG iterations a job, as the entry reports them (``GBLUPResult.
cg_iterations``, ``CGResult.iterations``), averaged over the window's
completed jobs; nothing where the jobs report none."""


def read(run):
    its = [j["cg_iterations"] for j in run.jobs
           if j["ok"] and "cg_iterations" in j]
    return sum(its) / len(its) if its else None
