"""The device's idle time in the linear GWAS entry outside its packed
passes, in ms a job: the window's idle stretches charged to the program's
``gwas_linear`` spans and the spans inside them, but not to a
``gwas.t_pass`` or ``gwas.row_sq_stats`` span or anything inside one (the
design, the denominators' einsum, the epilogue and its p-values), over the
number of ``gwas_linear`` spans."""
from genobench import spans


def read(run):
    got = spans.idle_inside(run, {"gwas_linear"},
                            excluding={"gwas.t_pass", "gwas.row_sq_stats"})
    return None if got is None else got[0] / got[1] / 1e6
