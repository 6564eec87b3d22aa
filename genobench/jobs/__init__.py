"""Job kinds: the code behind a traffic mix's ``"job"`` key.

A traffic file ``traffic/<mix>.json`` names its kind, and the harness
imports ``jobs/<kind>.py`` by that name.  Each kind defines ``Job(spec,
traffic, seed, config, device)``, whose construction is the set-up (the
panel and the inputs drawn from the seed):

- ``spec``: the configuration's genotype panel (``genotypes.Spec``), or
  None where the configuration has no ``snps``;
- ``traffic``: the mix's file, as a dict;
- ``seed``: the run's ``--seed``;
- ``config``: the configuration's file, as a dict, with every block a
  deployment holds beside its panel (a pedigree, a sparse system); a kind
  that needs only the panel ignores it;
- ``device``: the torch device the run drives (``spec.device`` where there
  is a panel).

A job that holds its panel as a ``GenoMatrix`` in ``g`` gives the roofline
readers their packings' dimensions.  On the job:

- ``prepare(i)``: draw job i's inputs (in the window, not timed);
- ``run(i)``: job i through the port's entry, synchronized (timed);
- ``record(i, result)``: ``{"ok": bool, ...counters}``, keeping what the
  check compares;
- ``release()``: drop the program's state, panel included;
- ``check()`` and ``control(jobs)``: the compared numbers as
  ``(name, value, limit)``, of the kept answers or of the reference in
  bfloat16 put in the program's place on jobs 0..jobs-1, each against the
  float64 reference.
"""


def sync(device) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)
