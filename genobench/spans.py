"""The program's own spans in a traced run, and the device's idle time
charged to them.

The port records its spans while a profile records
(``miraculix_tpu_torch.utils.logging.spans()``: name, start and end in ns
on the profiler's clock, the index of the parent span).  Here they are
clipped to the traced window, and each idle stretch of the window (between
the union of the device operations' intervals) is charged piece by piece
to the innermost program span open on the host while it lasts, the rule
of ``trace.DeviceTrace.idle_gaps``.  Where the run is untraced or the
program records no spans, every function here returns None.
"""
from __future__ import annotations


def program_spans(run):
    """{index: (name, start, end, parent)} of the program's spans that
    overlap the traced window, clipped to it (a span overlaps it wherever
    a child does), or None."""
    if run.trace is None:
        return None
    if not hasattr(run, "_program_spans"):
        try:
            from miraculix_tpu_torch.utils import logging as plog
        except ImportError:
            plog = None
        recorded = getattr(plog, "spans", None)
        a, b = run.trace.window()
        run._program_spans = None if recorded is None else {
            i: (rec[0], max(rec[1], a), min(rec[2], b), rec[3])
            for i, rec in enumerate(recorded())
            if rec[2] is not None and rec[2] > a and rec[1] < b}
    return run._program_spans


def idle_charged(run):
    """({span index: idle ns charged to it as the innermost open span},
    idle ns outside every program span) over the window, or None."""
    spans = program_spans(run)
    if spans is None:
        return None
    if not hasattr(run, "_idle_charged"):
        a, b = run.trace.window()
        gaps, end = [], a
        for s, e in sorted((s, e) for _, s, e in run.trace.in_window()):
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        if b > end:
            gaps.append((end, b))
        # boundaries in time order, an end before a start at one time, a
        # parent's start before its child's; spans of no length hold nothing
        marks = sorted([(s, 1, i) for i, (_, s, e, _) in spans.items()
                        if e > s]
                       + [(e, 0, i) for i, (_, s, e, _) in spans.items()
                          if e > s])
        marks.append((b, 0, None))
        charged, stack, t, g = {}, [], a, 0
        for when, opens, i in marks:
            if when > t:
                owner = stack[-1] if stack else None
                while g < len(gaps) and gaps[g][1] <= t:
                    g += 1
                h = g
                while h < len(gaps) and gaps[h][0] < when:
                    part = min(when, gaps[h][1]) - max(t, gaps[h][0])
                    charged[owner] = charged.get(owner, 0) + part
                    h += 1
                t = when
            if opens:
                stack.append(i)
            elif i in stack:
                stack.remove(i)
        outside = charged.pop(None, 0)
        run._idle_charged = (charged, outside)
    return run._idle_charged


def idle_inside(run, names, excluding=()):
    """(idle ns inside the spans named in ``names`` and inside none of
    their descendants named in ``excluding``, the number of spans named in
    ``names``), or None where no such span lies in the window."""
    spans = program_spans(run)
    if not spans:
        return None
    count = sum(1 for rec in spans.values() if rec[0] in names)
    if not count:
        return None
    charged, _ = idle_charged(run)
    total = 0
    for i, ns in charged.items():
        while i is not None and i in spans:
            name = spans[i][0]
            if name in names:
                total += ns
                break
            if name in excluding:
                break
            i = spans[i][3]
    return total, count
