"""Run one cell of the benchmark once on this machine's CUDA card(s).

    python3 genobench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Prints one JSON line (the last line of standard output) and, before it on
standard error, each compared number beside its limit.  Exits 2 without a
result where the machine lacks the cards the cell asks for.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from genobench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main())
