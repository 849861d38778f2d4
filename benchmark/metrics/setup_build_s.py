"""Ops: seconds in the program's ``ctc/ops/build/*`` spans of the set-up
and of step 0, where each kernel library loads at its first call: the
``nvcc`` builds, or cached loads, of the lattice libraries."""

from benchmark import program_spans

LAYER = "ops"
UNIT = "s"
MOVES = "setup_s"


def read(record):
    return program_spans.setup_seconds(("ctc/ops/build/",))
