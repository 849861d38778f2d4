"""Models: seconds covered by the program's ``ctc/models/build`` and
``ctc/train/init`` spans of the set-up (the ``Trainer``, which creates the
CUDA context, and ``init_state``: the weights' draw on the CPU and their
move to the card)."""

from benchmark import program_spans

LAYER = "models"
UNIT = "s"
MOVES = "setup_s"


def read(record):
    return program_spans.setup_seconds(("ctc/models/build",
                                        "ctc/train/init"))
