"""Data layer: seconds covered by the program's ``ctc/data/*`` spans of
the set-up and of step 0 (nested and overlapping spans once): the dataset
(CSV, frame count, windows), the JPEG decoder's build and load, and the
decodes of the batches a resident feed holds or a prefetching loader
starts in step 0."""

from benchmark import program_spans

LAYER = "data"
UNIT = "s"
MOVES = "setup_s"


def read(record):
    return program_spans.setup_seconds(("ctc/data/",))
