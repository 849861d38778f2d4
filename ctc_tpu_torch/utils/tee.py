"""Stdout/stderr tee into an experiment logfile (copy of
``ctc_tpu/utils/tee.py``): everything printed also lands, timestamped, in
``<cache>/log.txt`` so experiment history survives the terminal.
"""

from __future__ import annotations

import logging
import sys


class _StreamToLogger:
    def __init__(self, stream, logger, level):
        self.stream = stream
        self.logger = logger
        self.level = level

    def write(self, buf):
        self.stream.write(buf)
        for line in buf.rstrip().splitlines():
            self.logger.log(self.level, line.rstrip())

    def flush(self):
        self.stream.flush()

    def isatty(self):
        return getattr(self.stream, "isatty", lambda: False)()


class Tee:
    """``Tee(filename)`` redirects stdout/stderr through a file logger."""

    def __init__(self, filename: str):
        self.filename = filename
        handler = logging.FileHandler(filename, mode="a")
        handler.setFormatter(logging.Formatter("%(asctime)s:%(message)s"))
        for name, stream_attr, level in (
            ("STDOUT", "stdout", logging.INFO),
            ("STDERR", "stderr", logging.ERROR),
        ):
            logger = logging.getLogger(f"ctc_tpu_torch.tee.{name}")
            logger.setLevel(logging.DEBUG)
            logger.addHandler(handler)
            logger.propagate = False
            setattr(
                sys,
                stream_attr,
                _StreamToLogger(getattr(sys, stream_attr), logger, level),
            )
        print(f"Logging to file {filename}")
