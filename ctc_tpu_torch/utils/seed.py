"""Deterministic seeding (port of ``ctc_tpu/utils/seed.py``)."""

from __future__ import annotations

import random

import numpy as np
import torch


def seed_everything(seed: int) -> torch.Generator:
    """Seed python, numpy and torch; return a CPU ``torch.Generator`` made
    from ``seed`` for callers that draw their own random numbers."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
