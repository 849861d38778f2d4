"""Infrastructure utilities: stdout tee, seeding."""

from ctc_tpu_torch.utils.seed import seed_everything
from ctc_tpu_torch.utils.tee import Tee

__all__ = ["Tee", "seed_everything"]
