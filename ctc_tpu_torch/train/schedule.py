"""Learning-rate schedules (port of ``ctc_tpu/train/schedule.py``)."""

from __future__ import annotations


def step_decay_schedule(base_lr: float, decay_every_epochs: int,
                        steps_per_epoch: int):
    """``lr = base_lr * 0.1 ** (epoch // decay_every_epochs)`` as a function
    of the optimizer step count (the update count before this update): an
    int gives a float, a 0-d integer tensor (the optimizer's count on the
    device) a float32 tensor on its device."""

    def schedule(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        return base_lr * (0.1 ** (epoch // max(decay_every_epochs, 1)))

    return schedule
