"""Preset experiment launcher (port of ``ctc_tpu/cli/exe.py``).

The reference's documented workflow runs a script that injects a fixed argv
(temporal=10, gap=2, num_trans=2, paths) into ``main()``.  Here the same
preset is data, and flags given after it override it (argparse keeps the
last value), so a run on cached features passes its own paths and
``--features-dir``.  Runs on ``--device cuda`` unless told otherwise.

Run: ``python -m ctc_tpu_torch.cli.exe [extra flags override the preset]``
"""

from __future__ import annotations

import sys

from ctc_tpu_torch.cli.main import main

# the reference experiment preset
PRESET = [
    "--temporal", "10",
    "--gap", "2",
    "--num-trans", "2",
    "--name", "Triplet_Single_CTC_predict",
    "--cache-dir", "./cr_caches/",
    "--rgb-data", "./charades/Charades_v1_rgb/",
    "--rgb-my-data", "./charades/Mydata_rgb",
    "--rgb-pretrained-weights", "./charades/rgb_i3d_pretrained.pt",
    "--resume", "./cr_caches/Triplet_Single_CTC_predict",
    "--train-file", "./charades/Charades/Charades_v1_train.csv",
    "--val-file", "./charades/Charades/Charades_v1_test.csv",
]


def run(extra=None):
    argv = PRESET + list(extra if extra is not None else sys.argv[1:])
    return main(argv)


if __name__ == "__main__":
    run()
