"""The whole train step: the model FLOPs of the window's steps
(:mod:`benchmark.counts`) over the window's time, as a share of the card's
dense float32 peak outside the tensor cores (the configuration computes in
float32 with TF32 off)."""

from benchmark import counts

LAYER = "train step"
UNIT = "%"
MOVES = "train_windows_per_s"


def read(record):
    steps = record.get("window_steps")
    if not steps:
        return None
    cell = record["cell"]
    conf = cell["config"]
    rows = cell["batch_size"] * conf["geometry"]["temporal"]
    pixels = conf["dataset"].endswith("_pixels")
    flops = counts.head_flops(rows, conf["feature_dim"], conf["hidden"],
                              input_grad=pixels and cell["finetune"])
    if pixels:
        flops += counts.i3d_flops(rows, frames=conf["stack"],
                                  size=conf["inputsize"],
                                  finetune=cell["finetune"])
    peak = counts.peaks(record["device_name"])["fp32"]
    return 100 * flops * steps / record["window_s"] / peak
