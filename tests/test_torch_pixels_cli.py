"""Pixels mode on the CPU, the command line: ``--dataset charades_pixels``
against ctc_tpu's ``cli.main``, and its flags (``--finetune-i3d``,
``--i3d-chunk``, bf16) training, checkpointing and resuming, on one seeded
Charades-format corpus of decodable JPEG frames
(``write_corpus(jpeg=True)``, built once for the file).

Tolerances: the full-width runs (224 x 224, stack 10, 1024-d) hold the
losses to rtol 1e-4: the I3D's convolutions sum 2^17-deep in another order
on each side (features measured to 6e-7 absolute,
``tests/test_torch_i3d.py``).  Top-1 and top-5 exactly.
"""

import numpy as np
import pytest
import torch

from ctc_tpu.cli.main import main as jax_main
from ctc_tpu.train import Trainer as JaxTrainer
from ctc_tpu_torch.cli.main import main
from ctc_tpu_torch.data import native_loader
from ctc_tpu_torch.models import I3DLSTM
from ctc_tpu_torch.train import Trainer

from torch_pixels_oracle import (
    FULL_LOSS_RTOL, GEOMETRY, LR, jax_state, make_corpus, paths, score_rows,
)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("jpeg_corpus"))


def test_cli_pixels_matches_jax(corpus, tmp_path, monkeypatch, capsys):
    """``--dataset charades_pixels --device cpu`` for one epoch at 224 x
    224, stack 10, 1024-d (B=2, T=4, frozen backbone from
    ``--rgb-pretrained-weights``) writes ctc_tpu's score.csv: losses to
    rtol 1e-4, top-1 and top-5 exactly."""
    _, weights, model = corpus
    weights = weights.replace(".pt", "_backbone.pt")
    port_init = Trainer.init_state
    monkeypatch.setattr(JaxTrainer, "init_state",
                        lambda self, batch: jax_state(self, model))
    monkeypatch.setattr(Trainer, "init_state",
                        lambda self, sd=None: port_init(self,
                                                        model.state_dict()))
    argv = (["--dataset", "charades_pixels", "--batch-size", "2",
             "--epochs", "1", "--dropout", "0", "--lr", str(LR),
             "--rgb-pretrained-weights", weights] + GEOMETRY
            + paths(corpus))
    jax_main(argv + ["--lattice-impl", "xla",
                     "--cache-dir", str(tmp_path / "jax")])
    history = main(argv + ["--device", "cpu",
                           "--cache-dir", str(tmp_path / "torch")])
    printed = capsys.readouterr().out
    assert f"JPEG decoder: {native_loader.decoder()}" in printed
    assert "loaded pretrained I3D backbone" in printed
    assert len(history) == 1
    want = score_rows(tmp_path / "jax" / "test")
    got = score_rows(tmp_path / "torch" / "test")
    np.testing.assert_allclose([r[1:3] for r in got],
                               [r[1:3] for r in want], rtol=FULL_LOSS_RTOL)
    assert [r[3:] for r in got] == [r[3:] for r in want]


@pytest.mark.parametrize("flags", [
    ["--finetune-i3d"],
    ["--i3d-chunk", "4"],
    ["--compute-dtype", "bf16", "--i3d-act-dtype", "bf16"],
], ids=["finetune", "chunk", "bf16"])
def test_cli_pixels_flags_train(corpus, tmp_path, flags):
    """The pixels flags train at full width on the CPU: finite losses; the
    backbone moves only under --finetune-i3d (against the seed's initial
    weights); the checkpoint holds it, with the SGD momentum where it
    trains, and a run resumes from it; a resume that flips
    --finetune-i3d (the frozen bf16 run's checkpoint resumed finetuned,
    the finetuned one's resumed frozen) raises."""
    argv = (["--dataset", "charades_pixels", "--batch-size", "2",
             "--dropout", "0", "--device", "cpu", "--lr", str(LR),
             "--cache-dir", str(tmp_path)] + GEOMETRY + paths(corpus)
            + flags)
    history = main(argv + ["--epochs", "1"])
    assert np.isfinite(history[0]["train"]["loss"])
    ckpt = torch.load(tmp_path / "test" / "ckpt" / "0.pt",
                      weights_only=True)
    init = I3DLSTM(hidden=33)
    init.reset_parameters(torch.Generator().manual_seed(0))
    key = "i3d.Conv3d_1a_7x7.conv3d.weight"
    moved = not torch.equal(ckpt["model"][key], init.state_dict()[key])
    assert moved == (flags[0] == "--finetune-i3d")
    assert ("momentum" in ckpt["optimizer"]) == moved
    resume = ["--epochs", "2", "--resume", str(tmp_path / "test")]
    resumed = main(argv + resume)
    assert len(resumed) == 1 and np.isfinite(resumed[0]["train"]["loss"])
    if "--i3d-chunk" in flags:  # frozen only: flipping is a parse error
        return
    flipped = ([a for a in argv if a != "--finetune-i3d"] if moved
               else argv + ["--finetune-i3d"])
    with pytest.raises(ValueError, match="optimizer state does not match"):
        main(flipped + resume)


