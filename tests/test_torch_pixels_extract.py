"""Pixels mode on the CPU, feature extraction: ``extract_split_features``
with a reference-layout checkpoint against ctc_tpu's and its cache, and
the command line extracting a Charades dataset's features when it has no
``--features-dir``, on one seeded Charades-format corpus of decodable
JPEG frames (``write_corpus(jpeg=True)``, built once for the file).

Tolerances: the features rtol 1e-3 / atol 2e-4 (``tests/test_i3d.py``'s:
the I3D's convolutions sum 2^17-deep in another order on each side,
measured to 6e-7 absolute in ``tests/test_torch_i3d.py``).
"""

import os

import numpy as np
import pytest
import torch

from ctc_tpu.data import features as jax_features
from ctc_tpu.models.i3d import convert_torch_state_dict
from ctc_tpu_torch.cli.main import main
from ctc_tpu_torch.data import charades, features
from ctc_tpu_torch.models.i3d import InceptionI3d

from torch_pixels_oracle import GEOMETRY, make_corpus, paths


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("jpeg_corpus"))


def test_extraction_matches_jax_and_reads_its_cache(corpus, tmp_path):
    """extract_split_features over the corpus's train windows with the
    reference-layout checkpoint equals ctc_tpu's; a second call returns
    the cached file, memory-mapped."""
    out, weights, _ = corpus
    labels = charades.parse_charades_csv(out["train_file"])
    counts = {v: charades.count_frames(out["rgb_data"], v) for v in labels}
    data, _ = charades.prepare_windows(labels, counts, "train", 4, 2, 2,
                                       rgb_root=out["rgb_data"])
    assert len(data["ids"]) >= 2
    model = InceptionI3d()
    model.load_state_dict(torch.load(weights))
    assert model.logits is not None
    got = features.extract_split_features(
        data, features.I3DFeatureExtractor(model, device="cpu"),
        str(tmp_path / "port"), gap=2, batch_size=2)
    jvars = convert_torch_state_dict(torch.load(weights))
    want = jax_features.extract_split_features(
        data, jax_features.I3DFeatureExtractor(jvars),
        str(tmp_path / "jax"), gap=2, batch_size=2)
    assert got.shape == (len(data["ids"]), 4, 1024)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-4)
    again = features.extract_split_features(data, None,
                                            str(tmp_path / "port"), gap=2)
    assert isinstance(again, np.memmap)
    np.testing.assert_array_equal(again, got)



def test_cli_extracts_features_without_features_dir(corpus, tmp_path,
                                                    capsys):
    """A Charades dataset without --features-dir extracts its features
    with the frozen I3D (the --rgb-pretrained-weights checkpoint), caches
    them, trains the head on them, and reads the cache on the next run;
    without weights it warns, as ctc_tpu does."""
    _, weights, _ = corpus
    argv = (["--dataset", "charades_ctc_next_pred", "--batch-size", "2",
             "--device", "cpu", "--epochs", "1",
             "--cache-dir", str(tmp_path)] + GEOMETRY + paths(corpus))
    history = main(argv + ["--rgb-pretrained-weights", weights])
    assert np.isfinite(history[0]["train"]["loss"])
    cached = tmp_path / "test" / "features_train" / "features.npy"
    assert np.load(cached).shape[1:] == (4, 1024)
    stamp = os.stat(cached).st_mtime_ns
    printed = capsys.readouterr().out
    assert "JPEG decoder: pil (feature extraction)" in printed
    assert "WARNING: --rgb-pretrained-weights not set" not in printed
    main(argv + ["--rgb-pretrained-weights", weights])
    assert os.stat(cached).st_mtime_ns == stamp
    main(argv + ["--cache-dir", str(tmp_path / "random")])
    assert "WARNING: --rgb-pretrained-weights not set" in (
        capsys.readouterr().out)

