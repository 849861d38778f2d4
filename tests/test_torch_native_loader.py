"""ctc_tpu_torch's JPEG frame pipeline on the CPU: ``data/frames.py`` equals
ctc_tpu's copy; the native decoder builds ``native/dataloader.cpp`` into
``build/ctc_tpu_torch/`` (and writes nothing into ``native/``) and matches
the PIL path within ``tests/test_native_loader.py``'s bounds (mean |dev|
< 2/255, 99th percentile < 8/255: PIL's filter weights are fixed point);
the threaded PIL path gives the sequential PIL numbers exactly."""

import os

import numpy as np
import pytest
from PIL import Image

from ctc_tpu.data import frames as jax_frames
from ctc_tpu_torch.data import frames, native_loader
from ctc_tpu_torch.data.charades_corpus import JPEG_SIZE, write_corpus


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    d = tmp_path_factory.mktemp("jpegs")
    rng = np.random.default_rng(0)
    paths = []
    for i, (w, h) in enumerate([(320, 240), (240, 320), (640, 480),
                                (100, 80), JPEG_SIZE]):
        img = rng.integers(0, 255, (h, w, 3), np.uint8)
        img = (img.astype(np.float32) * 0.3 + 128 * 0.7).astype(np.uint8)
        p = d / f"frame{i}.jpg"
        Image.fromarray(img).save(p, quality=95)
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("inputsize", [224, 112])
def test_load_frame_equals_jax(jpegs, inputsize):
    for p in jpegs:
        np.testing.assert_array_equal(frames.load_frame(p, inputsize),
                                      jax_frames.load_frame(p, inputsize))


def test_window_paths_and_load_window_equal_jax(tmp_path):
    out = write_corpus(str(tmp_path), seed=0, train_videos=1, val_videos=1,
                       feat_dim=4, jpeg=True)
    vid = sorted(os.listdir(out["rgb_data"]))[0]
    first = os.path.join(out["rgb_data"], vid, f"{vid}-000005.jpg")
    assert (frames.window_frame_paths(first, 2)
            == jax_frames.window_frame_paths(first, 2))
    anchors = [first, first.replace("000005", "000011")]
    got = frames.load_window(anchors, 2)
    assert got.shape == (2, 10, 224, 224, 3)
    np.testing.assert_array_equal(got, jax_frames.load_window(anchors, 2))
    # the threaded PIL decode gives the same numbers
    np.testing.assert_array_equal(
        native_loader.load_window_native(anchors, 2, decoder="pil"), got)


def test_native_builds_into_the_port_build_dir():
    before = sorted(os.listdir(native_loader.SOURCE.parent))
    assert native_loader.decoder() == "native", native_loader.build_error
    lib = native_loader.library_path()
    assert lib.parent == native_loader.BUILD_DIR and lib.exists()
    assert lib.parent.parts[-2:] == ("build", "ctc_tpu_torch")
    assert sorted(os.listdir(native_loader.SOURCE.parent)) == before


def test_native_matches_pil(jpegs):
    assert native_loader.decoder() == "native"
    got = native_loader.decode_frames(jpegs, inputsize=224)
    want = native_loader.decode_frames(jpegs, inputsize=224, decoder="pil")
    np.testing.assert_array_equal(
        want, np.stack([jax_frames.load_frame(p, 224) for p in jpegs]))
    assert got.shape == want.shape == (5, 224, 224, 3)
    diff = np.abs(got - want)
    assert float(diff.mean()) < 2.0 / 255.0, float(diff.mean())
    assert float(np.quantile(diff, 0.99)) < 8.0 / 255.0


@pytest.mark.parametrize("decoder", [None, "pil"], ids=["native", "pil"])
def test_missing_frame_raises(tmp_path, decoder):
    with pytest.raises(OSError):
        native_loader.decode_frames([str(tmp_path / "missing.jpg")],
                                    decoder=decoder)


def test_pil_is_used_where_native_cannot_build(monkeypatch, jpegs):
    """Without a working native build (as on a machine with no libjpeg),
    decoder() says pil and decoding goes on through PIL."""
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "build_error", "RuntimeError: test")
    assert native_loader.decoder() == "pil"
    got = native_loader.decode_frames(jpegs[:2])
    np.testing.assert_array_equal(
        got, np.stack([frames.load_frame(p) for p in jpegs[:2]]))
