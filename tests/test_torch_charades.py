"""ctc_tpu_torch's Charades data layer against ctc_tpu's, on the same seeded
Charades-format CSV and frame directories: the class tables, CSV parsing,
the window functions (every split and variant, the 32-bit fingerprint wrap
included), per-process index batches, every collate, the prepare cache and
the groundtruth pickle, each read across the two packages.  Outputs are
held equal, dtypes and Python types included."""

import numpy as np
import pytest

from ctc_tpu.data import charades as jax_charades
from ctc_tpu.data import charades_classes as jax_classes
from ctc_tpu.data import charades_variants as jax_variants
from ctc_tpu.data import loading as jax_loading
from ctc_tpu.data.loaders import charades as jax_v1
from ctc_tpu.data.loaders import charades_ver2 as jax_ver2
from ctc_tpu.data.loaders import charades_ver2_c_class as jax_c_class
from ctc_tpu.data.loaders import charades_ver3 as jax_ver3
from ctc_tpu.utils import groundtruth as jax_groundtruth
from ctc_tpu_torch.data import charades, charades_classes, charades_variants
from ctc_tpu_torch.data import loading
from ctc_tpu_torch.data.loaders import (
    _common,
    charades_ver2,
    charades_ver2_c_class,
    charades_ver3,
)
from ctc_tpu_torch.data.loaders import charades as v1
from ctc_tpu_torch.utils import groundtruth

#: (temporal, gap, num_trans): a short geometry and the reference preset's
GEOMETRIES = [(4, 1, 1), (10, 2, 2)]
GEO_IDS = ["T4", "preset"]
#: action classes whose object id is >= 31 (2**o wraps at 32 bits)
HIGH_OBJECT_CLASSES = [c for c, (o, _) in enumerate(jax_classes.CLASS_TO_OV)
                       if o >= 31]


def assert_same(got, want, where="out"):
    """Equal values of the same types: dicts, lists and tuples element by
    element, numpy arrays by dtype, shape and value."""
    assert type(got) is type(want), (where, type(got), type(want))
    if isinstance(want, dict):
        assert list(got) == list(want), where
        for k in want:
            assert_same(got[k], want[k], f"{where}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, where
        assert np.array_equal(got, want), where
    else:
        assert got == want, where


def _write(tmp_path, rows, frame_counts):
    csv_path = tmp_path / "charades.csv"
    with open(csv_path, "w") as f:
        f.write("id,subject,scene,quality,relevance,verified,script,objects,"
                "descriptions,actions,length\n")
        for vid, scene, actions in rows:
            f.write(f'{vid},S1,"{scene}",5,5,1,s,o,d,"{actions}",10\n')
    rgb_root = tmp_path / "rgb"
    for vid, n in list(frame_counts.items()) + [("YUME0", 600)]:
        # the own-video loaders' label dict names YUME0
        d = rgb_root / vid
        d.mkdir(parents=True)
        for j in range(n):
            open(d / f"{vid}-{j + 1:06d}.jpg", "wb").close()
    return str(csv_path), str(rgb_root)


def _corpus(tmp_path, seed, n_videos, classes, max_start):
    """Seeded CSV + frame dirs; video 1 has one label, one has none."""
    rng = np.random.default_rng(seed)
    scenes = list(jax_classes.SCENE_TO_INT)
    rows, frame_counts = [], {}
    for i in range(n_videos):
        vid = f"VID{i:02d}"
        frame_counts[vid] = int(rng.integers(60, 1500))
        n_labels = {1: 1, 2: 0}.get(i, int(rng.integers(2, 8)))
        acts = []
        for _ in range(n_labels):
            c = int(classes[int(rng.integers(0, len(classes)))])
            start = round(float(rng.uniform(0, max_start)), 2)
            acts.append(f"c{c:03d} {start:.2f} "
                        f"{start + float(rng.uniform(0.5, 12)):.2f}")
        rows.append((vid, scenes[int(rng.integers(0, len(scenes)))],
                     ";".join(acts)))
    csv_path, rgb = _write(tmp_path, rows, frame_counts)
    labels = jax_charades.parse_charades_csv(csv_path)
    counts = {vid: jax_charades.count_frames(rgb, vid) for vid in labels}
    return {"csv": csv_path, "rgb": rgb, "labels": labels, "counts": counts}


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    return _corpus(tmp_path_factory.mktemp("charades"), 11, 32,
                   list(range(157)), 30)


@pytest.fixture(scope="module")
def ds_wrap(tmp_path_factory):
    """Every action's object id >= 31, dense in time: multi-hot rows whose
    sum-of-2^o fingerprints exceed 32 bits."""
    return _corpus(tmp_path_factory.mktemp("charades_wrap"), 5, 24,
                   HIGH_OBJECT_CLASSES, 15)


@pytest.mark.parametrize("name", [
    "O_CLASSES", "V_CLASSES", "S_CLASSES", "C_CLASSES", "CLASS_TO_OV",
    "OBJECT_NAMES", "VERB_NAMES", "SCENE_NAMES", "SCENE_TO_INT",
])
def test_class_tables_match(name):
    assert_same(getattr(charades_classes, name), getattr(jax_classes, name))


def test_constants_and_parse_match(ds):
    for name in ("FPS", "STACK", "TEST_GAP"):
        assert getattr(charades, name) == getattr(jax_charades, name)
    assert charades_variants.MY_FPS == jax_variants.MY_FPS
    assert_same(charades_variants.MYVIDEO_LABELS, jax_variants.MYVIDEO_LABELS)
    labels = charades.parse_charades_csv(ds["csv"])
    assert_same(labels, jax_charades.parse_charades_csv(ds["csv"]))
    assert len(labels) == 32 and labels["VID02"] == []
    for vid in labels:
        assert (charades.count_frames(ds["rgb"], vid)
                == jax_charades.count_frames(ds["rgb"], vid) > 0)
    for c in range(157):
        assert charades.cls2int(f"c{c:03d}") == jax_charades.cls2int(
            f"c{c:03d}")


@pytest.mark.parametrize("hot", [[0], [30], [31], [32], [33], [37], [1, 32],
                                 [31, 32, 33], list(range(38))],
                         ids=lambda h: "-".join(map(str, h)))
def test_fingerprint_wraps_at_32_bits(hot):
    row = np.zeros(38, np.int32)
    row[hot] = 1
    fp = charades._fingerprint(row)
    assert fp == jax_charades._fingerprint(row)
    assert fp == sum(1 << o for o in hot) % (1 << 32)
    # row 1 equal to row 0, row 2 = `row`, row 3 = `row` again
    target = np.zeros((5, 38), np.int32)
    target[0, 3] = target[1, 3] = 1
    target[2] = target[3] = row
    kept = charades._dedup_rows(target, 5)
    assert_same(kept, jax_charades._dedup_rows(target, 5))
    # a row whose fingerprint wraps to 0 (bit 32 alone) reads as empty
    assert len(kept) == (1 if fp in (0, 8) else 2)


@pytest.mark.parametrize("geo", GEOMETRIES, ids=GEO_IDS)
@pytest.mark.parametrize("split", ["train", "val", "val_video"])
def test_prepare_windows_matches(ds, split, geo):
    temporal, gap, num_trans = geo
    args = (ds["labels"], ds["counts"], split, temporal, gap, num_trans,
            ds["rgb"])
    got = charades.prepare_windows(*args)
    assert_same(got, jax_charades.prepare_windows(*args))
    assert len(got[0]["ids"]) > 0
    if split == "val_video":
        assert len(got[1]) > 0


@pytest.mark.parametrize("split", ["train", "val_video"])
def test_prepare_windows_fingerprint_wrap(ds_wrap, split, monkeypatch):
    """On the high-object corpus the 32-bit wrap changes which object rows
    survive the dedup; the port keeps the wrap, as ctc_tpu does."""
    args = (ds_wrap["labels"], ds_wrap["counts"], split, 4, 1, 1,
            ds_wrap["rgb"])
    got = charades.prepare_windows(*args)
    assert_same(got, jax_charades.prepare_windows(*args))
    monkeypatch.setattr(charades, "_fingerprint",
                        lambda row: sum(int(v) << i for i, v in
                                        enumerate(row)))
    unwrapped = charades.prepare_windows(*args)
    assert got[0]["o_times"] != unwrapped[0]["o_times"]


#: name -> (call on a variants module, needs a split, own-video labels)
VARIANTS = {
    "v1": lambda m, d, s, g: m.prepare_v1(d["labels"], d["counts"], g[0],
                                          g[1], rgb_root=d["rgb"]),
    "ver2": lambda m, d, s, g: m.prepare_ver2(d["labels"], d["counts"], *g,
                                              rgb_root=d["rgb"]),
    "ver2_groundtruth": lambda m, d, s, g: m.prepare_ver2_groundtruth(
        d["labels"], *g),
    "ver2_future_groundtruth": lambda m, d, s, g:
        m.prepare_ver2_future_groundtruth(d["labels"], g[0], g[1]),
    "ver3": lambda m, d, s, g: m.prepare_ver3(d["labels"], d["counts"], s,
                                              *g, rgb_root=d["rgb"]),
    "c_class": lambda m, d, s, g: m.prepare_c_class(
        d["labels"], d["counts"], s, g[0], g[1], rgb_root=d["rgb"]),
    "my_pred": lambda m, d, s, g: m.prepare_my_pred(
        d["labels"], d["counts"], g[0], g[1], rgb_root=d["rgb"]),
    "myvideo": lambda m, d, s, g: m.prepare_myvideo(
        d["labels"], d["counts"], g[0], g[1], rgb_root=d["rgb"]),
    "myvideo_ver3": lambda m, d, s, g: m.prepare_myvideo_ver3(
        d["labels"], d["counts"], g[0], g[1], rgb_root=d["rgb"]),
    "myvideo_c_class": lambda m, d, s, g: m.prepare_myvideo_c_class(
        d["labels"], d["counts"], g[0], g[1], rgb_root=d["rgb"]),
}
SPLIT_VARIANTS = ("ver3", "c_class")
VARIANT_CASES = [
    (name, split, labels, geo_id)
    for name in VARIANTS
    for split in (("train", "val") if name in SPLIT_VARIANTS else (None,))
    for labels in (("charades", "myvideo") if name.startswith("my")
                   else ("charades",))
    for geo_id in GEO_IDS
    # prepare_my_pred's window outgrows its path (an IndexError in both
    # packages) below the preset's temporal on these labels
    if name != "my_pred" or (labels, geo_id) == ("myvideo", "preset")
]


@pytest.mark.parametrize("name,split,labels,geo_id", VARIANT_CASES,
                         ids=["-".join(filter(None, c)) for c in
                              VARIANT_CASES])
def test_prepare_variants_match(ds, name, split, labels, geo_id):
    geo = GEOMETRIES[GEO_IDS.index(geo_id)]
    d = ds
    if labels == "myvideo":
        d = {"labels": jax_variants.MYVIDEO_LABELS,
             "counts": {"YUME0": 600}, "rgb": ds["rgb"]}
    got = VARIANTS[name](charades_variants, d, split, geo)
    assert_same(got, VARIANTS[name](jax_variants, d, split, geo))


@pytest.mark.parametrize("n,batch,index,count,shuffle,seed,drop_last", [
    (23, 4, 0, 1, True, 0, True),
    (23, 4, 0, 1, False, 0, True),
    (23, 4, 0, 1, True, 7, False),
    (23, 5, 1, 3, True, 3, True),
    (24, 4, 2, 3, True, 3, False),
    (3, 4, 0, 1, True, 0, True),
    (0, 4, 0, 1, True, 0, True),
])
def test_host_shard_indices_match(n, batch, index, count, shuffle, seed,
                                  drop_last):
    kw = dict(process_index=index, process_count=count, shuffle=shuffle,
              seed=seed, drop_last=drop_last)
    got = loading.host_shard_indices(n, batch, **kw)
    assert_same(got, jax_loading.host_shard_indices(n, batch, **kw))
    assert all(len(b) == batch for b in got) or not drop_last


def _prepared(ds, kind):
    """A prepared split, ctc_tpu's, for the collate of ``kind``."""
    labels, counts, rgb = ds["labels"], ds["counts"], ds["rgb"]
    if kind in ("verb", "binary", "joint"):
        return jax_charades.prepare_windows(labels, counts, "train", 10, 2, 2,
                                            rgb)[0]
    if kind == "v1":
        data = jax_variants.prepare_v1(labels, counts, 4, 1, rgb)
        return _common.filter_samples(
            data, [i for i, t in enumerate(data["times"]) if int(t) >= 2])
    if kind == "ver2":
        return jax_variants.prepare_ver2(labels, counts, 4, 1, 1, rgb)
    if kind == "c_class":
        return jax_variants.prepare_c_class(labels, counts, "train", 4, 1,
                                            rgb)
    return jax_variants.prepare_ver3(labels, counts, "train", 4, 1, 1, rgb)


COLLATES = {
    "verb": (loading.collate_verb_ctc, jax_loading.collate_verb_ctc),
    "binary": (loading.collate_binary_ctc, jax_loading.collate_binary_ctc),
    "joint": (loading.collate_joint_ctc, jax_loading.collate_joint_ctc),
    "v1": (v1.collate_v1, jax_v1.collate_v1),
    "ver2": (charades_ver2.collate_ver2, jax_ver2.collate_ver2),
    "c_class": (charades_ver2_c_class.collate_c_class,
                jax_c_class.collate_c_class),
    "ver3-ce": (lambda *a: charades_ver3.collate_ver3(*a, "ce"),
                lambda *a: jax_ver3.collate_ver3(*a, "ce")),
    "ver3-bce": (lambda *a: charades_ver3.collate_ver3(*a, "bce"),
                 lambda *a: jax_ver3.collate_ver3(*a, "bce")),
    "ver3-mlce": (lambda *a: charades_ver3.collate_ver3(*a, "mlce"),
                  lambda *a: jax_ver3.collate_ver3(*a, "mlce")),
}


@pytest.mark.parametrize("kind", list(COLLATES))
def test_collates_match(ds, kind):
    data = _prepared(ds, kind.split("-")[0])
    n = len(data["ids"])
    assert n >= 4
    feats = np.random.default_rng(2).standard_normal((n, 4, 6)).astype(
        np.float32)
    ours, theirs = COLLATES[kind]
    for idx in jax_loading.host_shard_indices(n, 4, seed=1, drop_last=False):
        got = ours(data, idx, feats[idx])
        assert_same(got, theirs(data, idx, feats[idx]))
        assert got["feats"].dtype == np.float32


@pytest.mark.parametrize("writer", ["ctc_tpu", "ctc_tpu_torch"])
def test_cached_prepare_reads_the_other_packages_pickle(ds, tmp_path,
                                                        writer):
    """The reader is given no labels: it returns what the writer cached."""
    write, read = ((jax_charades, charades) if writer == "ctc_tpu"
                   else (charades, jax_charades))
    kw = dict(temporal=10, gap=2, num_trans=2, rgb_root=ds["rgb"])
    cache = str(tmp_path / "cache")
    want = write.cached_prepare(cache, "val_video", ds["labels"],
                                ds["counts"], **kw)
    assert (tmp_path / "cache" / "Charades_val_video.pkl").exists()
    got = read.cached_prepare(cache, "val_video", {}, {}, **kw)
    assert_same(got, want)
    assert_same(want, jax_charades.prepare_windows(
        ds["labels"], ds["counts"], "val_video", **kw))


@pytest.mark.parametrize("writer", ["ctc_tpu", "ctc_tpu_torch"])
def test_groundtruth_round_trip(ds, tmp_path, writer):
    _, table = jax_charades.prepare_windows(ds["labels"], ds["counts"],
                                            "val_video", 4, 1, 1)
    assert table
    write, read = ((jax_groundtruth, groundtruth) if writer == "ctc_tpu"
                   else (groundtruth, jax_groundtruth))
    path = str(tmp_path / "groundtruth.p")
    write.save_groundtruth(path, table)
    got = read.load_groundtruth(path)
    assert_same(got, jax_groundtruth.load_groundtruth(path))
    assert_same(got, {vid: [list(map(int, r)) for r in rows]
                      for vid, rows in table.items()})


def test_prefetcher_yields_in_order_and_raises():
    items = [{"i": i} for i in range(7)]
    assert list(loading.Prefetcher(lambda: iter(items), depth=2)) == items

    def broken():
        yield {"i": 0}
        raise ValueError("collate failed")

    it = iter(loading.Prefetcher(broken))
    assert next(it) == {"i": 0}
    with pytest.raises(ValueError, match="collate failed"):
        next(it)


def test_lazy_batches_collate_on_access():
    calls = []

    def collate(data, idx, feats):
        calls.append(list(idx))
        return {"feats": np.asarray(feats)}

    feats = np.arange(12, dtype=np.float32).reshape(6, 2)
    lazy = _common.LazyBatches({"ids": list(range(6))}, feats,
                               [[0, 1], [2, 3], [4, 5]], collate)
    assert len(lazy) == 3 and calls == []
    assert_same(lazy[1]["feats"], feats[[2, 3]])
    assert calls == [[2, 3]]
    assert [b["feats"].shape for b in lazy] == [(2, 2)] * 3
