"""Smoke run of ctc_tpu_torch on one CUDA card.

Builds the hand-written CUDA kernels from ``ctc_tpu_torch/csrc/``, holds
each against its plain PyTorch version on the card, trains the feature-mode
LSTM head through the command-line entry point at full width with the
NoBlankCTC loss and with the blank CTC loss, then both again with the
lattice's T axis split into 4 shards (``--seq-parallel 4``), decodes from
the checkpoints they wrote (greedy, beam, Viterbi alignment, and the
sharded greedy decode), then trains on a Charades-format corpus written
from a seed (the reference's default run through ``cli.exe``, and the ver2
binary and c_class blank variants, on cached features; the data layer
timed), evaluates on the same corpus (per-epoch video mAP and transition
metrics, ``--evaluate`` with and without a groundtruth lookup, the ver2
object mAP, the joint (object, verb) head with its relation tagging and
decode; the eval held to the CPU's), runs the one-card trainer features
(K steps as one CUDA graph held to the same steps run eagerly, the CLI with
--steps-per-dispatch, --accum-grad, --skip-nonfinite, --grad-norm-freq and
--profile-dir, a restart after a crash, the Charades default run in groups
of 4), checks that each run went through its kernels, profiles each train
step eagerly and as a graph and host batches fed plainly and through
``device_prefetch``, and times each
kernel beside its plain version, its bound and, where one exists, the
PyTorch call that computes the same function.  Then the same
for the ten forward-lattice probe kernels at three shapes (the last at the
edges of the em ring), the three row-10 kernels at a fourth past the ring
(em read inside the step), and both probe entry points
(``python -m ctc_tpu_torch.probes.fwd_ops`` and ``.expdomain_fwd``) at the
bench shape, each in a process of its own.  Prints one JSON line per
phase; the last line is ``{"ok": true, "device": {...}}``.  Any failure
exits non-zero.

Run from the repository root: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# Tolerances: the JAX suite's own for its Pallas kernel against the XLA scan
# (tests/test_pallas_lattice.py): both sides are f32 and differ only in the
# libm of exp/log1p and in summation order.
LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-5
# One train step, card (kernels, cuDNN-free f32 matmuls) against CPU (plain
# lattice): the 1024-deep projection sums in another order on each side,
# which moves the loss by ~1e-6 relative; Adam's first step is
# lr * g / (|g| + eps), so each parameter moves by at most lr and agrees to
# rounding wherever |g| is well above rounding noise.
STEP_LOSS_RTOL = 1e-4
STEP_PARAM_ATOL = 1e-5
# ...except feature_head.proj.bias, whose gradient is zero up to rounding
# (the per-timestep BatchNorm removes any shift): Adam normalizes that
# rounding noise into a step of up to lr in either direction.
STEP_ZERO_GRAD_PARAMS = ("feature_head.proj.bias",)

KERNELS = {
    "noblank_lattice_forward": {
        "route": "cuda",
        "source": "ctc_tpu_torch/csrc/noblank_lattice.cu",
        "replaces": "ctc_tpu/ops/lattice_pallas.py:143",
    },
    "noblank_lattice_backward": {
        "route": "cuda",
        "source": "ctc_tpu_torch/csrc/noblank_lattice.cu",
        "replaces": "ctc_tpu/ops/lattice_pallas.py:180",
    },
    "blank_lattice_forward": {
        "route": "cuda",
        "source": "ctc_tpu_torch/csrc/blank_lattice.cu",
        "replaces": "ctc_tpu/ops/blank_lattice_pallas.py:61",
    },
    "blank_lattice_backward": {
        "route": "cuda",
        "source": "ctc_tpu_torch/csrc/blank_lattice.cu",
        "replaces": "ctc_tpu/ops/blank_lattice_pallas.py:95",
    },
    "noblank_shard_forward": {
        "route": "cuda",
        "source": "ctc_tpu_torch/csrc/noblank_lattice.cu",
        "replaces": "ctc_tpu/ops/lattice_pallas.py:242",
    },
    "noblank_shard_backward": {
        "route": "cuda",
        "source": "ctc_tpu_torch/csrc/noblank_lattice.cu",
        "replaces": "ctc_tpu/ops/lattice_pallas.py:282",
    },
    "blank_shard_forward": {
        "route": "cuda",
        "source": "ctc_tpu_torch/csrc/blank_lattice.cu",
        "replaces": "ctc_tpu/ops/blank_lattice_pallas.py:160",
    },
    "blank_shard_backward": {
        "route": "cuda",
        "source": "ctc_tpu_torch/csrc/blank_lattice.cu",
        "replaces": "ctc_tpu/ops/blank_lattice_pallas.py:196",
    },
}

# main path: the CLI's synthetic run at the LSTM head's full width
MAIN_ARGS = ["--dataset", "synthetic", "--batch-size", "256",
             "--temporal", "10", "--extract-feat-dim", "1024",
             "--epochs", "2", "--device", "cuda"]
MAIN_SHAPE = (10, 256, 10)  # T, B, L (L = max path = temporal)
BENCH_SHAPE = (128, 1024, 157)  # bench.py's no-blank lattice shape
# the blank main path: the same run under --loss blank, a c_class = 157
# head (charades_ver2_c_class's combined classes), paths of at most T/2
BLANK_ARGS = MAIN_ARGS + ["--loss", "blank"]
BLANK_CLASSES = 157
BLANK_MAIN_SHAPE = (10, 256, 5)  # T, B, L (S = 2L+1 = 11)
BLANK_BENCH_SHAPE = (128, 1024, 20)  # bench.py:205's blank shape, S = 41
VAL_WINDOWS = 2 * 256  # the synthetic loader's 2 val batches
# the seq-parallel main path: the same runs at T = 64 split into 4 shards of
# 16 frames; noblank in 8 microbatches of 32 (L = max path = 64), blank in
# the default 4 microbatches of 64 (paths of at most T/2 = 32, S = 65)
SEQ_SHARDS = 4
SEQ_COMMON = ["--dataset", "synthetic", "--batch-size", "256",
              "--temporal", "64", "--extract-feat-dim", "1024",
              "--epochs", "2", "--device", "cuda"]
SEQ_FLAGS = ["--seq-parallel", str(SEQ_SHARDS)]
SEQ_NOBLANK_ARGS = SEQ_COMMON + SEQ_FLAGS + ["--seq-microbatches", "8"]
SEQ_BLANK_ARGS = SEQ_COMMON + ["--loss", "blank"] + SEQ_FLAGS
SEQ_MAIN = {"noblank": (64, 256, 64, 8), "blank": (64, 256, 32, 4)}  # T B L M
# the long-T shape the pipeline exists for: bench_seq_scaling.py:30's T,
# B, L over 4 shards and 4 microbatches, so one shard is t_s 1024, B 4
SEQ_LONG = {"noblank": (4096, 16, 24, 4), "blank": (4096, 16, 24, 4)}
# the Charades phase: a Charades-format corpus written from a seed
# (ctc_tpu_torch.data.charades_corpus: 240 train and 56 val videos drawn to
# Charades' published means, empty frames, [N, 10, 1024] f32 features per
# split and loader), then the reference's default run (cli.exe's preset:
# --temporal 10 --gap 2 --num-trans 2, batch 10, 1024-d features, a 33-verb
# head, --loss noblank) and two variants through cli.main at the same
# geometry, 2 epochs each
CHARADES_GEOMETRY = ["--temporal", "10", "--gap", "2", "--num-trans", "2"]
CHARADES_BATCH = 10  # the config's default, which the preset keeps
CHARADES_EPOCHS = 2
CHARADES_MIN_TRAIN_BATCHES = 16
# (label, entry, flags before the paths, kernel family, feature file stem)
CHARADES_RUNS = (
    ("default", "exe", [], "noblank", "features"),
    ("ver2_binary", "main", CHARADES_GEOMETRY + [
        "--dataset", "charades_ver2", "--loss", "binary"], "noblank",
     "features_ver2"),
    ("c_class_blank", "main", CHARADES_GEOMETRY + [
        "--dataset", "charades_ver2_c_class", "--loss", "blank"], "blank",
     "features_cclass"),
)
# the data layer's stages, timed inside each run by wrapping, for the run,
# the functions the Charades loaders call: {stage: [(module, function)]};
# feature_read also takes the row reads from the memmaps load_features opens
_LOADERS = "ctc_tpu_torch.data.loaders."
CHARADES_STAGES = {
    "csv_parse": [("ctc_tpu_torch.data.charades", "parse_charades_csv")],
    "frame_count": [("ctc_tpu_torch.data.charades", "count_frames")],
    "prepare": [("ctc_tpu_torch.data.charades", "cached_prepare"),
                (_LOADERS + "charades_ver2", "prepare_ver2"),
                (_LOADERS + "charades_ver2_c_class", "prepare_c_class")],
    "feature_read": [(_LOADERS + "_common", "load_features")],
    "collate": [(_LOADERS + "charades_ctc_next_pred", "collate_verb_ctc"),
                (_LOADERS + "charades_ctc_next_pred", "collate_binary_ctc"),
                (_LOADERS + "charades_ctc_next_pred", "collate_joint_ctc"),
                (_LOADERS + "charades_ver2", "collate_ver2"),
                (_LOADERS + "charades_ver2_c_class", "collate_c_class")],
}
# the eval phase times, inside each run, the validation pass (the eval
# step, with the transition metrics where asked), the video-level eval
# (the model over every val_video window, then mAP and relation tagging
# in numpy) and the decode
EVAL_STAGES = {
    "validate": [("ctc_tpu_torch.train.trainer", "Trainer.validate")],
    "video_eval": [("ctc_tpu_torch.eval.video", "evaluate_videos"),
                   ("ctc_tpu_torch.eval.video", "evaluate_videos_joint")],
    "decode": [("ctc_tpu_torch.eval.video", "decode_windows")],
}
TRANSITION_KEYS = ("trans_top1", "trans_top5", "recall_top1", "recall_top5")
# the eval on the card against the CPU's, from one checkpoint: window
# scores as the LSTM head's f32 matmuls sum in another order; the mAP from
# the same ranking, up to the float64 sums of numpy
EVAL_SCORE_RTOL, EVAL_SCORE_ATOL = 1e-5, 1e-6
EVAL_MAP_ATOL = 1e-6
SENTINEL_SCALE = 1e20  # a blank-CTC loss past this is the sentinel's (1e30)
FP32_PEAK = 67e12  # H100 SXM f32 outside the tensor cores (data sheet)

# the forward-lattice probes (ops/probe_cuda.py): their entry points' bench
# shape, and an edge shape with T not a multiple of the chunk, L not a
# multiple of 8 (L_PAD 24) and B not a multiple of the kernels' 8-wide tile
PROBE_SHAPE = BENCH_SHAPE
PROBE_EDGE = (37, 100, 21)
# row 9's em ring at its edges: fewer steps than ring slots, 21 samples
# (lanes masked, rows not 16-byte aligned) and L_PAD 1504, where only a
# two-slot ring fits beside the carry; the carry-only variant runs chunk 3
PROBE_RING_EDGE = (3, 21, 1500)
# row 10 only (row 9 refuses it): L_PAD 2000, past the em ring, where
# expdomain_kernel reads em inside the step
PROBE_PAST_RING = (3, 21, 2000)
PROBE_CHUNK = 16
PROBE_ITERS = 20  # per timed run of the entry points
# each kernel repeats its plain version's f32 operations in order (expf,
# log1pf, fmaxf, IEEE divide; no fast-math): rtol 1e-6; exp-domain values
# run down toward the denormals, hence the tiny atol there
PROBE_RTOL = 1e-6
PROBE_ATOL = {"log": 1e-6, "exp": 1e-30}
_PROBES_CU = "ctc_tpu_torch/csrc/fwd_probes.cu"
PROBE_KERNELS = {
    **{f"probe_{body}": {"route": "cuda", "source": _PROBES_CU,
                         "replaces": "probe_fwd_ops.py:30"}
       for body in ("copy", "add", "roll", "lse", "lse_manual", "lse_exp2")},
    "probe_noout": {"route": "cuda", "source": _PROBES_CU,
                    "replaces": "probe_fwd_ops.py:106"},
    "probe_fwd_log": {"route": "cuda", "source": _PROBES_CU,
                      "replaces": "probe_expdomain_fwd.py:42"},
    "probe_fwd_exp": {"route": "cuda", "source": _PROBES_CU,
                      "replaces": "probe_expdomain_fwd.py:66"},
    "probe_fwd_exp_renorm": {"route": "cuda", "source": _PROBES_CU,
                             "replaces": "probe_expdomain_fwd.py:89"},
}


def hbm_rate(name: str) -> float:
    """Data-sheet memory rate of the card, bytes/s."""
    if "PCIe" in name:
        return 2.0e12
    if "NVL" in name:
        return 3.9e12
    return 3.35e12  # H100 SXM


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def make_case(gen, shape, *, degenerate=False, outside=False, device):
    """em, input and target lengths and a cotangent; with ``outside``,
    samples 1 and 2 get input lengths 0 and T + 1 (outside [1, T]: their
    NLL is 0)."""
    import torch

    T, B, L = shape
    em = torch.randn((T, B, L), generator=gen) - 1.0
    inlen = torch.randint(1, T + 1, (B,), generator=gen)
    tgt = torch.randint(1, L + 1, (B,), generator=gen)
    inlen[0], tgt[0] = T, L
    if degenerate:
        inlen[1] = min(3, T)
    else:
        tgt = torch.minimum(tgt, inlen)
    if outside and B >= 3:
        inlen[1], inlen[2] = 0, T + 1
    cot = torch.randn((B,), generator=gen)
    return [x.to(device) for x in (em, inlen, tgt, cot)]


def check_outside_zero(name, nll, inlen, T):
    """The kernel-written NLL is 0 where the input length lies outside [1,
    T]; returns how many such samples there were."""
    out = (inlen < 1) | (inlen > T)
    if bool((nll[out] != 0).any()):
        fail(f"{name}: kernel nll nonzero where input_length is outside "
             f"[1, {T}]")
    return int(out.sum())


def max_dev(a, b):
    return float((a - b).abs().max()) if a.numel() else 0.0


def check_close(name, got, want, rtol, atol):
    import torch

    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        fail(f"{name}: max |dev| {max_dev(got, want)} beyond rtol {rtol} "
             f"atol {atol}")


def phase_build():
    from ctc_tpu_torch.ops import cuda_build

    sources = sorted(cuda_build.SIGNATURES)
    t0 = time.perf_counter()
    # one nvcc per source, all started together
    with ThreadPoolExecutor(len(sources)) as pool:
        paths = list(pool.map(cuda_build.build, sources))
    seconds = time.perf_counter() - t0
    for src in sources:
        cuda_build.load(src)
        print(cuda_build.build_logs.get(src, "(built earlier)"),
              file=sys.stderr)
    emit({"phase": "build", "sources": sources, "seconds": seconds,
          "libraries": [os.path.basename(p) for p in paths]})


def phase_parity():
    """Each kernel against the plain version on the card: the NLL the
    forward kernel writes against ``gather_nll`` of the plain alpha (0
    where the input length lies outside [1, T]), reachable alpha cells, and
    d nll / d em under a random cotangent."""
    import torch

    from ctc_tpu_torch.ops import lattice_cuda as lc

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    cases = [
        ("main_path", MAIN_SHAPE, False),
        ("bench", BENCH_SHAPE, False),
        ("small", (16, 4, 10), False),
        ("odd", (37, 11, 157), False),
        ("degenerate", (24, 4, 12), True),
        ("L1", (9, 3, 1), False),
        ("wide_L", (20, 3, 1500), False),  # L above one block of threads
        # the backward's layouts at their edges (lc.backward_plan): both
        # sides of the chunks-warp layout's widest row (T past a chunk) and
        # of the warps layout's; the rows layout with its threads striding
        # unevenly, past the widest row the shard backward's chunks take
        # (5282) and at the widest the first kernels took; T = 1.  The
        # forward's (lc.forward_plan) end at the same 32 and 1024 cells
        ("narrow_widest", (37, 5, 32), False),
        ("wide_narrowest", (37, 6, 33), False),
        ("warps_widest", (5, 2, 1024), False),
        ("rows_first", (5, 2, 1025), False),
        ("rows_strided", (3, 2, 2049), False),
        ("rows_past_shard", (2, 2, 5283), False),
        ("rows_widest", (2, 1, 29056), False),
        ("T1", (1, 9, 10), False),
        # the forward's layouts at their edges, with input lengths outside
        # [1, T]: the pairs layout in one warp at its widest and in two;
        # T one below, at and one past the em ring's depth (8); samples not
        # filling the warp layout's last block; both sides of the block
        # layout's 8-row ring's end and of its own
        ("fwd_pairs_one_warp", (9, 5, 63), "outside"),
        ("fwd_pairs_two_warps", (9, 5, 64), "outside"),
        ("fwd_T7", (7, 9, 10), "outside"),
        ("fwd_T8", (8, 5, 157), "outside"),
        ("fwd_T9", (9, 13, 32), "outside"),
        ("fwd_warp_widest", (12, 11, 32), "outside"),
        ("fwd_pairs_first", (12, 5, 33), "outside"),
        ("fwd_pairs_widest", (6, 3, 1024), "outside"),
        ("fwd_block_first", (6, 3, 1025), "outside"),
        ("fwd_block_deep_widest", (3, 3, 5810), "outside"),
        ("fwd_block_shallow", (3, 3, 5811), "outside"),
        ("fwd_block_widest", (2, 3, 14527), "outside"),
        ("fwd_rows_first", (2, 3, 14528), "outside"),
    ]
    errs = {}
    for label, shape, flag in cases:
        em, inlen, tgt, cot = make_case(gen, shape,
                                        degenerate=flag is True,
                                        outside=flag == "outside",
                                        device=dev)
        inlen32, tgt32 = inlen.int(), tgt.int()
        alpha_k, nll_k = lc.noblank_alpha_kernel(em, inlen32, tgt32)
        alpha_p = lc.noblank_alpha_plain(em, tgt32)
        nll_p = lc.gather_nll(alpha_p, inlen32, tgt32)
        g_k = lc.noblank_grad_kernel(alpha_k, inlen32, tgt32, cot)
        g_p = lc.noblank_grad_plain(alpha_p, inlen32, tgt32, cot)
        torch.cuda.synchronize()
        reach = alpha_p > -1e12  # cells a path reaches (others hold ~-1e13)
        check_close(f"{label} nll", nll_k, nll_p, LOSS_RTOL, LOSS_ATOL)
        outside = check_outside_zero(label, nll_k, inlen, shape[0])
        check_close(f"{label} alpha", alpha_k[reach], alpha_p[reach],
                    LOSS_RTOL, LOSS_ATOL)
        check_close(f"{label} grad", g_k, g_p, GRAD_RTOL, GRAD_ATOL)
        t_idx = torch.arange(shape[0], device=dev)[:, None]
        past = (t_idx >= inlen[None, :])[:, :, None].expand_as(g_k)
        if bool((g_k[past] != 0).any()):
            fail(f"{label}: kernel gradient nonzero at t >= input_length")
        # the autograd path through the wrapper, both implementations
        e1 = em.clone().requires_grad_()
        e2 = em.clone().requires_grad_()
        (lc.noblank_lattice_nll_cuda(e1, inlen, tgt) * cot).sum().backward()
        (lc.noblank_lattice_nll_plain(e2, inlen, tgt) * cot).sum().backward()
        check_close(f"{label} autograd grad", e1.grad, e2.grad, GRAD_RTOL,
                    GRAD_ATOL)
        row = {
            "phase": "parity", "case": label, "shape_TBL": list(shape),
            "forward_plan": list(lc.forward_plan(shape[2])),
            "backward_plan": list(lc.backward_plan(shape[2])),
            "nll_outside_samples_zero": outside,
            "nll_max_abs_dev": max_dev(nll_k, nll_p),
            "nll_max_rel_dev": float(((nll_k - nll_p).abs()
                                      / nll_p.abs().clamp_min(1e-30)).max()),
            "alpha_reachable_max_abs_dev": max_dev(alpha_k[reach],
                                                   alpha_p[reach]),
            "grad_max_abs_dev": max_dev(g_k, g_p),
            "rtol_atol_loss": [LOSS_RTOL, LOSS_ATOL],
            "rtol_atol_grad": [GRAD_RTOL, GRAD_ATOL],
        }
        emit(row)
        errs[label] = row
    return errs


def reset_counts() -> None:
    from ctc_tpu_torch.ops import blank_lattice_cuda as bl
    from ctc_tpu_torch.ops import lattice_cuda as lc

    lc.reset_launch_counts()
    bl.reset_launch_counts()


def read_counts() -> dict:
    from ctc_tpu_torch.ops import blank_lattice_cuda as bl
    from ctc_tpu_torch.ops import lattice_cuda as lc

    return {**lc.launch_counts, **bl.launch_counts}


def expect_counts(noblank=(0, 0), blank=(0, 0), noblank_shard=(0, 0),
                  blank_shard=(0, 0)) -> dict:
    """The launch counts a run must show: (forward, backward) of each
    kernel pair."""
    return {"noblank_lattice_forward": noblank[0],
            "noblank_lattice_backward": noblank[1],
            "noblank_shard_forward": noblank_shard[0],
            "noblank_shard_backward": noblank_shard[1],
            "blank_lattice_forward": blank[0],
            "blank_lattice_backward": blank[1],
            "blank_shard_forward": blank_shard[0],
            "blank_shard_backward": blank_shard[1]}


def make_blank_case(gen, shape, *, device, classes=BLANK_CLASSES,
                    repeats=False, label0=False, zero_len=False, short=False,
                    infeasible=False, outside=False):
    """Raw gathered emissions ``[T, B, S]`` from random logits, the uint8
    skip mask, int32 lengths and a cotangent, on ``device``.  Sample 0 has
    the full T and L; the flags add repeated labels, labels equal to the
    blank id 0, zero-length targets, input lengths 1 and 2, one infeasible
    sample (fewer frames than its labels need), and input lengths 0 and T
    + 1 (outside [1, T]) at samples 1 and 2."""
    import torch

    from ctc_tpu_torch.losses.blank import blank_emissions_and_skip

    T, B, L = shape
    logits = torch.randn((T, B, classes), generator=gen)
    targets = torch.randint(1, classes, (B, L), generator=gen)
    if repeats:
        targets[:, 1::2] = targets[:, 0::2][:, : targets[:, 1::2].shape[1]]
    if label0:
        targets[1::3, 0] = 0
    # every sample gets frames for its labels and forced blanks (2L + 1)
    inlen = torch.randint(min(2 * L + 1, T), T + 1, (B,), generator=gen)
    tgt = torch.randint(0 if zero_len else 1, L + 1, (B,), generator=gen)
    inlen[0], tgt[0] = T, L
    if short and B >= 3:
        inlen[1], tgt[1] = 1, min(int(tgt[1]), 1)
        inlen[2], tgt[2] = 2, min(int(tgt[2]), 1)
    if infeasible and B >= 4:
        inlen[3], tgt[3] = max(L // 2, 1), L
    if zero_len and B >= 5:
        tgt[4] = 0
    if outside and B >= 3:
        inlen[1], inlen[2] = 0, T + 1
    em, skip = blank_emissions_and_skip(logits, targets, 0)
    cot = torch.randn((B,), generator=gen)
    return [x.to(device) for x in (em.contiguous(), skip.to(torch.uint8),
                                   inlen.int(), tgt.int(), cot)]


def phase_parity_blank():
    """Each blank kernel against the plain version on the card: the NLL the
    forward kernel writes against ``gather_nll`` of the plain alpha (0
    where the input length lies outside [1, T]), reachable alpha cells, d
    nll / d em under a random cotangent, the autograd op, and exact zeros
    at t >= input length."""
    import torch

    from ctc_tpu_torch.ops import blank_lattice_cuda as bl
    from ctc_tpu_torch.ops.lattice_cuda import backward_plan, forward_plan

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(2)
    every = dict(repeats=True, label0=True, zero_len=True, short=True,
                 infeasible=True)
    cases = [
        ("main_path", BLANK_MAIN_SHAPE, {}),
        ("bench", BLANK_BENCH_SHAPE, {}),
        ("small", (16, 4, 5), {}),
        ("odd", (37, 11, 9), {}),
        ("repeats", (24, 6, 6), dict(repeats=True)),
        ("label_equal_blank", (20, 6, 4), dict(label0=True)),
        ("zero_length", (12, 6, 4), dict(zero_len=True)),
        ("input_lengths_1_2", (6, 5, 2), dict(short=True)),
        ("infeasible", (16, 5, 5), dict(infeasible=True)),
        ("all_edges", (33, 13, 7), every),
        ("L1", (9, 3, 1), {}),
        ("wide_S", (20, 3, 800), {}),  # S = 1601, above one block
        # the backward's layouts at their edges (lc.backward_plan; S = 2L+1
        # = 31, 33, 1023, 1025, 2049, 4387, 25827), as in phase_parity
        # (the shard backward's chunks take up to 4385 slots)
        ("narrow_widest", (37, 5, 15), {}),
        ("wide_narrowest", (37, 6, 16), {}),
        ("warps_widest", (5, 2, 511), {}),
        ("rows_first", (5, 2, 512), {}),
        ("rows_strided", (3, 2, 1024), {}),
        ("rows_past_shard", (2, 2, 2193), {}),
        ("rows_widest", (2, 1, 12913), {}),
        ("T1", (1, 9, 5), {}),
        # the forward's layouts at their edges (lc.forward_plan; S = 63, 65,
        # 41 at T one below, at and one past the em ring's depth, 31, 33,
        # 1023, 1025, 5669, 5671, 13671, 13673), with input lengths outside
        # [1, T] and zero-length targets; samples not filling the warp
        # layout's last block
        ("fwd_pairs_one_warp", (9, 5, 31), dict(outside=True)),
        ("fwd_pairs_two_warps", (9, 5, 32), dict(outside=True)),
        ("fwd_T7", (7, 9, 5), dict(outside=True, zero_len=True)),
        ("fwd_T8", (8, 5, 20), dict(outside=True)),
        ("fwd_T9", (9, 13, 15), dict(outside=True, zero_len=True)),
        ("fwd_warp_widest", (12, 11, 15), dict(outside=True)),
        ("fwd_pairs_first", (12, 5, 16), dict(outside=True, zero_len=True)),
        ("fwd_pairs_widest", (6, 3, 511), dict(outside=True)),
        ("fwd_block_first", (6, 3, 512), dict(outside=True)),
        ("fwd_block_deep_widest", (3, 3, 2834), dict(outside=True)),
        ("fwd_block_shallow", (3, 3, 2835), dict(outside=True)),
        ("fwd_block_widest", (2, 3, 6835), dict(outside=True)),
        ("fwd_rows_first", (2, 3, 6836), dict(outside=True)),
    ]
    errs = {}
    for label, shape, flags in cases:
        em, skip, inlen, tgt, cot = make_blank_case(gen, shape, device=dev,
                                                    **flags)
        alpha_k, nll_k = bl.blank_alpha_kernel(em, skip, inlen, tgt)
        alpha_p = bl.blank_alpha_plain(em, skip)
        nll_p = bl.gather_nll(alpha_p, inlen, tgt)
        g_k = bl.blank_grad_kernel(alpha_k, skip, inlen, tgt, cot)
        g_p = bl.blank_grad_plain(alpha_p, skip, inlen, tgt, cot)
        torch.cuda.synchronize()
        reach = alpha_p > -1e29  # unreachable cells hold ~-1e30
        check_close(f"blank {label} nll", nll_k, nll_p, LOSS_RTOL, LOSS_ATOL)
        outside = check_outside_zero(f"blank {label}", nll_k, inlen,
                                     shape[0])
        check_close(f"blank {label} alpha", alpha_k[reach], alpha_p[reach],
                    LOSS_RTOL, LOSS_ATOL)
        check_close(f"blank {label} grad", g_k, g_p, GRAD_RTOL, GRAD_ATOL)
        t_idx = torch.arange(shape[0], device=dev)[:, None]
        past = (t_idx >= inlen[None, :].long())[:, :, None].expand_as(g_k)
        if bool((g_k[past] != 0).any()):
            fail(f"blank {label}: kernel gradient nonzero at "
                 f"t >= input_length")
        e1 = em.clone().requires_grad_()
        e2 = em.clone().requires_grad_()
        (bl.blank_lattice_nll_cuda(e1, skip, inlen, tgt) * cot).sum().backward()
        (bl.blank_lattice_nll_plain(e2, skip, inlen, tgt) * cot).sum(
        ).backward()
        check_close(f"blank {label} autograd grad", e1.grad, e2.grad,
                    GRAD_RTOL, GRAD_ATOL)
        row = {
            "phase": "parity_blank", "case": label,
            "shape_TBL": list(shape), "S": 2 * shape[2] + 1,
            "forward_plan": list(forward_plan(2 * shape[2] + 1, True)),
            "backward_plan": list(backward_plan(2 * shape[2] + 1, True)),
            "nll_outside_samples_zero": outside,
            "nll_max_abs_dev": max_dev(nll_k, nll_p),
            "nll_max_rel_dev": float(((nll_k - nll_p).abs()
                                      / nll_p.abs().clamp_min(1e-30)).max()),
            "alpha_reachable_max_abs_dev": max_dev(alpha_k[reach],
                                                   alpha_p[reach]),
            "grad_max_abs_dev": max_dev(g_k, g_p),
            "autograd_grad_max_abs_dev": max_dev(e1.grad, e2.grad),
            "sentinel_scale_samples": int((nll_p.abs() > 1e29).sum()),
            "rtol_atol_loss": [LOSS_RTOL, LOSS_ATOL],
            "rtol_atol_grad": [GRAD_RTOL, GRAD_ATOL],
        }
        emit(row)
        errs[label] = row
    return errs


def phase_main_path(cache):
    """The CLI's training run on the card, its checkpoint left in
    ``cache``; returns the launch counts."""
    import torch

    from ctc_tpu_torch.cli.main import main

    reset_counts()
    t0 = time.perf_counter()
    history = main(MAIN_ARGS + ["--cache-dir", cache])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    files = sorted(os.listdir(os.path.join(cache, "test")))
    epochs = len(history)
    train_steps, eval_steps = 8 * epochs, 2 * epochs  # the synthetic loader
    want = expect_counts(noblank=(train_steps + eval_steps, train_steps))
    if launches != want:
        fail(f"launch counts {launches}, expected {want}")
    losses = [h["train"]["loss"] for h in history]
    if not all(map(lambda x: x == x and abs(x) < float("inf"), losses)):
        fail(f"non-finite training loss {losses}")
    if not losses[-1] < losses[0]:
        fail(f"training loss did not fall: {losses}")
    emit({"phase": "main_path", "argv": MAIN_ARGS, "seconds": seconds,
          "train_steps": train_steps, "eval_steps": eval_steps,
          "launches": launches, "train_loss_by_epoch": losses,
          "val_loss_by_epoch": [h["val"]["loss"] for h in history],
          "step_s_host_avg": [h["train"]["time"] for h in history],
          "files": files})
    return launches


def phase_main_path_blank(cache):
    """The CLI's --loss blank training run on the card, its checkpoint left
    in ``cache``; returns the launch counts."""
    import torch

    from ctc_tpu_torch.cli.main import main

    reset_counts()
    t0 = time.perf_counter()
    history = main(BLANK_ARGS + ["--cache-dir", cache])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    epochs = len(history)
    train_steps, eval_steps = 8 * epochs, 2 * epochs  # the synthetic loader
    want = expect_counts(blank=(train_steps + eval_steps, train_steps))
    if launches != want:
        fail(f"blank launch counts {launches}, expected {want}")
    losses = [h["train"]["loss"] for h in history]
    if not all(map(lambda x: x == x and abs(x) < float("inf"), losses)):
        fail(f"non-finite blank training loss {losses}")
    if not losses[-1] < losses[0]:
        fail(f"blank training loss did not fall: {losses}")
    emit({"phase": "main_path_blank", "argv": BLANK_ARGS,
          "seconds": seconds, "train_steps": train_steps,
          "eval_steps": eval_steps, "launches": launches,
          "train_loss_by_epoch": losses,
          "val_loss_by_epoch": [h["val"]["loss"] for h in history],
          "step_s_host_avg": [h["train"]["time"] for h in history]})
    return launches


def phase_decode(blank_cache, noblank_cache):
    """--evaluate --decode (greedy, then --decode-beam 4) from the blank
    run's checkpoint, and --evaluate --decode-align from the no-blank
    run's: one CSV row per val window, each run through its kernels."""
    import csv

    import torch

    from ctc_tpu_torch.cli.main import main

    runs = [
        ("greedy", BLANK_ARGS, blank_cache, ["--decode"], "decoded_csv",
         expect_counts(blank=(2, 0))),
        ("beam4", BLANK_ARGS, blank_cache, ["--decode", "--decode-beam", "4"],
         "decoded_csv", expect_counts(blank=(2, 0))),
        ("align", MAIN_ARGS, noblank_cache, ["--decode-align"],
         "alignment_csv", expect_counts(noblank=(2, 0))),
    ]
    for label, args, cache, flags, key, want in runs:
        reset_counts()
        t0 = time.perf_counter()
        metrics = main(args + ["--cache-dir", cache, "--evaluate",
                               "--resume", os.path.join(cache, "test")]
                       + flags)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counts()
        if launches != want:
            fail(f"decode {label}: launch counts {launches}, expected {want}")
        with open(metrics[key], newline="") as f:
            rows = list(csv.reader(f))
        if len(rows) - 1 != VAL_WINDOWS:
            fail(f"decode {label}: {len(rows) - 1} rows, expected "
                 f"{VAL_WINDOWS}")
        if label == "align":
            for row in rows[1:]:
                ali = [int(x) for x in row[4].split()]
                steps = {b - a for a, b in zip(ali, ali[1:])}
                if len(ali) != int(row[2]) or ali[0] != 0 or steps - {0, 1}:
                    fail(f"decode align: not a stay/advance path: {row}")
        emit({"phase": "decode", "run": label, "flags": flags,
              "seconds": seconds, "launches": launches,
              "val_loss": metrics["loss"], "rows": len(rows) - 1,
              "file": os.path.basename(metrics[key]),
              "first_rows": rows[1:4]})


class _TimedRows:
    """A features memmap whose row reads add to ``seconds[stage]``."""

    def __init__(self, rows, seconds, stage):
        self._rows, self._seconds, self._stage = rows, seconds, stage

    def __getitem__(self, idx):
        import numpy as np

        t = time.perf_counter()
        out = np.asarray(self._rows[idx])
        self._seconds[self._stage] += time.perf_counter() - t
        return out


@contextlib.contextmanager
def timed_stages(stages):
    """For the block, wrap each stage's functions so that their calls add
    to the stage's seconds and calls; yields ``(seconds, calls)``."""
    import functools
    import importlib

    seconds = dict.fromkeys(stages, 0.0)
    calls = dict.fromkeys(stages, 0)

    def wrap(stage, fn):
        @functools.wraps(fn)
        def timed(*args, **kwargs):
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            seconds[stage] += time.perf_counter() - t
            calls[stage] += 1
            if stage == "feature_read":
                out = _TimedRows(out, seconds, stage)
            return out
        return timed

    saved = []
    try:
        for stage, targets in stages.items():
            for module, name in targets:
                # a dotted name is an attribute of a class in the module
                owner = importlib.import_module(module)
                *parents, name = name.split(".")
                for parent in parents:
                    owner = getattr(owner, parent)
                saved.append((owner, name, getattr(owner, name)))
                setattr(owner, name, wrap(stage, getattr(owner, name)))
        yield seconds, calls
    finally:
        for owner, name, fn in reversed(saved):
            setattr(owner, name, fn)


def infeasible_windows(cfg, batches) -> list:
    """Per batch, how many windows' blank-CTC targets need more frames than
    the window has (``losses.blank.min_frames``); their loss is at the
    lattice sentinel's scale.  0s for the blank-free losses."""
    import torch

    from ctc_tpu_torch.losses.blank import min_frames

    if cfg.loss != "blank":
        return [0] * len(batches)
    return [int((min_frames(b["paths"], b["target_lengths"])
                 > torch.as_tensor(b["input_lengths"])).sum())
            for b in batches]


def charades_step_vs_cpu(cfg, batch):
    """One step's loss and gradients on the first Charades batch: the card
    (kernels) against the CPU (plain lattice), same weights, dropout off.
    Returns max |dev| of the gradients."""
    import numpy as np
    import torch

    from ctc_tpu_torch import losses
    from ctc_tpu_torch.models import LSTMHead
    from ctc_tpu_torch.train.trainer import to_device

    torch.backends.cuda.matmul.allow_tf32 = False
    ref = LSTMHead(cfg.extract_feat_dim, cfg.head_classes, dropout_rate=0.0)
    ref.reset_parameters(torch.Generator().manual_seed(7))
    weights = ref.state_dict()
    out = {}
    for dev in ("cpu", "cuda"):
        model = LSTMHead(cfg.extract_feat_dim, cfg.head_classes,
                         dropout_rate=0.0)
        model.load_state_dict(weights)
        model.to(dev)
        b = to_device(batch, dev)
        logits = model(b["feats"].transpose(0, 1), train=True)
        loss = losses.LOSS_FNS[cfg.loss](logits, b["paths"],
                                         b["input_lengths"],
                                         b["target_lengths"])
        loss.backward()
        out[dev] = (float(loss.detach()), {n: p.grad.detach().cpu()
                                  for n, p in model.named_parameters()})
    (l_cpu, g_cpu), (l_gpu, g_gpu) = out["cpu"], out["cuda"]
    if not np.isclose(l_gpu, l_cpu, rtol=STEP_LOSS_RTOL, atol=0.0):
        fail(f"charades {cfg.dataset} step loss card {l_gpu} vs cpu {l_cpu}")
    for name, want in g_cpu.items():
        check_close(f"charades {cfg.dataset} grad {name}", g_gpu[name], want,
                    GRAD_RTOL, GRAD_ATOL)
    return {"loss_cuda": l_gpu, "loss_cpu": l_cpu,
            "grad_max_abs_dev": max(max_dev(g_gpu[n], g_cpu[n])
                                    for n in g_cpu)}


def phase_charades(work, card):
    """The Charades data layer end to end on the card: write the corpus,
    run the reference's default run through ``cli.exe.run`` and the ver2
    binary and c_class blank variants through ``cli.main``, each on the
    cached features for 2 epochs; check each run's kernel launches against
    its loader's batch count and that its loss falls (where a window's
    blank-CTC target needs more frames than it has, that its top-1 rises);
    time the data layer inside the run, stage by stage; hold one step on
    the first batch whose windows are all feasible to the CPU.  Returns
    ``({run: launch counts}, the corpus's path flags, its window counts)``."""
    import torch

    from ctc_tpu_torch import config
    from ctc_tpu_torch.cli import exe
    from ctc_tpu_torch.cli import main as cli_main
    from ctc_tpu_torch.data.charades_corpus import write_corpus

    t0 = time.perf_counter()
    corpus = write_corpus(os.path.join(work, "charades"), seed=0)
    write_s = time.perf_counter() - t0
    samples = corpus["samples"]
    train_batches = samples["features_train"] // CHARADES_BATCH
    if train_batches < CHARADES_MIN_TRAIN_BATCHES:
        fail(f"charades: the default run's train split has {train_batches} "
             f"batches of {CHARADES_BATCH}, fewer than "
             f"{CHARADES_MIN_TRAIN_BATCHES}")
    paths = ["--rgb-data", corpus["rgb_data"],
             "--train-file", corpus["train_file"],
             "--val-file", corpus["val_file"],
             "--features-dir", corpus["features_dir"]]
    emit({"phase": "charades_corpus", "seconds": write_s,
          "samples": samples, "nvidia_smi": card})
    entries = {"exe": exe.run, "main": cli_main.main}
    all_launches = {}
    for label, entry, flags, family, stem in CHARADES_RUNS:
        cache = os.path.join(work, f"charades_{label}")
        argv = flags + paths + ["--cache-dir", cache,
                                "--resume", os.path.join(cache, "fresh"),
                                "--epochs", str(CHARADES_EPOCHS),
                                "--device", "cuda"]
        # the data layer inside the run: the CLI's get_dataset, and each
        # stage's functions in it
        data_s, out = [], []
        get_dataset = cli_main.get_dataset

        def timed(cfg, get_dataset=get_dataset, data_s=data_s, out=out):
            t = time.perf_counter()
            out.append(get_dataset(cfg))
            data_s.append(time.perf_counter() - t)
            return out[-1]

        cli_main.get_dataset = timed
        try:
            with timed_stages(CHARADES_STAGES) as (stages, stage_calls):
                reset_counts()
                t0 = time.perf_counter()
                history = entries[entry](argv)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                launches = read_counts()
        finally:
            cli_main.get_dataset = get_dataset
        if len(out) != 1 or not all(stage_calls.values()):
            fail(f"charades {label}: get_dataset called {len(out)} times, "
                 f"stage calls {stage_calls}")
        train, val = out[0]
        n_train, n_val = len(train), len(val)
        if (n_train, n_val) != (samples[f"{stem}_train"] // CHARADES_BATCH,
                                samples[f"{stem}_val"] // CHARADES_BATCH):
            fail(f"charades {label}: {n_train} / {n_val} batches from "
                 f"{samples[f'{stem}_train']} / {samples[f'{stem}_val']} "
                 f"windows")
        train_steps = n_train * CHARADES_EPOCHS
        eval_steps = n_val * CHARADES_EPOCHS
        want = expect_counts(**{family: (train_steps + eval_steps,
                                         train_steps)})
        if launches != want:
            fail(f"charades {label}: launch counts {launches}, expected "
                 f"{want}")
        cfg = config.parse((exe.PRESET if entry == "exe" else []) + argv)
        infeasible = infeasible_windows(cfg, train)
        losses = [h["train"]["loss"] for h in history]
        top1 = [h["train"]["top1"] for h in history]
        if len(losses) != CHARADES_EPOCHS or not all(
                x == x and abs(x) < float("inf") for x in losses):
            fail(f"charades {label}: training losses {losses}")
        if not any(infeasible):
            if not losses[-1] < losses[0]:
                fail(f"charades {label}: training loss did not fall: "
                     f"{losses}")
        # a window at the sentinel's scale in every epoch holds each
        # epoch's loss there; the learning shows in top-1
        elif not (min(losses) > SENTINEL_SCALE and top1[-1] > top1[0]):
            fail(f"charades {label}: {sum(infeasible)} infeasible windows, "
                 f"losses {losses}, top-1 {top1}")
        first = next(b for b, n in zip(train, infeasible) if n == 0)
        step = charades_step_vs_cpu(cfg, first)
        emit({"phase": "charades", "run": label,
              "entry": f"ctc_tpu_torch.cli.{entry}", "argv": argv,
              "dataset": cfg.dataset, "loss": cfg.loss,
              "head_classes": cfg.head_classes,
              "batch_size": cfg.batch_size, "feat_dim": cfg.extract_feat_dim,
              "batch_shapes": {k: list(v.shape) for k, v in first.items()},
              "train_batches": n_train, "val_batches": n_val,
              "train_steps": train_steps, "eval_steps": eval_steps,
              "infeasible_train_windows": sum(infeasible),
              "infeasible_train_batches": sum(n > 0 for n in infeasible),
              "infeasible_val_windows": sum(infeasible_windows(cfg, val)),
              "launches": launches, "train_loss_by_epoch": losses,
              "train_top1_by_epoch": top1,
              "val_loss_by_epoch": [h["val"]["loss"] for h in history],
              "seconds": seconds, "data_s_in_run": sum(data_s),
              "train_s_in_run": seconds - sum(data_s),
              "step_s_host_avg": [h["train"]["time"] for h in history],
              "data_stage_s": stages, "data_stage_calls": stage_calls,
              "step_vs_cpu": step, "nvidia_smi": card})
        all_launches[label] = launches
    return all_launches, paths, samples


def eval_run(entry, argv):
    """One CLI run on the card with the launch counts reset before it, the
    EVAL_STAGES timed inside it and its printed lines captured: ``(result,
    launches, seconds, stage seconds, stage calls, printed text)``."""
    import torch

    out = io.StringIO()
    with timed_stages(EVAL_STAGES) as (stages, calls), \
            contextlib.redirect_stdout(out):
        reset_counts()
        t0 = time.perf_counter()
        result = entry(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counts()
    return result, launches, seconds, stages, calls, out.getvalue()


def eval_row(label, argv, launches, seconds, stages, calls, card, **extra):
    """The phase's JSON line for one run; the eval wall time is the
    validation passes, the video-level evals and the decode together."""
    return {"phase": "eval", "run": label, "argv": argv,
            "launches": launches, "seconds": seconds,
            "eval_s": sum(stages.values()), "eval_stage_s": stages,
            "eval_stage_calls": calls, **extra, "nvidia_smi": card}


def check_launches(label, launches, want):
    if launches != want:
        fail(f"eval {label}: launch counts {launches}, expected {want}")


def check_history(label, history, run_dir, *, transition=False):
    """Each epoch's mAP finite, in score.csv's sixth column and as its
    checkpoint's score; the transition metrics in the val metrics where
    asked."""
    import csv
    import math

    import torch

    maps = [h["val"].get("mAP", float("nan")) for h in history]
    if len(maps) != CHARADES_EPOCHS or not all(map(math.isfinite, maps)):
        fail(f"eval {label}: per-epoch mAP {maps}")
    with open(os.path.join(run_dir, "score.csv"), newline="") as f:
        rows = list(csv.reader(f))
    if [len(r) for r in rows] != [6] * len(maps) or [
            float(r[5]) for r in rows] != maps:
        fail(f"eval {label}: score.csv {rows}, mAP {maps}")
    for epoch, m in enumerate(maps):
        payload = torch.load(os.path.join(run_dir, "ckpt", f"{epoch}.pt"),
                             map_location="cpu", weights_only=True)
        if payload["score"] != m:
            fail(f"eval {label}: epoch {epoch} checkpoint score "
                 f"{payload['score']}, mAP {m}")
    if transition and not all(set(TRANSITION_KEYS) <= set(h["val"])
                              for h in history):
        fail(f"eval {label}: val metrics {sorted(history[0]['val'])} lack "
             f"{TRANSITION_KEYS}")
    return maps


def check_falls(label, history):
    losses = [h["train"]["loss"] for h in history]
    if not (all(x == x and abs(x) < float("inf") for x in losses)
            and losses[-1] < losses[0]):
        fail(f"eval {label}: training losses {losses}")
    return losses


def printed_map(label, out) -> float:
    """The value on the run's ``video mAP:`` line."""
    lines = [ln for ln in out.splitlines() if ln.startswith("video mAP: ")]
    if len(lines) != 1:
        fail(f"eval {label}: {len(lines)} 'video mAP:' lines in {out!r}")
    return float(lines[0].split()[2])


def eval_vs_cpu(cfg, run_dir, batch):
    """From the default run's last checkpoint: ``evaluate_videos`` and one
    eval batch's transition metrics on the card against the CPU."""
    import numpy as np
    import torch

    from ctc_tpu_torch.data.loaders import charades_ctc_next_pred
    from ctc_tpu_torch.eval.video import evaluate_videos, score_windows
    from ctc_tpu_torch.models import LSTMHead
    from ctc_tpu_torch.train.trainer import (
        TrainState, make_eval_step, to_device,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    data, table = charades_ctc_next_pred.get_val_video(cfg)
    payload = torch.load(os.path.join(run_dir, "ckpt",
                                      f"{CHARADES_EPOCHS - 1}.pt"),
                         map_location="cpu", weights_only=True)
    step = make_eval_step(cfg.loss, transition_metrics=True)
    out = {}
    for dev in ("cpu", "cuda"):
        model = LSTMHead(cfg.extract_feat_dim, cfg.head_classes)
        model.load_state_dict(payload["model"])
        model.to(dev)
        scores = score_windows(model, data["features"])
        video = evaluate_videos(model, data, table,
                                num_verbs=cfg.head_classes)
        metrics = step(TrainState(model, None), to_device(batch, dev))
        out[dev] = (scores, video["mAP"],
                    {k: float(v) for k, v in metrics.items()})
    (s_cpu, map_cpu, m_cpu), (s_gpu, map_gpu, m_gpu) = out["cpu"], out["cuda"]
    if not np.allclose(s_gpu, s_cpu, rtol=EVAL_SCORE_RTOL,
                       atol=EVAL_SCORE_ATOL):
        fail(f"eval vs cpu: window scores max |dev| "
             f"{float(np.abs(s_gpu - s_cpu).max())}")
    if abs(map_gpu - map_cpu) > EVAL_MAP_ATOL:
        fail(f"eval vs cpu: mAP card {map_gpu} cpu {map_cpu}")
    for k in TRANSITION_KEYS + ("top1", "top5"):
        if m_gpu[k] != m_cpu[k]:
            fail(f"eval vs cpu: {k} card {m_gpu[k]} cpu {m_cpu[k]}")
    if not np.isclose(m_gpu["loss"], m_cpu["loss"], rtol=LOSS_RTOL,
                      atol=LOSS_ATOL):
        fail(f"eval vs cpu: loss card {m_gpu['loss']} cpu {m_cpu['loss']}")
    return {"windows": int(s_cpu.shape[0]),
            "score_max_abs_dev": float(np.abs(s_gpu - s_cpu).max()),
            "map_cuda": map_gpu, "map_cpu": map_cpu,
            "metrics_cuda": m_gpu, "metrics_cpu": m_cpu,
            "tolerance": {"score_rtol": EVAL_SCORE_RTOL,
                          "score_atol": EVAL_SCORE_ATOL,
                          "map_atol": EVAL_MAP_ATOL,
                          "transition": "exact"}}


def phase_eval(work, card, paths, samples):
    """Evaluation on the card on the Charades corpus of phase charades, at
    the preset geometry: the default run with per-epoch video mAP and
    transition metrics, ``--evaluate`` from its checkpoint with the rebuilt
    gt table and with a ``--groundtruth-lookup`` pickle of it, the ver2
    binary run scored on the objects, and the joint (object, verb) head
    trained, evaluated and decoded; then the eval of one checkpoint on the
    card against the CPU.  Checks each run's launches against its loader's
    batch counts and records each run's eval seconds.  Returns ``{run:
    launch counts}``."""
    import csv

    from ctc_tpu_torch import config
    from ctc_tpu_torch.cli import exe
    from ctc_tpu_torch.cli import main as cli_main
    from ctc_tpu_torch.data.loaders import charades_ctc_next_pred
    from ctc_tpu_torch.eval import video as video_mod
    from ctc_tpu_torch.utils.groundtruth import save_groundtruth

    epochs = CHARADES_EPOCHS
    batches = {stem: (samples[f"{stem}_train"] // CHARADES_BATCH,
                      samples[f"{stem}_val"] // CHARADES_BATCH)
               for stem in ("features", "features_ver2")}
    n_train, n_val = batches["features"]
    train_args = paths + ["--epochs", str(epochs), "--device", "cuda"]
    run_name = exe.PRESET[exe.PRESET.index("--name") + 1]
    all_launches = {}

    # the default run, mAP and transition metrics every epoch
    cache = os.path.join(work, "eval_default")
    run_dir = os.path.join(cache, run_name)
    argv = train_args + ["--cache-dir", cache,
                         "--resume", os.path.join(cache, "fresh"),
                         "--video-eval", "--transition-metrics"]
    history, launches, seconds, stages, calls, out = eval_run(exe.run, argv)
    check_launches("default", launches, expect_counts(
        noblank=((n_train + n_val) * epochs, n_train * epochs)))
    maps = check_history("default", history, run_dir, transition=True)
    losses = check_falls("default", history)
    if out.count("video mAP: ") != epochs:
        fail(f"eval default: printed {out!r}")
    all_launches["eval_default"] = launches
    emit(eval_row("default", argv, launches, seconds, stages, calls, card,
                  train_loss_by_epoch=losses, map_by_epoch=maps,
                  val_by_epoch=[h["val"] for h in history]))

    # --evaluate from its checkpoint: the rebuilt table, then a lookup
    # pickle written from it
    ev_argv = paths + ["--cache-dir", cache, "--resume", run_dir,
                       "--evaluate", "--device", "cuda"]
    cfg = config.parse(exe.PRESET + ev_argv)
    _, table = charades_ctc_next_pred.get_val_video(cfg)
    lookup = os.path.join(work, "groundtruth.p")
    save_groundtruth(lookup, table)
    printed = {}
    for label, extra in (("evaluate", []),
                         ("evaluate_lookup", ["--groundtruth-lookup",
                                              lookup])):
        metrics, launches, seconds, stages, calls, out = eval_run(
            exe.run, ev_argv + extra)
        check_launches(label, launches, expect_counts(noblank=(n_val, 0)))
        shown = printed_map(label, out)
        if extra and f"groundtruth lookup: {lookup} ({len(table)} " \
                "videos)" not in out:
            fail(f"eval {label}: no lookup line in {out!r}")
        if f"{shown:.4f}" != f"{metrics['video_mAP']:.4f}":
            fail(f"eval {label}: printed {shown}, metrics "
                 f"{metrics['video_mAP']}")
        all_launches[f"eval_{label}"] = launches
        emit(eval_row(label, ev_argv + extra, launches, seconds, stages,
                      calls, card, video_mAP=metrics["video_mAP"],
                      gt_videos=len(table), val_metrics={
                          k: metrics[k] for k in ("loss", "top1", "top5")}))
        printed[label] = metrics["video_mAP"]
    if printed["evaluate"] != printed["evaluate_lookup"]:
        fail(f"eval: rebuilt table mAP {printed['evaluate']}, lookup "
             f"{printed['evaluate_lookup']}")
    if abs(printed["evaluate"] - maps[-1]) > EVAL_MAP_ATOL:
        fail(f"eval: --evaluate mAP {printed['evaluate']}, last epoch's "
             f"{maps[-1]}")

    # ver2 binary: its 38-object head is scored on gt column 1
    cache = os.path.join(work, "eval_ver2")
    argv = CHARADES_GEOMETRY + ["--dataset", "charades_ver2", "--loss",
                                "binary"] + train_args + [
        "--cache-dir", cache, "--resume", os.path.join(cache, "fresh"),
        "--video-eval"]
    scored = []
    verb_map = video_mod.video_verb_map

    def spy(video_scores, gt_table, num_verbs, gt_col=2):
        scored.append((num_verbs, gt_col))
        return verb_map(video_scores, gt_table, num_verbs, gt_col)

    video_mod.video_verb_map = spy
    try:
        history, launches, seconds, stages, calls, out = eval_run(
            cli_main.main, argv)
    finally:
        video_mod.video_verb_map = verb_map
    t2, v2 = batches["features_ver2"]
    check_launches("ver2_binary", launches, expect_counts(
        noblank=((t2 + v2) * epochs, t2 * epochs)))
    maps = check_history("ver2_binary", history, os.path.join(cache, "test"))
    if scored != [(38, 1)] * epochs:
        fail(f"eval ver2_binary: scored (classes, gt column) {scored}")
    all_launches["eval_ver2_binary"] = launches
    emit(eval_row("ver2_binary", argv, launches, seconds, stages, calls,
                  card, train_loss_by_epoch=check_falls("ver2_binary",
                                                        history),
                  map_by_epoch=maps, scored_classes_gt_col=scored))

    # the joint (object, verb) head: trained with its per-epoch mAP, then
    # evaluated and decoded; each step runs rows 1-2 twice
    cache = os.path.join(work, "eval_joint")
    run_dir = os.path.join(cache, run_name)
    argv = train_args + ["--cache-dir", cache, "--loss", "joint",
                         "--resume", os.path.join(cache, "fresh"),
                         "--video-eval"]
    history, launches, seconds, stages, calls, out = eval_run(exe.run, argv)
    check_launches("joint", launches, expect_counts(
        noblank=(2 * (n_train + n_val) * epochs, 2 * n_train * epochs)))
    maps = check_history("joint", history, run_dir)
    losses = check_falls("joint", history)
    if out.count("relation mAP: ") != epochs:
        fail(f"eval joint: printed {out!r}")
    all_launches["eval_joint"] = launches
    emit(eval_row("joint", argv, launches, seconds, stages, calls, card,
                  train_loss_by_epoch=losses, map_by_epoch=maps))
    ev_argv = paths + ["--cache-dir", cache, "--resume", run_dir,
                       "--loss", "joint", "--evaluate", "--decode",
                       "--device", "cuda"]
    metrics, launches, seconds, stages, calls, out = eval_run(exe.run,
                                                              ev_argv)
    check_launches("joint_evaluate", launches,
                   expect_counts(noblank=(2 * n_val, 0)))
    cfg = config.parse(exe.PRESET + ev_argv)
    relation = [ln for ln in out.splitlines()
                if ln.startswith("relation tagging: mAP ")]
    printed_map("joint_evaluate", out)
    if cfg.head_classes != 71 or "object mAP" not in out or not relation:
        fail(f"eval joint_evaluate: head {cfg.head_classes}, printed "
             f"{out!r}")
    for key in ("video_mAP", "object_mAP", "relation_mAP"):
        if not metrics[key] == metrics[key]:
            fail(f"eval joint_evaluate: {key} {metrics[key]}")
    with open(metrics["decoded_csv"], newline="") as f:
        rows = list(csv.reader(f))[1:]
    ids = [int(c) for r in rows for c in r[3].split()]
    if len(rows) != n_val * CHARADES_BATCH or not ids or not all(
            0 <= c < cfg.v_class for c in ids):
        fail(f"eval joint_evaluate: {len(rows)} decoded rows, ids "
             f"{sorted(set(ids))}")
    all_launches["eval_joint_evaluate"] = launches
    emit(eval_row("joint_evaluate", ev_argv, launches, seconds, stages,
                  calls, card, video_mAP=metrics["video_mAP"],
                  object_mAP=metrics["object_mAP"],
                  relation_mAP=metrics["relation_mAP"],
                  relation_recall_at=metrics["relation_recall_at"],
                  relation_prec_at=metrics["relation_prec_at"],
                  relation_line=relation[0], decoded_rows=len(rows)))

    # the card against the CPU, from the default run's checkpoint
    cache = os.path.join(work, "eval_default")
    cfg = config.parse(exe.PRESET + paths + ["--cache-dir", cache])
    batch = cli_main.get_dataset(cfg)[1][0]
    emit({"phase": "eval", "run": "card_vs_cpu",
          **eval_vs_cpu(cfg, os.path.join(cache, run_name), batch),
          "nvidia_smi": card})
    return all_launches


# the trainer_features phase and the profile's graph rows: K steps as one
# CUDA graph (ctc_tpu_torch.train.graphs), held to the same steps run
# eagerly at ctc_tpu's own tolerance for its K-step scan
# (tests/test_trainer.py::test_steps_per_dispatch_matches_single_steps)
GRAPH_K = 8
GRAPH_RTOL, GRAPH_ATOL = 1e-5, 1e-6
# ...except feature_head.proj.bias and the BatchNorm running mean that
# carries it, at 2 lr an update: the bias's gradient is rounding noise
# (STEP_ZERO_GRAD_PARAMS), and the blank loss's emission gather adds the
# repeated blank slot's gradients by atomics, in no fixed order, so the
# noise, which Adam scales to steps of up to lr, differs from run to run
GRAPH_NOISE_CARRIERS = ("feature_head.proj.bias",
                        "feature_head.bn.running_mean")
GRAPH_LR = 1e-3  # the schedule's base rate in the graph cases
# a path whose eager steps do not repeat bit for bit is held to this many
# times their own run-to-run max |dev|: two eager runs of blank at seq 4
# differed by 3.6e-6 and 1.7e-5 in two smokes on an H100, the graph by
# 9.5e-6 and 1.6e-5; a graph that reused dropout masks or misread a count
# would move the parameters by ~1e-3
GRAPH_NOISE_FACTOR = 10
FEATURE_K = 4  # --steps-per-dispatch of the phase's CLI and Charades runs
FEATURE_FLAGS = ["--steps-per-dispatch", str(FEATURE_K), "--accum-grad", "2",
                 "--skip-nonfinite", "--grad-norm-freq", "2"]
# (label, loss, head, (T, B, L), seq microbatches, optimizer chain flags,
# batch indices given a NaN feature): each graph against eager case
GRAPH_CASES = (
    ("noblank", "noblank", 33, MAIN_SHAPE, None, {}, ()),
    ("blank", "blank", BLANK_CLASSES, BLANK_MAIN_SHAPE, None, {}, ()),
    ("noblank_seq4", "noblank", 33, SEQ_MAIN["noblank"][:3],
     SEQ_MAIN["noblank"][3], {}, ()),
    ("blank_seq4", "blank", BLANK_CLASSES, SEQ_MAIN["blank"][:3],
     SEQ_MAIN["blank"][3], {}, ()),
    ("skip_nonfinite", "noblank", 33, MAIN_SHAPE, None,
     {"skip_nonfinite": True}, (GRAPH_K + 3,)),
    ("accum_grad_2", "noblank", 33, MAIN_SHAPE, None,
     {"accum_grad": 2, "grad_norm_freq": 2}, ()),
)
PROFILE_WINDOWS = 5  # timed (and profiled) windows per mode, in turns
PROFILE_STEPS = GRAPH_K  # train steps a window: one graph replay
_LATTICE_NAME = None


def lattice_key(name: str):
    """The launch-count key (``noblank_lattice_forward``, ...) of a
    profiler kernel name, or None for a kernel outside the lattice."""
    import re

    global _LATTICE_NAME
    if _LATTICE_NAME is None:
        _LATTICE_NAME = re.compile(
            r"(?<![a-z])(noblank|blank)_(shard_)?(forward|backward)_kernel")
    m = _LATTICE_NAME.search(name)
    if m is None:
        return None
    return f"{m[1]}_{'shard' if m[2] else 'lattice'}_{m[3]}"


def profiled_launches(prof) -> dict:
    """Lattice kernel launches by key, from a profile's device events (a
    graph replay's kernels included)."""
    counts = expect_counts()
    for e in device_kernels(prof):
        key = lattice_key(e.key)
        if key:
            counts[key] += e.count
    return counts


def traced_launches(path) -> dict:
    """Lattice kernel launches by key in a Chrome trace file."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    counts = expect_counts()
    for e in events:
        if e.get("cat") == "kernel":
            key = lattice_key(e.get("name", ""))
            if key:
                counts[key] += 1
    return counts


def graph_state(loss, classes, microbatches, chain, *, dropout=0.3,
                schedule=None):
    """A full-width model, optimizer, train step and dropout generator on
    the card from fixed seeds."""
    import torch

    from ctc_tpu_torch.models import LSTMHead
    from ctc_tpu_torch.train.schedule import step_decay_schedule
    from ctc_tpu_torch.train.trainer import (
        TrainState, make_train_step, torch_style_adam,
    )

    model = LSTMHead(1024, classes, dropout_rate=dropout)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to("cuda")
    state = TrainState(model, torch_style_adam(model.parameters(), 1e-4,
                                               **chain))
    loss_fn = None
    if microbatches:
        from ctc_tpu_torch.parallel import (
            make_seq_mesh, make_seq_sharded_loss,
        )

        loss_fn = make_seq_sharded_loss(make_seq_mesh(SEQ_SHARDS, "cuda"),
                                        loss, num_microbatches=microbatches)
    # the learning rate falls tenfold every 4 updates: read on the card
    # from the optimizer's count
    step = make_train_step(loss, None, 0.0,
                           schedule or step_decay_schedule(GRAPH_LR, 1, 4),
                           loss_fn=loss_fn)
    gen = torch.Generator(device="cuda").manual_seed(0)
    return state, step, gen


def state_parts(state, rows) -> dict:
    """A train state and its per-step metrics as flat float64 tensors by
    part: metrics, parameters, the two noise carriers, BatchNorm
    statistics, Adam's moments."""
    import torch

    parts = {"metrics": [torch.tensor([list(r.values()) for r in rows])]}
    for name, t in state.model.state_dict().items():
        part = (name if name in GRAPH_NOISE_CARRIERS else
                "bn_stats" if "running" in name else "params")
        parts.setdefault(part, []).append(t)
    opt = state.optimizer
    parts["adam_moments"] = opt.exp_avg + opt.exp_avg_sq
    return {k: torch.cat([t.detach().double().cpu().flatten() for t in v])
            for k, v in parts.items()}


def graph_vs_eager(label, loss, classes, shape, microbatches, chain, nan_at):
    """Two groups of GRAPH_K full-width batches through one MultiStep (the
    first run eagerly as the capture's warm-up, the second one replay)
    against the same batches as eager steps, from the same weights and
    generator, dropout 0.3, and the eager steps once more; the replay's
    lattice launches from the profiler.  Each part is held to GRAPH_RTOL
    / GRAPH_ATOL (the noise carriers to 2 lr an update); where the eager
    steps themselves do not repeat (blank: the emission gather's backward
    adds the repeated blank slot's gradients by atomics, in no fixed
    order), to GRAPH_NOISE_FACTOR times their own run-to-run max |dev|.
    Returns the case's row."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ctc_tpu_torch.data import synthetic_feature_batches
    from ctc_tpu_torch.train.graphs import MultiStep, host_rows
    from ctc_tpu_torch.train.trainer import to_device

    T, B, L = shape
    bs = synthetic_feature_batches(num_batches=2 * GRAPH_K, batch_size=B,
                                   temporal=T, feat_dim=1024,
                                   num_classes=classes, max_path=L, seed=21)
    for i in nan_at:
        bs[i]["feats"] = bs[i]["feats"].copy()
        bs[i]["feats"][0, 0, 0] = np.nan
    out = {}
    for mode in ("graph", "eager", "eager_again"):
        state, step, gen = graph_state(loss, classes, microbatches, chain)
        rows = []
        if mode == "graph":
            multi = MultiStep(step, GRAPH_K, train=True, device="cuda",
                              generator=gen)
            rows += host_rows(multi(state, bs[:GRAPH_K]))
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                rows += host_rows(multi(state, bs[GRAPH_K:]))
                torch.cuda.synchronize()
            replay = profiled_launches(prof)
        else:
            for b in bs:
                state, m = step(state, to_device(b, "cuda"), gen)
                rows += host_rows({k: v[None] for k, v in m.items()})
        torch.cuda.synchronize()
        counts = {"step": int(state.step),
                  "count": int(state.optimizer.count),
                  "skipped": int(state.optimizer.skipped)}
        out[mode] = (state_parts(state, rows), counts, list(rows[0]))
    (pg, cg, kg), (pe, ce, ke), (pa, ca, _) = (out["graph"], out["eager"],
                                               out["eager_again"])
    if kg != ke or not cg == ce == ca:
        fail(f"trainer_features graph {label}: metric keys {kg} / {ke}, "
             f"counts {cg} / {ce} / {ca}")
    devs, noise = {}, {}
    for part, want in pe.items():
        rtol, atol = ((0.0, 2 * GRAPH_LR * ce["count"])
                      if part in GRAPH_NOISE_CARRIERS
                      else (GRAPH_RTOL, GRAPH_ATOL))
        finite = torch.isfinite(want)
        devs[part] = max_dev(pg[part][finite], want[finite])
        noise[part] = max_dev(pa[part][finite], want[finite])
        if torch.allclose(pg[part], want, rtol=rtol, atol=atol,
                          equal_nan=True):
            continue
        if torch.allclose(pa[part], want, rtol=rtol, atol=atol,
                          equal_nan=True) or (
                devs[part] > GRAPH_NOISE_FACTOR * noise[part]):
            fail(f"trainer_features graph {label}: {part} max |dev| "
                 f"{devs[part]} from eager (eager run to run "
                 f"{noise[part]})")
    per_step = 1 if microbatches is None else SEQ_SHARDS * microbatches
    want = expect_counts(**{(f"{loss}_shard" if microbatches else loss): (
        GRAPH_K * per_step, GRAPH_K * per_step)})
    if replay != want:
        fail(f"trainer_features graph {label}: the replay launched "
             f"{replay}, expected {want}")
    return {"case": label, "loss": loss, "head": classes,
            "shape_TBL": list(shape), "seq_microbatches": microbatches,
            "chain": chain, "nan_batches": list(nan_at), "k": GRAPH_K,
            "groups": 2, "dropout": 0.3, "counts": cg,
            "replay_lattice_launches": {k: v for k, v in replay.items()
                                        if v},
            "max_abs_dev": devs, "eager_run_to_run_max_abs_dev": noise}


class _FlakyLoader:
    """Batches that raise after ``after`` of them when iterated for epoch
    ``fail_epoch``."""

    def __init__(self, batches, fail_epoch, after):
        self.batches, self.fail_epoch, self.after = batches, fail_epoch, after
        self.iterations = 0

    def __iter__(self):
        epoch = self.iterations
        self.iterations += 1
        for i, b in enumerate(self.batches):
            if epoch == self.fail_epoch and i == self.after:
                raise RuntimeError("injected data failure")
            yield b


def fit_restarts(work):
    """Trainer.fit(max_restarts=1) at full width with K-step graphs, over a
    loader that raises in epoch 2 after one replayed group: the run
    restores epoch 1's checkpoint in place, replays on, and ends equal to
    a run that never failed (dropout off)."""
    import torch

    from ctc_tpu_torch.data import synthetic_feature_batches
    from ctc_tpu_torch.models import LSTMHead
    from ctc_tpu_torch.train import Trainer

    T, B, _ = MAIN_SHAPE
    bs = synthetic_feature_batches(num_batches=8, batch_size=B, temporal=T,
                                   feat_dim=1024, num_classes=33, seed=5)
    val = synthetic_feature_batches(num_batches=2, batch_size=B, temporal=T,
                                    feat_dim=1024, num_classes=33, seed=6)
    runs = {}
    for label, loader in (("flaky", _FlakyLoader(bs, 2, FEATURE_K)),
                          ("clean", bs)):
        tr = Trainer(LSTMHead(1024, 33, dropout_rate=0.0), lr=1e-3,
                     steps_per_epoch=8, print_freq=1000, device="cuda",
                     steps_per_dispatch=FEATURE_K,
                     cache_dir=os.path.join(work, f"restarts_{label}"))
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            state, history = tr.fit(loader, val, epochs=4, max_restarts=1)
        torch.cuda.synchronize()
        runs[label] = (state, history, out.getvalue(),
                       time.perf_counter() - t0,
                       len(tr.multi_step._captured))
    (sf, hf, of, secs, captures), (sc, hc, _, _, _) = (runs["flaky"],
                                                       runs["clean"])
    line = ("epoch 2 failed (RuntimeError: injected data failure); "
            "restored epoch 1, restart 1")
    if (len(hf) != 4 or line not in of
            or (int(sf.step), int(sc.step)) != (32, 32)):
        fail(f"trainer_features fit_restarts: {len(hf)} epochs, step "
             f"{int(sf.step)}, printed {of!r}")
    devs = {}
    for (name, a), b in zip(sf.model.state_dict().items(),
                            sc.model.state_dict().values()):
        rtol, atol = ((0.0, 2 * 1e-3 * int(sc.optimizer.count))
                      if name in GRAPH_NOISE_CARRIERS
                      else (GRAPH_RTOL, GRAPH_ATOL))
        if not torch.allclose(a, b, rtol=rtol, atol=atol):
            fail(f"trainer_features fit_restarts: {name} max |dev| "
                 f"{max_dev(a, b)} from the run that never failed")
        devs[name] = max_dev(a, b)
    return {"epochs": len(hf), "restart_line": line, "seconds": secs,
            "captures": captures,
            "train_loss_by_epoch": [h["train"]["loss"] for h in hf],
            "max_abs_dev_vs_clean_run": devs}


def phase_trainer_features(work, card, paths):
    """The one-card trainer features on the card at full width: K=8 steps
    as one CUDA graph against K eager steps (noblank, blank, both at
    --seq-parallel 4, with a NaN batch under --skip-nonfinite, and with
    --accum-grad 2); the CLI's synthetic run with --steps-per-dispatch 4
    --accum-grad 2 --skip-nonfinite --grad-norm-freq 2 --profile-dir (its
    trace holds the lattice kernels of each of epoch 0's batches);
    Trainer.fit(max_restarts=1) over a loader that raises; the reference's
    default Charades run with --steps-per-dispatch 4 against its K=1 run."""
    import torch

    from ctc_tpu_torch.cli import exe
    from ctc_tpu_torch.cli.main import main

    for case in GRAPH_CASES:
        t0 = time.perf_counter()
        row = graph_vs_eager(*case)
        emit({"phase": "trainer_features", "run": "graph_vs_eager", **row,
              "seconds": time.perf_counter() - t0, "nvidia_smi": card})

    cache = os.path.join(work, "features")
    trace_dir = os.path.join(work, "features_trace")
    argv = MAIN_ARGS + FEATURE_FLAGS + ["--profile-dir", trace_dir,
                                        "--cache-dir", cache]
    out = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        history = main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counted = read_counts()
    losses = [h["train"]["loss"] for h in history]
    if not (all(x == x and abs(x) < float("inf") for x in losses)
            and losses[-1] < losses[0]):
        fail(f"trainer_features cli: training losses {losses}")
    traces = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
    if len(traces) != 1:
        fail(f"trainer_features cli: trace files {traces}")
    traced = traced_launches(os.path.join(trace_dir, traces[0]))
    train_batches = 8  # the synthetic loader's, epoch 0 (the traced one)
    if traced != expect_counts(noblank=(train_batches, train_batches)):
        fail(f"trainer_features cli: the trace holds {traced}, expected "
             f"{train_batches} of each")
    norms = [ln for ln in out.getvalue().splitlines()
             if ln.startswith("step ") and ": global grad norm " in ln]
    # accumulation over 2 of 16 batches: 8 updates; the count before
    # each batch is even at 8 of them
    if [int(ln.split()[1][:-1]) for ln in norms] != [0, 0, 2, 2, 4, 4, 6, 6]:
        fail(f"trainer_features cli: grad-norm lines {norms}")
    # the Python counters tick at the warm-up group's launches and at the
    # capture (4 + 4 a pass), and at the eager val steps (2 a epoch)
    if counted != expect_counts(noblank=(2 * FEATURE_K + 4, 2 * FEATURE_K)):
        fail(f"trainer_features cli: counters {counted}")
    emit({"phase": "trainer_features", "run": "cli", "argv": argv,
          "seconds": seconds, "train_loss_by_epoch": losses,
          "val_loss_by_epoch": [h["val"]["loss"] for h in history],
          "step_s_host_avg": [h["train"]["time"] for h in history],
          "trace_file": traces[0], "traced_lattice_launches_epoch0": {
              k: v for k, v in traced.items() if v},
          "python_counters": {k: v for k, v in counted.items() if v},
          "grad_norm_lines": norms, "nvidia_smi": card})

    emit({"phase": "trainer_features", "run": "fit_restarts",
          **fit_restarts(work), "nvidia_smi": card})

    runs = {}
    for k in (FEATURE_K, 1):
        c = os.path.join(work, f"charades_k{k}")
        ch_argv = paths + ["--cache-dir", c, "--resume",
                           os.path.join(c, "fresh"), "--epochs",
                           str(CHARADES_EPOCHS), "--device", "cuda",
                           "--steps-per-dispatch", str(k)]
        buf = io.StringIO()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            hist = exe.run(ch_argv)
        torch.cuda.synchronize()
        runs[k] = (hist, time.perf_counter() - t0, read_counts(), ch_argv)
    (hk, secs_k, counted_k, argv_k), (h1, secs_1, counted_1, _) = (
        runs[FEATURE_K], runs[1])
    cols = ("loss", "top1", "top5")
    got = [[h[part][c] for part in ("train", "val") for c in cols]
           for h in hk]
    want = [[h[part][c] for part in ("train", "val") for c in cols]
            for h in h1]
    dev = max(abs(a - b) for ra, rb in zip(got, want)
              for a, b in zip(ra, rb))
    import numpy as np

    if len(got) != CHARADES_EPOCHS or not np.allclose(
            got, want, rtol=GRAPH_RTOL, atol=GRAPH_ATOL):
        fail(f"trainer_features charades: K={FEATURE_K} {got} vs K=1 {want}")
    emit({"phase": "trainer_features", "run": "charades_default",
          "argv": argv_k, "k": FEATURE_K, "by_epoch_k": got,
          "by_epoch_k1": want, "max_abs_dev": dev,
          "seconds": {"k": secs_k, "k1": secs_1},
          "python_counters": {"k": {k: v for k, v in counted_k.items() if v},
                              "k1": {k: v for k, v in counted_1.items()
                                     if v}},
          "nvidia_smi": card})


def phase_step_vs_cpu():
    """One train step on the card (kernels) against the same step on the
    CPU (plain lattice), from the same weights and batch, dropout off."""
    import numpy as np
    import torch

    from ctc_tpu_torch.data import synthetic_feature_batches
    from ctc_tpu_torch.models import LSTMHead
    from ctc_tpu_torch.train.trainer import (
        TrainState, make_train_step, to_device, torch_style_adam,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    T, B, _ = MAIN_SHAPE
    batch = synthetic_feature_batches(num_batches=1, batch_size=B,
                                      temporal=T, feat_dim=1024,
                                      num_classes=33, seed=3)[0]
    ref = LSTMHead(1024, 33, dropout_rate=0.0)
    ref.reset_parameters(torch.Generator().manual_seed(7))
    weights = {k: v.clone() for k, v in ref.state_dict().items()}
    lr = 1e-3
    out = {}
    for dev in ("cpu", "cuda"):
        model = LSTMHead(1024, 33, dropout_rate=0.0)
        model.load_state_dict(weights)
        model.to(dev)
        state = TrainState(model, torch_style_adam(model.parameters(), 1e-4))
        step = make_train_step("noblank", None, 0.0, lambda k: lr)
        state, m = step(state, to_device(batch, dev))
        out[dev] = ({k: float(v) for k, v in m.items()},
                    {k: v.detach().cpu() for k, v in
                     model.state_dict().items()})
    (m_cpu, p_cpu), (m_gpu, p_gpu) = out["cpu"], out["cuda"]
    if not np.isclose(m_gpu["loss"], m_cpu["loss"], rtol=STEP_LOSS_RTOL,
                      atol=0.0):
        fail(f"step loss card {m_gpu['loss']} vs cpu {m_cpu['loss']}")
    for k in ("top1", "top5"):
        if m_gpu[k] != m_cpu[k]:
            fail(f"step {k} card {m_gpu[k]} vs cpu {m_cpu[k]}")
    devs = {}
    for name, want in p_cpu.items():
        atol = 2 * lr if name in STEP_ZERO_GRAD_PARAMS else STEP_PARAM_ATOL
        check_close(f"step param {name}", p_gpu[name], want, 0.0, atol)
        devs[name] = max_dev(p_gpu[name], want)
    emit({"phase": "step_vs_cpu", "loss_cuda": m_gpu["loss"],
          "loss_cpu": m_cpu["loss"], "top1": m_gpu["top1"],
          "top5": m_gpu["top5"], "param_max_abs_dev": devs,
          "tolerance": {"loss_rtol": STEP_LOSS_RTOL,
                        "param_atol": STEP_PARAM_ATOL,
                        "zero_grad_param_atol": 2 * lr}})


def phase_profile(loss="noblank", classes=33, shape=MAIN_SHAPE,
                  microbatches=None):
    """Where a main-path train step's time goes: the step's wall time with
    a synchronize at the end, then a torch.profiler window over the same
    steps for device time by kernel and the device's busy share.  With
    ``microbatches``, the step runs the sequence-sharded loss over
    ``SEQ_SHARDS`` shards."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ctc_tpu_torch.data import synthetic_feature_batches
    from ctc_tpu_torch.models import LSTMHead
    from ctc_tpu_torch.ops.lattice_cuda import lattice_kernel_symbol
    from ctc_tpu_torch.train.trainer import (
        TrainState, make_train_step, to_device, torch_style_adam,
    )

    T, B, L = shape
    batch = to_device(synthetic_feature_batches(
        num_batches=1, batch_size=B, temporal=T, feat_dim=1024,
        num_classes=classes, max_path=L, seed=4)[0], "cuda")
    model = LSTMHead(1024, classes)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to("cuda")
    state = TrainState(model, torch_style_adam(model.parameters(), 1e-4))
    loss_fn = None
    if microbatches:
        from ctc_tpu_torch.parallel import (
            make_seq_mesh, make_seq_sharded_loss,
        )

        loss_fn = make_seq_sharded_loss(make_seq_mesh(SEQ_SHARDS, "cuda"),
                                        loss, num_microbatches=microbatches)
    step = make_train_step(loss, None, 0.0, lambda k: 1e-3, loss_fn=loss_fn)
    gen = torch.Generator(device="cuda").manual_seed(0)
    # 50 steps at T=10; 20 at T=64, where a profiled step holds ~2000
    # kernels and ~5000 host ops and reading the profile takes the time
    steps = 50 if T <= MAIN_SHAPE[0] and not microbatches else 20
    for _ in range(5):
        step(state, batch, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step(state, batch, gen)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    with count_calls() as calls, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(state, batch, gen)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3

    events = device_kernels(prof)
    device_ms = sum(dev_us(e) for e in events) / 1e3
    top = sorted(events, key=dev_us, reverse=True)[:10]
    symbol = lattice_kernel_symbol(loss)
    lattice_us = sum(dev_us(e) for e in events if symbol.search(e.key))
    emit({"phase": "profile", "loss": loss, "classes": classes,
          "shape_TBL": list(shape),
          "seq_shards": SEQ_SHARDS if microbatches else None,
          "seq_microbatches": microbatches,
          "step_ms": step_ms, "profiled_window_ms": window_ms,
          "device_ms_per_step": device_ms / steps if events else None,
          "device_busy_share": device_ms / window_ms if events else None,
          "kernels_per_step": sum(e.count for e in events) / steps,
          # the shard ops' torch-op epilogues (the plain path's): the
          # init-row gradients, and the final cell's gather (which the
          # unsharded NLL also runs)
          "init_row_grads_calls_per_step": calls["init_row_grads"] / steps,
          "gather_final_calls_per_step": calls["gather_final"] / steps,
          "lattice_us_per_step": lattice_us / steps,
          "top_device_kernels": [
              {"name": e.key[:80], "us_per_step": dev_us(e) / steps,
               "calls_per_step": e.count / steps} for e in top]})


def spread(values) -> dict:
    import statistics

    return {"median": statistics.median(values), "min": min(values),
            "max": max(values), "windows": len(values)}


def in_turns(modes, steps=PROFILE_STEPS):
    """Run each mode's ``fn(n)`` (n train steps) PROFILE_WINDOWS times in
    turns: first timed windows of ``steps`` (host clock to a
    synchronize), then windows of GRAPH_K steps under a profiler of CUDA
    activity only (host ops unrecorded, so the profiler's own host cost
    stays small); returns ``{mode: {step_ms, device_ms_per_step,
    device_busy_share, kernels_per_step}}``, each the median and spread
    over the windows."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    rows = {m: {"step_ms": [], "device_ms_per_step": [],
                "device_busy_share": [], "kernels_per_step": []}
            for m in modes}
    for _ in range(PROFILE_WINDOWS):
        for mode, fn in modes.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(steps)
            torch.cuda.synchronize()
            rows[mode]["step_ms"].append(
                (time.perf_counter() - t0) / steps * 1e3)
    for _ in range(PROFILE_WINDOWS):
        for mode, fn in modes.items():
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn(GRAPH_K)
                torch.cuda.synchronize()
                window_ms = (time.perf_counter() - t0) * 1e3
            # the profiler's raw device records (kernels and copies), read
            # without building its event tree, which at T=64 holds ~20000
            events = [e for e in prof.profiler.kineto_results.events()
                      if e.device_type() == torch.autograd.DeviceType.CUDA
                      and not e.is_user_annotation()]
            device_ms = sum(e.duration_ns() for e in events) / 1e6
            rows[mode]["device_ms_per_step"].append(device_ms / GRAPH_K)
            rows[mode]["device_busy_share"].append(device_ms / window_ms)
            rows[mode]["kernels_per_step"].append(len(events) / GRAPH_K)
    return {m: {k: spread(v) for k, v in r.items()} for m, r in rows.items()}


def phase_profile_graph(card, loss="noblank", classes=33, shape=MAIN_SHAPE,
                        microbatches=None):
    """The profile row's step (one device-resident batch, dropout 0.3) as
    eager steps and as K=8 steps in one CUDA graph, in turns in one
    process."""
    from ctc_tpu_torch.data import synthetic_feature_batches
    from ctc_tpu_torch.train.graphs import MultiStep
    from ctc_tpu_torch.train.trainer import to_device

    T, B, L = shape
    batch = to_device(synthetic_feature_batches(
        num_batches=1, batch_size=B, temporal=T, feat_dim=1024,
        num_classes=classes, max_path=L, seed=4)[0], "cuda")
    state, step, gen = graph_state(loss, classes, microbatches, {},
                                   schedule=lambda k: 1e-3)
    multi = MultiStep(step, GRAPH_K, train=True, device="cuda",
                      generator=gen)
    group = [batch] * GRAPH_K

    def eager(n):
        for _ in range(n):
            step(state, batch, gen)

    def graph(n):
        for _ in range(n // GRAPH_K):
            multi(state, group)

    t0 = time.perf_counter()
    eager(5)
    graph(2 * GRAPH_K)  # the warm-up group and the capture, then a replay
    turns = in_turns({"eager": eager, "graph": graph})
    emit({"phase": "profile_graph", "loss": loss, "classes": classes,
          "shape_TBL": list(shape),
          "seq_shards": SEQ_SHARDS if microbatches else None,
          "seq_microbatches": microbatches, "k": GRAPH_K,
          "steps_per_window": PROFILE_STEPS, **turns,
          "seconds": time.perf_counter() - t0, "nvidia_smi": card})


def phase_prefetch(card, shape=MAIN_SHAPE):
    """Host batches onto the card, in turns: eager steps on plain
    ``to_device`` (a pageable copy on the step's stream), eager steps on
    ``device_prefetch`` (pinned, a side stream, 2 ahead), and K=8 graph
    steps fed by the trainer's pinned staging; beside them the copy of one
    batch alone."""
    import itertools

    import torch

    from ctc_tpu_torch.data import synthetic_feature_batches
    from ctc_tpu_torch.data.loading import device_prefetch
    from ctc_tpu_torch.train.graphs import MultiStep
    from ctc_tpu_torch.train.trainer import to_device

    T, B, L = shape
    host = synthetic_feature_batches(num_batches=GRAPH_K, batch_size=B,
                                     temporal=T, feat_dim=1024,
                                     num_classes=33, max_path=L, seed=7)
    state, step, gen = graph_state("noblank", 33, None, {},
                                   schedule=lambda k: 1e-3)
    multi = MultiStep(step, GRAPH_K, train=True, device="cuda",
                      generator=gen)

    def plain(n):
        for b in itertools.islice(itertools.cycle(host), n):
            step(state, to_device(b, "cuda"), gen)

    def prefetched(n):
        batches = itertools.islice(itertools.cycle(host), n)
        for b in device_prefetch(batches, depth=2, device="cuda"):
            step(state, b, gen)

    def graph(n):
        for _ in range(n // GRAPH_K):
            multi(state, host)

    t0 = time.perf_counter()
    plain(3)
    prefetched(3)
    graph(2 * GRAPH_K)
    copy_ms = []
    for b in host:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        to_device(b, "cuda")
        torch.cuda.synchronize()
        copy_ms.append((time.perf_counter() - t0) * 1e3)
    nbytes = sum(v.nbytes for v in host[0].values())
    emit({"phase": "prefetch", "shape_TBL": list(shape),
          "batch_bytes": nbytes, "to_device_ms": spread(copy_ms),
          "to_device_GBps": nbytes / (min(copy_ms) * 1e-3) / 1e9,
          "k": GRAPH_K, "steps_per_window": PROFILE_STEPS,
          **in_turns({"eager_to_device": plain,
                      "eager_device_prefetch": prefetched,
                      "graph_host_batches": graph}),
          "seconds": time.perf_counter() - t0, "nvidia_smi": card})


@contextlib.contextmanager
def count_calls(names=("init_row_grads", "gather_final")):
    """Count calls of both families' ``init_row_grads`` and
    ``gather_final`` (the torch ops the shard ops' kernels fold in; the
    ops look them up in their module at each call) while the block runs;
    yields a dict of counts by name."""
    from ctc_tpu_torch.ops import blank_lattice_cuda as bl
    from ctc_tpu_torch.ops import lattice_cuda as lc

    calls = dict.fromkeys(names, 0)
    originals = {(mod, name): getattr(mod, name) for mod in (lc, bl)
                 for name in names}

    def counting(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    for (mod, name), fn in originals.items():
        setattr(mod, name, counting(name, fn))
    try:
        yield calls
    finally:
        for (mod, name), fn in originals.items():
            setattr(mod, name, fn)


def dev_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def device_kernels(prof):
    """Device-side kernels of a profile: CPU ops and annotation ranges
    carry the device time of what they launched, which would count it
    twice."""
    import torch

    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and dev_us(e) > 0]


DEVICE_WINDOWS = 5  # profiler windows per device time; the median is kept


def kernel_device_ms(fn, symbol, iters=20):
    """Device execution time of one launch of ``fn``'s kernel ``symbol``
    from the profiler (the CUDA-event time of back-to-back launches at a
    small shape is the host's launch rate instead): the mean launch of each
    of ``DEVICE_WINDOWS`` windows of ``iters`` launches, as the row fields
    ``kernel_device_ms`` (their median) and ``kernel_device_ms_min_max``.
    A window whose trace holds no record of the kernel (the tracer dropped
    it) is taken again, at most twice in all; None where none holds one."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    readings = []
    for _ in range(DEVICE_WINDOWS + 2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in device_kernels(prof) if symbol in e.key]
        if ev:
            readings.append(sum(dev_us(e) for e in ev)
                            / sum(e.count for e in ev) / 1e3)
        if len(readings) == DEVICE_WINDOWS:
            break
    if not readings:
        return {"kernel_device_ms": None, "kernel_device_ms_min_max": None,
                "device_windows": 0}
    return {"kernel_device_ms": statistics.median(readings),
            "kernel_device_ms_min_max": [min(readings), max(readings)],
            "device_windows": len(readings)}


def time_ms(fn, iters):
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_times(card, name):
    """Kernel and plain times in turns (plain, kernel, kernel, plain) at
    the main-path and bench shapes, with each kernel's bound."""
    import torch

    from ctc_tpu_torch.ops import lattice_cuda as lc

    gen = torch.Generator().manual_seed(1)
    rate = hbm_rate(name)
    result = {}
    for label, shape in (("main_path", MAIN_SHAPE), ("bench", BENCH_SHAPE)):
        T, B, L = shape
        em, inlen, tgt, cot = make_case(gen, shape, device="cuda")
        inlen, tgt = inlen.int(), tgt.int()
        alpha, _ = lc.noblank_alpha_kernel(em, inlen, tgt)
        cells = T * B * L
        fns = {
            "noblank_lattice_forward": (
                "noblank_forward_kernel",
                lambda: lc.noblank_alpha_kernel(em, inlen, tgt),
                lambda: lc.noblank_alpha_plain(em, tgt),
                # em in, alpha out, both length vectors in, nll out
                8 * cells + 12 * B,
                # max, sub, abs, exp, log1p, add, select, add
                8 * cells,
            ),
            "noblank_lattice_backward": (
                "noblank_backward_kernel",
                lambda: lc.noblank_grad_kernel(alpha, inlen, tgt, cot),
                lambda: lc.noblank_grad_plain(alpha, inlen, tgt, cot),
                # alpha in, g out, three [B] vectors in
                8 * cells + 12 * B,
                # two sigmoids (sub, exp, add, div), 2 selects, 4 mul, 3 add
                17 * cells,
            ),
        }
        iters = 200 if label == "main_path" else 50
        for kname, (symbol, kernel, plain, nbytes, nops) in fns.items():
            p1 = time_ms(plain, max(iters // 10, 3))
            k1 = time_ms(kernel, iters)
            k2 = time_ms(kernel, iters)
            p2 = time_ms(plain, max(iters // 10, 3))
            device = kernel_device_ms(kernel, symbol)
            bytes_ms = nbytes / rate * 1e3
            ops_ms = nops / FP32_PEAK * 1e3
            row = {
                "phase": "times", "kernel": kname, "shape": label,
                "shape_TBL": list(shape),
                "kernel_ms": (k1 + k2) / 2, "kernel_ms_runs": [k1, k2],
                **device,
                "plain_ms": (p1 + p2) / 2, "plain_ms_runs": [p1, p2],
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "bytes": nbytes, "operations": nops,
                "hbm_bytes_per_s": rate, "fp32_ops_per_s": FP32_PEAK,
                "library_ms": None, "launches_per_step": 1,
                "card": card,
            }
            if kname.endswith("backward"):
                row["backward_plan"] = list(lc.backward_plan(L))
            else:
                row["forward_plan"] = list(lc.forward_plan(L))
            emit(row)
            result[(kname, label)] = row
    return result


def phase_times_blank(card, name):
    """The blank kernels' and plain versions' times in turns at the
    main-path and bench shapes, each kernel's bound, and the yardstick:
    ``torch.nn.functional.ctc_loss`` on the same [T, B, 157] log-probs
    (forward; backward alone) beside the port's emission gather + kernels
    for the same work."""
    import torch
    import torch.nn.functional as F

    from ctc_tpu_torch.losses.blank import blank_emissions_and_skip, ctc_loss
    from ctc_tpu_torch.ops import blank_lattice_cuda as bl
    from ctc_tpu_torch.ops import lattice_cuda as lc

    gen = torch.Generator().manual_seed(5)
    rate = hbm_rate(name)
    result = {}
    for label, shape in (("main_path", BLANK_MAIN_SHAPE),
                         ("bench", BLANK_BENCH_SHAPE)):
        T, B, L = shape
        S = 2 * L + 1
        logits = torch.randn((T, B, BLANK_CLASSES), generator=gen)
        lp = torch.log_softmax(logits, dim=2).to("cuda")
        # distinct adjacent labels, every sample feasible at its length
        targets = torch.randint(1, BLANK_CLASSES, (B, L), generator=gen)
        targets[:, 1:] = torch.where(targets[:, 1:] == targets[:, :-1],
                                     targets[:, 1:] % (BLANK_CLASSES - 1) + 1,
                                     targets[:, 1:])
        targets = targets.to("cuda")
        inlen = torch.randint(min(2 * L + 1, T), T + 1, (B,), generator=gen)
        tgt = torch.randint(1, L + 1, (B,), generator=gen)
        inlen[0], tgt[0] = T, L
        inlen, tgt = inlen.int().to("cuda"), tgt.int().to("cuda")
        cot = torch.randn((B,), generator=gen).to("cuda")
        em, skip = blank_emissions_and_skip(lp, targets, 0)
        em, skip = em.contiguous(), skip.to(torch.uint8)
        alpha, _ = bl.blank_alpha_kernel(em, skip, inlen, tgt)
        cells = T * B * S
        # the yardstick on the same log-probs: forward, and backward alone
        lp_req = lp.clone().requires_grad_()
        lib_loss = F.ctc_loss(lp_req, targets, inlen, tgt, blank=0,
                              reduction="none")
        lib_sum = (lib_loss * cot).sum()
        iters = 200 if label == "main_path" else 50
        lib_fwd = time_ms(lambda: F.ctc_loss(lp, targets, inlen, tgt,
                                             blank=0, reduction="none"),
                          iters)
        lib_bwd = time_ms(lambda: torch.autograd.grad(lib_sum, lp_req,
                                                      retain_graph=True),
                          iters)
        nll_port = ctc_loss(lp, targets, inlen, tgt, normalize=False,
                            reduction="none")
        check_close(f"blank {label} port vs F.ctc_loss", nll_port,
                    lib_loss.detach(), 1e-4, 1e-4)

        def port_fwd():
            with torch.no_grad():
                ctc_loss(lp, targets, inlen, tgt, normalize=False,
                         reduction="none")

        def port_fwd_bwd():
            x = lp.clone().requires_grad_()
            (ctc_loss(x, targets, inlen, tgt, normalize=False,
                      reduction="none") * cot).sum().backward()

        def lib_fwd_bwd():
            x = lp.clone().requires_grad_()
            (F.ctc_loss(x, targets, inlen, tgt, blank=0, reduction="none")
             * cot).sum().backward()

        pair = {
            "port_fwd_ms": time_ms(port_fwd, iters),
            "library_fwd_ms": lib_fwd,
            "port_fwd_bwd_ms": time_ms(port_fwd_bwd, iters),
            "library_fwd_bwd_ms": time_ms(lib_fwd_bwd, iters),
            "library_bwd_ms": lib_bwd,
        }
        fns = {
            "blank_lattice_forward": (
                "blank_forward_kernel",
                lambda: bl.blank_alpha_kernel(em, skip, inlen, tgt),
                lambda: bl.blank_alpha_plain(em, skip),
                # em in, skip mask in, alpha out, both length vectors in,
                # nll out
                8 * cells + B * S + 12 * B,
                # two log-adds (max, sub, abs, exp, log1p, add), the skip
                # select, the emission add
                14 * cells,
                lib_fwd,
            ),
            "blank_lattice_backward": (
                "blank_backward_kernel",
                lambda: bl.blank_grad_kernel(alpha, skip, inlen, tgt, cot),
                lambda: bl.blank_grad_plain(alpha, skip, inlen, tgt, cot),
                # alpha in, g out, skip mask in, three [B] vectors in
                8 * cells + B * S + 12 * B,
                # three 3-way log-adds (2 x 6), three sub+exp weights, three
                # mul, two add, the inject select and add
                49 * cells,
                lib_bwd,
            ),
        }
        for kname, (symbol, kernel, plain, nbytes, nops, lib) in fns.items():
            p1 = time_ms(plain, max(iters // 10, 3))
            k1 = time_ms(kernel, iters)
            k2 = time_ms(kernel, iters)
            p2 = time_ms(plain, max(iters // 10, 3))
            device = kernel_device_ms(kernel, symbol)
            bytes_ms = nbytes / rate * 1e3
            ops_ms = nops / FP32_PEAK * 1e3
            row = {
                "phase": "times", "kernel": kname, "shape": label,
                "shape_TBL": list(shape), "S": S, "classes": BLANK_CLASSES,
                "kernel_ms": (k1 + k2) / 2, "kernel_ms_runs": [k1, k2],
                **device,
                "plain_ms": (p1 + p2) / 2, "plain_ms_runs": [p1, p2],
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "bytes": nbytes, "operations": nops,
                "hbm_bytes_per_s": rate, "fp32_ops_per_s": FP32_PEAK,
                "library_ms": lib,
                "library_call": ("F.ctc_loss forward" if kname.endswith(
                    "forward") else "F.ctc_loss backward alone"),
                **pair, "launches_per_step": 1, "card": card,
            }
            if kname.endswith("backward"):
                row["backward_plan"] = list(lc.backward_plan(S, True))
            else:
                row["forward_plan"] = list(lc.forward_plan(S, True))
            emit(row)
            result[(kname, label)] = row
    return result

def make_shard_case(gen, family, shape, *, rows, repeats=False,
                    zero_len=False, batch_slice=False):
    """One shard's operands on the card: em ``[t_s, B, W]`` (blank: the
    normalized gather of random logits, as the pipeline builds it; with
    ``batch_slice``, the second of four microbatches of a batch four times
    as wide, strided in B as the pipeline hands it to the op), the two
    init rows (``rows='shard0'``: shard 0's; else random rows with unreached
    cells at the sentinel), the uint8 skip mask (blank), shard-local input
    lengths below 1, inside the shard and above it, target lengths, and
    cotangents of both outputs."""
    import torch

    from ctc_tpu_torch.losses.blank import blank_emissions_and_skip
    from ctc_tpu_torch.ops import blank_lattice_cuda as bl
    from ctc_tpu_torch.ops import lattice_cuda as lc
    from ctc_tpu_torch.ops.logspace import BLANK_NEG, NEG_SENTINEL

    t_s, B, L = shape
    wide = 4 if batch_slice else 1
    skip = None
    if family == "noblank":
        width, neg = L, NEG_SENTINEL
        em = torch.randn((t_s, wide * B, L), generator=gen) - 1.0
        tgt = torch.randint(1, L + 1, (B,), generator=gen)
        init = lc.noblank_alpha_init(B, width)
    else:
        width, neg = 2 * L + 1, BLANK_NEG
        targets = torch.randint(1, BLANK_CLASSES, (B, L), generator=gen)
        if repeats:
            targets[:, 1::2] = targets[:, 0::2][:, : targets[:, 1::2].shape[1]]
        logits = torch.randn((t_s, wide * B, BLANK_CLASSES), generator=gen)
        targets = targets.repeat(wide, 1)
        if L:
            em, skip = blank_emissions_and_skip(logits, targets, 0,
                                                normalize=True)
        else:  # the blank slot alone (S = 1), which nothing skips into
            em = logits[:, :, :1] - torch.logsumexp(logits, 2, keepdim=True)
            skip = torch.zeros((wide * B, 1), dtype=torch.bool)
        skip = skip[:B].to(torch.uint8)
        tgt = torch.randint(0 if zero_len or not L else 1, L + 1, (B,),
                            generator=gen)
        init = bl.blank_alpha_init(B, width)
    inlen = torch.randint(-(t_s // 2), 2 * t_s + 1, (B,), generator=gen)
    inlen[0] = t_s
    if rows == "shard0":
        r0, r1 = init, torch.full_like(init, neg)
    else:
        r0, r1 = (3.0 * torch.randn((B, width), generator=gen) - 8.0
                  for _ in range(2))
        r0[::2, -2:] = neg
        r1[::2, -2:] = neg
    d_final = torch.randn((B,), generator=gen)
    d_boundary = torch.randn((B, width), generator=gen)
    em = em.to("cuda")
    out = {"em": em[:, B:2 * B] if batch_slice else em, "r0": r0, "r1": r1,
           "skip": skip,
           "inlen": inlen.int(), "tgt": tgt.int(), "d_final": d_final,
           "d_boundary": d_boundary,
           # the tensor em is a batch slice of, and the slice
           "em_base": em if batch_slice else None, "mb": slice(B, 2 * B)}
    return {k: (v.to("cuda") if isinstance(v, torch.Tensor) else v)
            for k, v in out.items()}


def shard_fns(family, c):
    """(forward kernel, forward plain, grad kernel, grad plain, op kernel,
    op plain) of one family, bound to the case ``c``'s operands; each
    forward returns ``(alpha, final, boundary)``."""
    from ctc_tpu_torch.ops import blank_lattice_cuda as bl
    from ctc_tpu_torch.ops import lattice_cuda as lc

    if family == "noblank":
        mod, tail = lc, (c["inlen"], c["tgt"])
    else:
        mod, tail = bl, (c["skip"], c["inlen"], c["tgt"])
    g_args = tail
    rows = (c["r0"], c["r1"])
    bars = (c["d_final"], c["d_boundary"])
    # the init rows' gradients: in the kernel's launch, torch ops after the
    # plain recursion
    init_tail = (c["tgt"],) if family == "noblank" else (c["skip"],)

    def grad_plain(alpha):
        g = getattr(mod, f"{family}_shard_grad_plain")(alpha, *g_args, *bars)
        return (g, *mod.init_row_grads(g[0], *rows, *init_tail))

    return {
        "forward_kernel": lambda: getattr(
            mod, f"{family}_shard_forward_kernel")(c["em"], *tail, *rows),
        "forward_plain": lambda: getattr(
            mod, f"{family}_shard_forward_plain")(c["em"], *tail, *rows),
        # (g, d init row 0, d init row 1)
        "grad_kernel": lambda alpha: getattr(
            mod, f"{family}_shard_grad_kernel")(alpha, *g_args, *bars,
                                                *rows),
        "grad_plain": grad_plain,
        "op_kernel": getattr(mod, f"{family}_shard_lattice_cuda"),
        "op_plain": getattr(mod, f"{family}_shard_lattice_plain"),
        "tail": tail,
    }


def seq_chain_inputs(gen, family, shape):
    """Inputs of the whole lattice at ``shape`` (T, B, L, M) on the card:
    noblank emissions ``[T, B, L]``, or blank logits ``[T, B, 157]`` with
    feasible targets; input and target lengths; a cotangent."""
    import torch

    T, B, L, _ = shape
    inlen = torch.randint(1, T + 1, (B,), generator=gen)
    inlen[0] = T
    if family == "noblank":
        x = torch.randn((T, B, L), generator=gen) - 1.0
        skip = None
        tgt = torch.minimum(torch.randint(1, L + 1, (B,), generator=gen),
                            inlen)
    else:
        # the normalized gather the pipeline's shards build, made once so
        # that both sides run their lattices on the same emissions
        from ctc_tpu_torch.losses.blank import blank_emissions_and_skip

        logits = torch.randn((T, B, BLANK_CLASSES), generator=gen)
        paths = torch.randint(1, BLANK_CLASSES, (B, L), generator=gen)
        x, skip = blank_emissions_and_skip(logits, paths, 0, normalize=True)
        x, skip = x.contiguous(), skip.to(torch.uint8)
        tgt = torch.minimum(torch.randint(0, L + 1, (B,), generator=gen),
                            (inlen - 1) // 2)
    cot = torch.randn((B,), generator=gen)
    return [v.to("cuda") if v is not None else None
            for v in (x, skip, inlen, tgt, cot)]


def blank_shard_chain(em, skip, inlen, tgt):
    """Per-sample NLL of em ``[T, B, S]`` through a chain of SEQ_SHARDS
    blank shard ops, each handing its boundary row to the next."""
    import torch

    from ctc_tpu_torch.ops import blank_lattice_cuda as bl
    from ctc_tpu_torch.ops import dispatch
    from ctc_tpu_torch.ops.logspace import BLANK_NEG

    t_s = em.shape[0] // SEQ_SHARDS
    init0 = bl.blank_alpha_init(em.shape[1], em.shape[2], device=em.device)
    rows, total = (init0, torch.full_like(init0, BLANK_NEG)), 0.0
    for k in range(SEQ_SHARDS):
        final, boundary = dispatch.blank_shard_lattice(
            em[k * t_s:(k + 1) * t_s], *rows, skip, inlen - k * t_s, tgt)
        rows, total = (boundary, boundary), total + final
    return -total


def backward_parity(f, c, alpha_k, alpha_p, tag):
    """The shard backward kernel against its plain version on the alphas
    of the case ``c``, and the autograd op's gradients (kernel path against
    plain path) with respect to em and both init rows; em enters the op as
    the batch slice ``c`` made it.  Returns the row's fields."""
    import torch

    g_k, g_p = f["grad_kernel"](alpha_k), f["grad_plain"](alpha_p)
    grads = {}
    for impl in ("op_kernel", "op_plain"):
        a, b = (c[k].clone().requires_grad_() for k in ("r0", "r1"))
        if c["em_base"] is None:
            leaf = e = c["em"].clone().requires_grad_()
        else:
            leaf = c["em_base"].clone().requires_grad_()
            e = leaf[:, c["mb"]]
        final, boundary = f[impl](e, a, b, *f["tail"])
        ((final * c["d_final"]).sum()
         + (boundary * c["d_boundary"]).sum()).backward()
        d_em = leaf.grad if c["em_base"] is None else leaf.grad[:, c["mb"]]
        grads[impl] = (d_em, a.grad, b.grad)
    torch.cuda.synchronize()
    for name, gk, gp in zip(("grad", "d init_row_0", "d init_row_1"),
                            g_k, g_p):
        check_close(f"{tag} {name}", gk, gp, GRAD_RTOL, GRAD_ATOL)
    op_dev = {}
    for name, gk, gp in zip(("em", "init_row_0", "init_row_1"),
                            grads["op_kernel"], grads["op_plain"]):
        check_close(f"{tag} autograd d {name}", gk, gp, GRAD_RTOL,
                    GRAD_ATOL)
        op_dev[name] = max_dev(gk, gp)
    return {"grad_max_abs_dev": max_dev(g_k[0], g_p[0]),
            "init_row_grad_max_abs_dev": [max_dev(g_k[1], g_p[1]),
                                          max_dev(g_k[2], g_p[2])],
            "autograd_grad_max_abs_dev": op_dev,
            "rtol_atol_grad": [GRAD_RTOL, GRAD_ATOL]}


def phase_parity_seq():
    """Each boundary kernel against its plain version on the card: the
    final log-prob, the reachable alpha cells, g, and the autograd op's
    gradients with respect to em and both init rows, at the main-path
    shard shape, the long-T shard shape and the edge cases; then a 4-shard
    kernel chain against the unsharded kernels on the same inputs."""
    import torch

    from ctc_tpu_torch.ops import dispatch
    from ctc_tpu_torch.parallel import (
        make_seq_mesh, make_seq_sharded_lattice_nll,
    )

    gen = torch.Generator().manual_seed(6)
    errs = {}
    for family in ("noblank", "blank"):
        T, B, L, M = SEQ_MAIN[family]
        lT, lB, lL, lM = SEQ_LONG[family]
        main_shard = (T // SEQ_SHARDS, B // M, L)
        # the shard backward's edges: T not a multiple of its 16-row alpha
        # chunk, T below it, the width where its plan drops to 4-row chunks
        # (noblank W 819, blank S 659, also wider than the 512-thread block),
        # and W = 1 (blank: L = 0); the shard forward's: T = 1 and T = 3
        # (below its 8-row em ring), the widest row of its warps layout
        # (noblank W 768, blank S 511) and the narrowest of its block
        # layout (W 769, S 513), the widest rows of the 8-row ring
        # (noblank W 5810, blank S 5669) and the first of the 2-row one
        # (W 5811, S 5671), forward only (the backward's plan refuses
        # them), and em as a batch slice of a wider batch
        boundary_l = 819 if family == "noblank" else 329
        depth_l = (5810, 5811) if family == "noblank" else (2834, 2835)
        cases = [
            ("main_path", main_shard, dict(rows="random")),
            ("main_path_shard0", main_shard, dict(rows="shard0")),
            ("long_T", (lT // SEQ_SHARDS, lB // lM, lL), dict(rows="random")),
            ("edges", (6, 16, 5), dict(rows="random", repeats=True,
                                       zero_len=True)),
            ("L1", (5, 4, 1), dict(rows="random")),
            ("T37", (37, 16, 12), dict(rows="random")),
            ("T3", (3, 16, 5), dict(rows="random")),
            ("plan_boundary", (6, 4, boundary_l), dict(rows="random")),
            ("W1", (5, 4, 1 if family == "noblank" else 0),
             dict(rows="random")),
            ("T1", (1, 16, 12), dict(rows="random")),
            ("strided_microbatch", main_shard,
             dict(rows="random", batch_slice=True)),
            ("warps_widest", (6, 4, 768 if family == "noblank" else 255),
             dict(rows="random")),
            ("block_narrowest", (6, 4, 769 if family == "noblank" else 256),
             dict(rows="random")),
            ("ring8_widest", (5, 2, depth_l[0]), dict(rows="random")),
            ("ring2_first", (5, 2, depth_l[1]), dict(rows="random")),
        ]
        forward_only = ("ring8_widest", "ring2_first")
        for label, shape, flags in cases:
            c = make_shard_case(gen, family, shape, **flags)
            f = shard_fns(family, c)
            fwd_k, fwd_p = f["forward_kernel"](), f["forward_plain"]()
            alpha_k, final_k, boundary_k = fwd_k
            alpha_p, final_p, boundary_p = fwd_p
            torch.cuda.synchronize()
            reach = alpha_p > (-1e12 if family == "noblank" else -1e29)
            tag = f"seq {family} {label}"
            check_close(f"{tag} final", final_k, final_p, LOSS_RTOL,
                        LOSS_ATOL)
            check_close(f"{tag} alpha", alpha_k[reach], alpha_p[reach],
                        LOSS_RTOL, LOSS_ATOL)
            check_close(f"{tag} boundary", boundary_k[reach[-1]],
                        boundary_p[reach[-1]], LOSS_RTOL, LOSS_ATOL)
            row = {"phase": "parity_seq", "family": family, "case": label,
                   "shard_shape_TBL": list(shape),
                   "width": int(c["em"].shape[2]),
                   "em_strides": list(c["em"].stride()),
                   "final_max_abs_dev": max_dev(final_k, final_p),
                   "alpha_reachable_max_abs_dev": max_dev(alpha_k[reach],
                                                          alpha_p[reach]),
                   "boundary_reachable_max_abs_dev": max_dev(
                       boundary_k[reach[-1]], boundary_p[reach[-1]]),
                   "rtol_atol_loss": [LOSS_RTOL, LOSS_ATOL]}
            if label not in forward_only:
                row.update(backward_parity(f, c, alpha_k, alpha_p, tag))
            emit(row)
            errs[(family, label)] = row
        # a 4-shard chain of the boundary kernels against the unsharded
        # kernels (rows 1-2, 5-6) on the same emissions: the same
        # operations in the same order, but for the order in which autograd
        # sums each boundary row's two cotangents
        mesh = make_seq_mesh(SEQ_SHARDS, "cuda")
        for label, shape in (("main_path", SEQ_MAIN[family]),
                             ("long_T", SEQ_LONG[family])):
            x, skip, inlen, tgt, cot = seq_chain_inputs(gen, family, shape)
            out = {}
            for impl in ("seq", "unsharded"):
                v = x.clone().requires_grad_()
                if family == "noblank" and impl == "seq":
                    nll = make_seq_sharded_lattice_nll(
                        mesh, mode="noblank",
                        num_microbatches=shape[3])(v, inlen, tgt)
                elif family == "noblank":
                    nll = dispatch.lattice_nll(v, inlen, tgt)
                elif impl == "seq":
                    nll = blank_shard_chain(v, skip, inlen, tgt)
                else:
                    nll = dispatch.blank_lattice_nll(v, skip, inlen, tgt)
                (nll * cot).sum().backward()
                out[impl] = (nll.detach(), v.grad)
            torch.cuda.synchronize()
            tag = f"seq chain {family} {label}"
            check_close(f"{tag} nll", out["seq"][0], out["unsharded"][0],
                        LOSS_RTOL, LOSS_ATOL)
            check_close(f"{tag} grad", out["seq"][1], out["unsharded"][1],
                        GRAD_RTOL, GRAD_ATOL)
            emit({"phase": "parity_seq_chain", "family": family,
                  "case": label, "shape_TBLM": list(shape),
                  "shards": SEQ_SHARDS,
                  "nll_max_abs_dev": max_dev(out["seq"][0],
                                             out["unsharded"][0]),
                  "grad_max_abs_dev": max_dev(out["seq"][1],
                                              out["unsharded"][1]),
                  "rtol_atol_loss": [LOSS_RTOL, LOSS_ATOL],
                  "rtol_atol_grad": [GRAD_RTOL, GRAD_ATOL]})
    return errs


def read_csv_rows(path):
    import csv

    with open(path, newline="") as f:
        return list(csv.reader(f))


def phase_main_path_seq(work):
    """The CLI's --seq-parallel 4 training runs on the card (noblank in 8
    microbatches, blank in the default 4), each through the boundary
    kernels only; then --evaluate --decode --seq-parallel 4 from the blank
    checkpoint against the unsharded --evaluate --decode.  Returns the
    launch counts by family."""
    import torch

    from ctc_tpu_torch.cli.main import main

    launches = {}
    for family, args in (("noblank", SEQ_NOBLANK_ARGS),
                         ("blank", SEQ_BLANK_ARGS)):
        cache = os.path.join(work, f"seq_{family}")
        reset_counts()
        t0 = time.perf_counter()
        with count_calls() as calls:
            history = main(args + ["--cache-dir", cache])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = read_counts()
        for name, n in calls.items():
            if n:
                fail(f"seq {family}: {name} ran {n} times on the kernel "
                     "path")
        epochs = len(history)
        train_steps, eval_steps = 8 * epochs, 2 * epochs  # the loader
        per_step = SEQ_SHARDS * SEQ_MAIN[family][3]
        want = expect_counts(**{f"{family}_shard": (
            per_step * (train_steps + eval_steps), per_step * train_steps)})
        if got != want:
            fail(f"seq {family} launch counts {got}, expected {want}")
        train_losses = [h["train"]["loss"] for h in history]
        if not all(x == x and abs(x) < float("inf") for x in train_losses):
            fail(f"non-finite seq {family} training loss {train_losses}")
        if not train_losses[-1] < train_losses[0]:
            fail(f"seq {family} training loss did not fall: {train_losses}")
        emit({"phase": "main_path_seq", "loss": family, "argv": args,
              "seconds": seconds, "train_steps": train_steps,
              "eval_steps": eval_steps, "launches": got,
              "init_row_grads_calls": calls["init_row_grads"],
              "gather_final_calls": calls["gather_final"],
              "train_loss_by_epoch": train_losses,
              "val_loss_by_epoch": [h["val"]["loss"] for h in history],
              "step_s_host_avg": [h["train"]["time"] for h in history]})
        launches[family] = got

    cache = os.path.join(work, "seq_blank")
    resume = ["--cache-dir", cache, "--evaluate", "--decode", "--resume",
              os.path.join(cache, "test")]
    rows = {}
    runs = (("sharded", SEQ_BLANK_ARGS,
             expect_counts(blank_shard=(SEQ_SHARDS * 4 * 2, 0))),
            ("unsharded", SEQ_COMMON + ["--loss", "blank"],
             expect_counts(blank=(2, 0))))
    for label, args, want in runs:
        reset_counts()
        t0 = time.perf_counter()
        metrics = main(args + resume)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = read_counts()
        if got != want:
            fail(f"seq decode {label}: launch counts {got}, expected {want}")
        rows[label] = read_csv_rows(metrics["decoded_csv"])
        emit({"phase": "decode_seq", "run": label, "seconds": seconds,
              "launches": got, "val_loss": metrics["loss"],
              "rows": len(rows[label]) - 1,
              "first_rows": rows[label][1:4]})
    if len(rows["sharded"]) - 1 != VAL_WINDOWS:
        fail(f"seq decode: {len(rows['sharded']) - 1} rows, expected "
             f"{VAL_WINDOWS}")
    if rows["sharded"] != rows["unsharded"]:
        fail("seq decode: the sharded rows differ from the unsharded ones")
    return launches


def phase_seq_vs_plain():
    """Three train steps at the main-path seq shape through the Trainer
    with and without seq_parallel=4, from the same seed (same weights, same
    dropout draws): the losses must agree."""
    import numpy as np
    import torch

    from ctc_tpu_torch.data import synthetic_feature_batches
    from ctc_tpu_torch.models import LSTMHead
    from ctc_tpu_torch.train.trainer import Trainer, to_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for family, classes in (("noblank", 33), ("blank", BLANK_CLASSES)):
        T, B, L, M = SEQ_MAIN[family]
        batches = synthetic_feature_batches(
            num_batches=3, batch_size=B, temporal=T, feat_dim=1024,
            num_classes=classes, max_path=L, seed=6)
        got = {}
        for label, seq in (("plain", {}),
                           ("seq", dict(seq_parallel=SEQ_SHARDS,
                                        seq_microbatches=M))):
            tr = Trainer(LSTMHead(1024, classes), loss_kind=family, lr=1e-3,
                         seed=0, device="cuda", **seq)
            state = tr.init_state()
            got[label] = []
            for b in batches:
                state, m = tr.train_step(state, to_device(b, "cuda"),
                                         tr.generator)
                got[label].append(float(m["loss"]))
        if not np.allclose(got["seq"], got["plain"], rtol=STEP_LOSS_RTOL,
                           atol=0.0):
            fail(f"seq vs plain {family}: {got}")
        emit({"phase": "seq_vs_plain", "loss": family,
              "shape_TBLM": [T, B, L, M], "loss_seq": got["seq"],
              "loss_plain": got["plain"],
              "max_rel_dev": float(np.max(np.abs(
                  np.subtract(got["seq"], got["plain"]))
                  / np.abs(got["plain"]))),
              "rtol": STEP_LOSS_RTOL})


def phase_times_seq(card, name):
    """The boundary kernels' and plain versions' times in turns at the
    main-path shard shape and the long-T shard shape, with each kernel's
    bound; and the whole sharded loss (forward, forward+backward) against
    the port's unsharded loss at the same global shapes."""
    import torch

    from ctc_tpu_torch import losses
    from ctc_tpu_torch.parallel import make_seq_mesh, make_seq_sharded_loss

    gen = torch.Generator().manual_seed(7)
    rate = hbm_rate(name)
    mesh = make_seq_mesh(SEQ_SHARDS, "cuda")
    result = {}
    for family in ("noblank", "blank"):
        for label, shape in (("main_path", SEQ_MAIN[family]),
                             ("long_T", SEQ_LONG[family])):
            T, B, L, M = shape
            shard = (T // SEQ_SHARDS, B // M, L)
            c = make_shard_case(gen, family, shard, rows="random")
            f = shard_fns(family, c)
            alpha = f["forward_kernel"]()[0]
            t_s, mb, width = c["em"].shape
            cells, row = t_s * mb * width, mb * width
            if family == "noblank":
                # em in, alpha out, two init rows and the two length
                # vectors in, final and the boundary row out; alpha in, g
                # out, g_seed, two init rows and three [B] vectors in, two
                # init-row gradients out
                fwd_bytes = 8 * cells + 12 * row + 12 * mb
                bwd_bytes = 8 * cells + 20 * row + 12 * mb
                # as rows 1-2, the init row as one more row of cells
                fwd_ops, bwd_ops = 8 * cells, 17 * (cells + row)
            else:
                # as above plus the [B, S] byte mask in each
                fwd_bytes = 8 * cells + 13 * row + 12 * mb
                bwd_bytes = 8 * cells + 21 * row + 12 * mb
                fwd_ops, bwd_ops = 14 * cells, 49 * (cells + row)
            fns = {
                f"{family}_shard_forward": (
                    f"{family}_shard_forward_kernel", f["forward_kernel"],
                    f["forward_plain"], fwd_bytes, fwd_ops),
                f"{family}_shard_backward": (
                    f"{family}_shard_backward_kernel",
                    lambda: f["grad_kernel"](alpha),
                    lambda: f["grad_plain"](alpha), bwd_bytes, bwd_ops),
            }
            iters = 200 if label == "main_path" else 20
            for kname, (symbol, kernel, plain, nbytes, nops) in fns.items():
                p1 = time_ms(plain, 3)
                k1 = time_ms(kernel, iters)
                k2 = time_ms(kernel, iters)
                p2 = time_ms(plain, 3)
                device = kernel_device_ms(kernel, symbol)
                device_ms = device["kernel_device_ms"]
                bytes_ms = nbytes / rate * 1e3
                ops_ms = nops / FP32_PEAK * 1e3
                row_out = {
                    "phase": "times", "kernel": kname, "shape": label,
                    "shard_shape_TBW": [t_s, mb, width],
                    "global_shape_TBLM": list(shape),
                    "kernel_ms": (k1 + k2) / 2, "kernel_ms_runs": [k1, k2],
                    **device,
                    # one dependent step of the recursion
                    "step_us": (device_ms * 1e3 / t_s
                                if device_ms is not None else None),
                    "plain_ms": (p1 + p2) / 2, "plain_ms_runs": [p1, p2],
                    "bound_ms": max(bytes_ms, ops_ms),
                    "bound_by": ("bytes" if bytes_ms >= ops_ms
                                 else "operations"),
                    "bytes": nbytes, "operations": nops,
                    "hbm_bytes_per_s": rate, "fp32_ops_per_s": FP32_PEAK,
                    # no PyTorch call runs a lattice shard from given init
                    # rows (F.ctc_loss takes none)
                    "library_ms": None,
                    "launches_per_step": SEQ_SHARDS * M, "card": card,
                }
                emit(row_out)
                result[(kname, label)] = row_out
            # the whole loss, sharded and unsharded, from logits
            classes = 33 if family == "noblank" else BLANK_CLASSES
            logits = torch.randn((T, B, classes), generator=gen).to("cuda")
            paths = torch.randint(1, classes, (B, L), generator=gen)
            inlen = torch.randint(T // 2, T + 1, (B,), generator=gen)
            tgt = torch.randint(1, L + 1, (B,), generator=gen)
            paths, inlen, tgt = (v.to("cuda") for v in (paths, inlen, tgt))
            seq_loss = make_seq_sharded_loss(mesh, family,
                                             num_microbatches=M)
            plain_loss = losses.LOSS_FNS[family]

            def fwd(fn):
                def run():
                    with torch.no_grad():
                        fn(logits, paths, inlen, tgt)
                return run

            def fwd_bwd(fn):
                def run():
                    x = logits.clone().requires_grad_()
                    fn(x, paths, inlen, tgt).backward()
                return run

            loss_iters = 50 if label == "main_path" else 10
            times = {}
            for key, fn in (("seq", seq_loss), ("unsharded", plain_loss)):
                times[f"{key}_fwd_ms"] = time_ms(fwd(fn), loss_iters)
                times[f"{key}_fwd_bwd_ms"] = time_ms(fwd_bwd(fn), loss_iters)
            emit({"phase": "times_seq_loss", "loss": family, "shape": label,
                  "shape_TBLM": list(shape), "classes": classes,
                  "shards": SEQ_SHARDS, **times, "card": card})
    return result


def probe_chunk(steps):
    """The carry-only variant's chunk: ``PROBE_CHUNK``, or all of T where
    T is shorter."""
    return min(PROBE_CHUNK, steps)


def probe_cases(shape, device):
    """The ten probe kernels at ``shape`` (T, B, L) on their entry points'
    inputs: name -> (kernel, plain, profiler symbol, bytes, operations,
    domain, library call or None, what the library call is or why there is
    none).  Off the bench shape three samples are outside everywhere, and
    the carry-only variant runs T cut to a multiple of its chunk
    (``probe_chunk``)."""
    import torch
    import torch.nn.functional as F

    from ctc_tpu_torch.ops import probe_cuda as pc
    from ctc_tpu_torch.ops.logspace import NEG_SENTINEL
    from ctc_tpu_torch.probes import expdomain_fwd, fwd_ops

    T, B, L = shape
    l_pad = pc.pad_rows(L)
    em = fwd_ops.make_inputs(T, B, L, device)
    ex, outside = expdomain_fwd.make_inputs(T, B, L, device)
    if shape != PROBE_SHAPE:
        outside[:, :3] = 1.0
    chunk = probe_chunk(T)
    t_cut = T - T % chunk
    em_cut = em[:t_cut]
    cells = T * l_pad * B  # the padded slab each step works on
    wide = 4 * cells  # one [T, L_PAD, B] f32 tensor
    pad = (0, 0, 0, l_pad - L)
    init = torch.full((l_pad, B), NEG_SENTINEL, device=device)
    init[0] = 0.0
    no_scan = ("null: no PyTorch call runs a recursion along T whose step "
               "mixes neighbouring label rows")
    library = {
        "copy": (lambda: F.pad(em, pad), "F.pad"),
        "add": (lambda: torch.cumsum(F.pad(em, pad), dim=0) + init,
                "F.pad, torch.cumsum and the init add (3 calls)"),
    }
    # f32 operations per padded cell, as each body does them
    body_ops = {"copy": 0, "add": 1, "roll": 3, "lse": 9, "lse_manual": 8,
                "lse_exp2": 7}
    cases = {}
    for body, ops in body_ops.items():
        lib, what = library.get(body, (None, no_scan))
        cases[f"probe_{body}"] = (
            lambda b=body: pc.probe_body(em, b),
            lambda b=body: pc.probe_body_plain(em, b),
            # em in, [T, L_PAD, B] out
            "fwd_ops_kernel", 4 * T * L * B + wide, ops * cells, "log",
            lib, what)
    cases["probe_noout"] = (
        lambda: pc.probe_noout(em_cut, chunk),
        lambda: pc.probe_noout_plain(em_cut, chunk),
        # em in, one [L_PAD, B] carry out per chunk
        "fwd_ops_kernel",
        4 * t_cut * L * B + 4 * (t_cut // chunk) * l_pad * B,
        9 * t_cut * l_pad * B, "log", None, no_scan)
    # em and the [L_PAD, B] mask in, [T, L_PAD, B] out
    row10_bytes = 2 * wide + 4 * l_pad * B
    cases["probe_fwd_log"] = (
        lambda: pc.probe_fwd_log(ex, outside),
        lambda: pc.probe_fwd_log_plain(ex, outside),
        # two shift selects, logaddexp (7), the outside select, the add
        "expdomain_kernel", row10_bytes, 11 * cells, "log", None, no_scan)
    cases["probe_fwd_exp"] = (
        lambda: pc.probe_fwd_exp(ex, outside),
        lambda: pc.probe_fwd_exp_plain(ex, outside),
        # exp, the shift select, add, multiply, the outside select
        "expdomain_kernel", row10_bytes, 5 * cells, "exp", None, no_scan)
    cases["probe_fwd_exp_renorm"] = (
        lambda: pc.probe_fwd_exp_renorm(ex, outside, PROBE_CHUNK),
        lambda: pc.probe_fwd_exp_renorm_plain(ex, outside, PROBE_CHUNK),
        # as exp, plus a max and a divide per cell once per chunk
        "expdomain_kernel", row10_bytes,
        5 * cells + 2 * (cells // PROBE_CHUNK), "exp", None, no_scan)
    return cases, em


def phase_probes(card, name):
    """Each probe kernel against its plain version on the card at the
    bench, the edge and the ring-edge shape (row 10 also past the ring),
    then its times in turns (plain, kernel, kernel, plain), its device
    time, its bound, its em ring depth (0: row 10's em read inside the
    step; 8 on a batch of whole 16-byte rows: filled by tensor copies) and,
    for copy and add, the PyTorch calls that compute the same function."""
    import torch

    from ctc_tpu_torch.ops import probe_cuda as pc

    rate = hbm_rate(name)
    result = {}
    for label, shape in (("bench", PROBE_SHAPE), ("edge", PROBE_EDGE),
                         ("ring_edge", PROBE_RING_EDGE),
                         ("past_ring", PROBE_PAST_RING)):
        cases, em = probe_cases(shape, "cuda")
        chunk = probe_chunk(shape[0])
        l_pad = pc.pad_rows(shape[2])
        if label == "past_ring":
            try:
                pc.probe_body(em, "copy")
            except ValueError:
                pass
            else:
                fail(f"probe_copy took L_PAD={l_pad}, past its em ring")
            cases = {k: case for k, case in cases.items()
                     if case[2] == "expdomain_kernel"}
        if shape[0] % chunk:
            try:
                pc.probe_noout(em, chunk)
            except ValueError:
                pass
            else:
                fail(f"probe_noout took T={shape[0]}, not a multiple of "
                     f"the chunk {chunk}")
        iters = 50 if label == "bench" else 200
        for kname, (kernel, plain, symbol, nbytes, nops, domain, lib,
                    lib_what) in cases.items():
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            atol = PROBE_ATOL[domain]
            check_close(f"probe {kname} {label}", got, want, PROBE_RTOL, atol)
            lib_ms = None
            if lib is not None:
                # the yardstick computes the same function (cumsum sums in
                # another order)
                check_close(f"probe {kname} {label} library", lib(), got,
                            1e-4, 1e-4)
                lib_ms = time_ms(lib, iters)
            p1 = time_ms(plain, 3)
            k1 = time_ms(kernel, iters)
            k2 = time_ms(kernel, iters)
            p2 = time_ms(plain, 3)
            device = kernel_device_ms(kernel, symbol)
            device_ms = device["kernel_device_ms"]
            bytes_ms = nbytes / rate * 1e3
            ops_ms = nops / FP32_PEAK * 1e3
            bound_ms = max(bytes_ms, ops_ms)
            t_run = (shape[0] - shape[0] % chunk if kname == "probe_noout"
                     else shape[0])
            row = {
                "phase": "probes", "kernel": kname, "shape": label,
                "shape_TBL": list(shape), "l_pad": l_pad,
                "T_run": t_run,
                "chunk": chunk if kname == "probe_noout" else PROBE_CHUNK,
                "ring_depth": (pc.expdomain_plan(
                    l_pad, kname[len("probe_fwd_"):])[0]
                    if symbol == "expdomain_kernel"
                    else pc.ring_plan(l_pad)[0]),
                "max_abs_dev": max_dev(got, want),
                "rtol_atol": [PROBE_RTOL, atol],
                "kernel_ms": (k1 + k2) / 2, "kernel_ms_runs": [k1, k2],
                **device,
                "step_us": (device_ms * 1e3 / t_run if device_ms is not None
                            else None),
                "plain_ms": (p1 + p2) / 2, "plain_ms_runs": [p1, p2],
                "bound_ms": bound_ms,
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "bound_share": (bound_ms / device_ms if device_ms else None),
                "bytes": nbytes, "operations": nops,
                "hbm_bytes_per_s": rate, "fp32_ops_per_s": FP32_PEAK,
                "library_ms": lib_ms, "library_call": lib_what,
                "card": card,
            }
            emit(row)
            result[(kname, label)] = row
    return result


def phase_probe_entry_points(probe_times):
    """Both probe entry points as a user runs them, each in a process of
    its own on the card: every variant's kernel launched in the run (one
    warm-up call and ``PROBE_ITERS`` timed calls per buffer set) and agrees
    with its plain version as closely as in phase ``probes`` on the same
    inputs.  Returns each kernel's row."""
    root = os.path.dirname(os.path.abspath(__file__))
    runs = {}
    for module, timed_runs in (("fwd_ops", 1), ("expdomain_fwd", 2)):
        argv = ["-m", f"ctc_tpu_torch.probes.{module}", "--iters",
                str(PROBE_ITERS)]
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, *argv], cwd=root,
                              capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"probe entry point {module} exited {proc.returncode}:\n"
                 f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        lines = proc.stdout.splitlines()
        rows = [json.loads(x) for x in lines if x.startswith("{")]
        want_launches = timed_runs * (PROBE_ITERS + 1)
        for row in rows:
            if row["launches"] != want_launches:
                fail(f"probe {module}: {row['kernel']} launched "
                     f"{row['launches']} times, expected {want_launches}")
            parity = probe_times[(row["kernel"], "bench")]["max_abs_dev"]
            if row["max_abs_dev"] is None or row["max_abs_dev"] > parity:
                fail(f"probe {module}: {row['kernel']} max |dev| "
                     f"{row['max_abs_dev']}, phase probes {parity}")
            runs[row["kernel"]] = row
        emit({"phase": "probe_entry", "module": module, "argv": argv,
              "seconds": seconds,
              "lines": [x for x in lines if not x.startswith("{")],
              "variants": rows})
    if set(runs) != set(PROBE_KERNELS):
        fail(f"probe entry points ran {sorted(runs)}, expected "
             f"{sorted(PROBE_KERNELS)}")
    return runs


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this needs a CUDA card")
    try:
        from ctc_tpu_torch.ops import blank_lattice_cuda  # noqa: F401
    except ImportError as e:
        fail(f"run from the repository root; ctc_tpu_torch not importable "
             f"({e})")
    name = torch.cuda.get_device_name(0)
    card = card_line()
    emit({"phase": "device", "name": name, "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    phase_build()
    errs = phase_parity()
    blank_errs = phase_parity_blank()
    seq_errs = phase_parity_seq()
    with tempfile.TemporaryDirectory() as work:
        noblank_cache = os.path.join(work, "noblank")
        blank_cache = os.path.join(work, "blank")
        launches = phase_main_path(noblank_cache)
        blank_launches = phase_main_path_blank(blank_cache)
        phase_decode(blank_cache, noblank_cache)
        seq_launches = phase_main_path_seq(work)
        charades_launches, corpus_paths, samples = phase_charades(work,
                                                                  card)
        charades_launches.update(phase_eval(work, card, corpus_paths,
                                            samples))
        phase_trainer_features(work, card, corpus_paths)
    phase_step_vs_cpu()
    phase_seq_vs_plain()
    phase_profile()
    phase_profile_graph(card)
    phase_profile("blank", BLANK_CLASSES, BLANK_MAIN_SHAPE)
    phase_profile_graph(card, "blank", BLANK_CLASSES, BLANK_MAIN_SHAPE)
    # the seq main-path step, and the unsharded step at the same shape
    for family, classes in (("noblank", 33), ("blank", BLANK_CLASSES)):
        T, B, L, M = SEQ_MAIN[family]
        phase_profile(family, classes, (T, B, L), microbatches=M)
        phase_profile_graph(card, family, classes, (T, B, L), microbatches=M)
        phase_profile(family, classes, (T, B, L))
        phase_profile_graph(card, family, classes, (T, B, L))
    # host batches onto the card: 10.5 MB a batch at T=10, 67 MB at T=64
    phase_prefetch(card)
    phase_prefetch(card, SEQ_MAIN["noblank"][:3])
    times = {**phase_times(card, name), **phase_times_blank(card, name),
             **phase_times_seq(card, name)}
    probe_times = phase_probes(card, name)
    probe_runs = phase_probe_entry_points(probe_times)
    kernels = []
    for kname, meta in KERNELS.items():
        t = times[(kname, "main_path")]
        family = kname.split("_")[0]
        if "_shard_" in kname:
            run_launches = seq_launches[family]
            err = seq_errs[(family, "main_path")]
            err = (max(err["final_max_abs_dev"],
                       err["alpha_reachable_max_abs_dev"],
                       err["boundary_reachable_max_abs_dev"])
                   if kname.endswith("forward") else err["grad_max_abs_dev"])
        else:
            run_launches = blank_launches if family == "blank" else launches
            main_errs = (blank_errs if family == "blank" else errs)[
                "main_path"]
            err = (main_errs["nll_max_abs_dev"] if kname.endswith("forward")
                   else main_errs["grad_max_abs_dev"])
        kernels.append({
            "name": kname, **meta,
            "launches": run_launches[kname],
            "max_abs_err": err,
            "ms": t["kernel_ms"], "device_ms": t["kernel_device_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            # the same kernel's launches in each Charades run
            "charades_launches": {run: n[kname] for run, n in
                                  charades_launches.items() if n[kname]},
        })
    # the probes' path is their entry points at the bench shape
    for kname, meta in PROBE_KERNELS.items():
        t = probe_times[(kname, "bench")]
        kernels.append({
            "name": kname, **meta,
            "launches": probe_runs[kname]["launches"],
            "max_abs_err": t["max_abs_dev"],
            "ms": t["kernel_ms"], "device_ms": t["kernel_device_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
