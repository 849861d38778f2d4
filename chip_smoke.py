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
of 4), trains over the data axis (two gloo ranks sharing the card against
one rank, one NCCL rank with its all-reduces in a K-step CUDA graph, four
class shards, 2 ranks x 4 seq shards, two CLI processes joined by
--num-hosts 2), runs pixels mode at full width on a corpus of JPEG frames
(the I3D in every step, frozen, finetuned, chunked and in bf16; feature
extraction; bf16 on the main path; step times, decode and copy), runs
the ST-graph model and criterion at full width through the blank lattice
kernels (card against CPU and against a float64 run, Adam steps, the
gradient tools, the step's times), holds the TF-same max pool kernels
against their plain version on the 13 pools' inputs of a frozen step and
times them beside their bound and ``F.max_pool3d`` (first, right after
the build; ``--only max_pool`` stops there), checks
that each run went through its kernels, profiles each train
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
import math
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


I3D_POOLS = 13  # max pools in one InceptionI3d forward


def pool_counts(forwards=0, backwards=0) -> dict:
    """The pool kernels' launches for ``forwards`` I3D forwards and
    ``backwards`` I3D backwards: one a pool each."""
    return {"max_pool3d_same_forward": I3D_POOLS * forwards,
            "max_pool3d_same_backward": I3D_POOLS * backwards}


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


# the pixels phase: the pixels model (the I3D in every step, then the LSTM
# head and the blank-free CTC loss, rows 1-2) at full width (224 x 224
# clips of 10 frames, 1024-d features, 33 verbs) and the reference
# geometry (batch 10, --temporal 10 --gap 2 --num-trans 2), on a
# Charades-format corpus of decodable JPEG frames (write_corpus(jpeg=True))
# whose depth is cut to 40 train and 10 val videos: 36 train and 10 val
# windows, 3 train batches and 1 val batch an epoch
PIXELS_VIDEOS = (40, 10)
PIXELS_EPOCHS = 2
PIXELS_CHUNK = 20
# (label, flags, epochs): the frozen default run, then one epoch of each
# variant
PIXELS_RUNS = (
    ("frozen", [], PIXELS_EPOCHS),
    ("finetune", ["--finetune-i3d"], 1),
    ("chunk", ["--i3d-chunk", str(PIXELS_CHUNK)], 1),
    ("bf16", ["--compute-dtype", "bf16", "--i3d-act-dtype", "bf16"], 1),
)
PIXELS_STAGES = {
    # a batch's decode and collate, timed in the prefetch thread
    "batch": [("ctc_tpu_torch.data.loaders._common", "LazyBatches.__getitem__")],
    "window_decode": [("ctc_tpu_torch.data.loaders.charades_pixels",
                       "load_window_native")],
    # the backbone's forwards, each launching the 13 pool kernels
    "i3d_forward": [("ctc_tpu_torch.models.i3d", "InceptionI3d.forward")],
}
EXTRACT_STAGES = {
    "extract_split": [("ctc_tpu_torch.data.loaders._common",
                       "extract_split_features")],
    "i3d_batches": [("ctc_tpu_torch.data.features",
                     "I3DFeatureExtractor.__call__")],
    "i3d_forward": [("ctc_tpu_torch.models.i3d", "InceptionI3d.forward")],
}
# f32 features, card (cuDNN, TF32 off) against the CPU: the JAX suite's
# bound for its I3D against the reference (tests/test_i3d.py)
PIXELS_FEAT_RTOL, PIXELS_FEAT_ATOL = 1e-3, 2e-4
# chunked against one-shot on the card: the same f32 convolutions, cuDNN
# free to pick another algorithm for a batch of 20 clips than of 100
PIXELS_CHUNK_RTOL, PIXELS_CHUNK_ATOL = 1e-4, 1e-5
# a finetune step (20 clips), the card's and the CPU's f32 step each
# against the exact one (float64): the loss; the backbone's SGD step, each
# tensor's max |dev| to 15% of its largest element and the median
# tensor's to 2%; its running statistics.  Batch statistics by E[x^2] -
# E[x]^2 (flax's) cancel on post-ReLU activations, so at full depth an f32
# step misses the exact one by up to 8.8% (card) and 10.0% (CPU) of a
# tensor's largest element, median 0.77% and 0.76% (this check's own
# readings, NVIDIA H100 80GB HBM3, 700 W); the bounds are 1.5x the worst
# tensor's reading and 2.6x the median's
PIXELS_STEP_LOSS_RTOL = 1e-4
PIXELS_BACKBONE_STEP_RTOL = 0.15
PIXELS_BACKBONE_STEP_MEDIAN_RTOL = 0.02
PIXELS_STATS_RTOL, PIXELS_STATS_ATOL = 1e-4, 1e-5
# bf16 against f32 on the card (tests/test_mixed_precision.py's bounds):
# the head rtol / atol 0.05, the I3D's features a relative deviation 0.1;
# a run's per-epoch losses rtol 0.05
BF16_HEAD_TOL = 0.05
BF16_I3D_REL = 0.1
BF16_LOSS_RTOL = 0.05


def pixels_paths(corpus) -> list:
    return ["--rgb-data", corpus["rgb_data"],
            "--train-file", corpus["train_file"],
            "--val-file", corpus["val_file"]]


def pixels_model(**kw):
    """The pixels model with the CLI's initial weights (seed 0)."""
    import torch

    from ctc_tpu_torch.models import I3DLSTM

    model = I3DLSTM(hidden=33, **kw)
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model


def pixels_cli_run(label, argv, stages):
    """One CLI run on the card with the counts and the peak memory reset
    before it and ``stages`` timed inside it; ``(history, (train, val)
    loaders, launches (the lattice kernels' and the pool kernels'),
    seconds, stage seconds, stage calls, peak bytes, printed text)``."""
    import torch

    from ctc_tpu_torch.cli import main as cli_main
    from ctc_tpu_torch.ops import max_pool as mp

    loaders = []
    get_dataset = cli_main.get_dataset

    def kept(cfg):
        loaders.append(get_dataset(cfg))
        return loaders[-1]

    cli_main.get_dataset = kept
    out = io.StringIO()
    try:
        with timed_stages(stages) as (seconds, calls), \
                contextlib.redirect_stdout(out):
            reset_counts()
            mp.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            history = cli_main.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {**read_counts(), **mp.launch_counts}
    finally:
        cli_main.get_dataset = get_dataset
    if len(loaders) != 1:
        fail(f"pixels {label}: get_dataset called {len(loaders)} times")
    if torch.backends.cudnn.allow_tf32:
        fail(f"pixels {label}: cuDNN TF32 left on by the CLI")
    return (history, loaders[0], launches, wall, dict(seconds), dict(calls),
            torch.cuda.max_memory_allocated(), out.getvalue())


def backbone_state(state_dict) -> dict:
    return {k: v for k, v in state_dict.items() if k.startswith("i3d.")}


def pixels_copy(batch) -> dict:
    """Host -> device copy of a pixel batch: MB, and ms pageable and from
    pinned memory (the host clock to a synchronize)."""
    import torch

    from ctc_tpu_torch.train.trainer import to_device

    feats = batch["feats"]
    out = {"mb": sum(v.nbytes for v in batch.values()) / 1e6,
           "feats_shape": list(feats.shape)}
    for mode in ("pageable", "pinned"):
        times = []
        for _ in range(3):
            if mode == "pinned":
                host = {k: torch.from_numpy(v).pin_memory()
                        for k, v in batch.items()}
            else:
                host = batch
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dev = to_device(host, "cuda")
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            del dev
        out[f"{mode}_ms"] = spread(times)
    return out


def pixels_step_times(batch):
    """The pixels train step on one device-resident batch (B=10, T=10):
    frozen and finetune, f32 and bf16 (``--compute-dtype bf16
    --i3d-act-dtype bf16``), eager and as K=2 steps in one CUDA graph;
    each mode's device ms a step (profiler) and peak memory, and the I3D's
    share of the device ms: 1 - the device ms of the head's step on
    features of the batch's shape (the same head, loss and optimizer) /
    the pixels step's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ctc_tpu_torch.models import LSTMHead
    from ctc_tpu_torch.train import Trainer
    from ctc_tpu_torch.train.graphs import MultiStep
    from ctc_tpu_torch.train.trainer import to_device

    dev_batch = to_device(batch, "cuda")

    def timed(fn, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(n)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    def trainer_for(model, pixels):
        tr = Trainer(model, device="cuda", lr=1e-3, weight_decay=1e-4,
                     i3d_optimizer=(
                         {"lr": 1e-3, "momentum": 0.9,
                          "weight_decay": 1e-4,
                          "finetune": not model.freeze_backbone}
                         if pixels else None))
        return tr, tr.init_state()

    total = torch.cuda.get_device_properties(0).total_memory
    b, t = batch["feats"].shape[:2]
    feats = {**dev_batch, "feats": torch.randn((b, t, 1024),
                                               device="cuda")}
    head_tr, head_state = trainer_for(LSTMHead(1024, 33), False)

    def head_steps(n):
        for _ in range(n):
            head_tr.train_step(head_state, feats, head_tr.generator)

    def device_ms(fn):
        """Device ms a step of ``fn(2)`` (two steps) under the profiler,
        the window's host ms, and the kernels a step."""
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn(2)
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.profiler.kineto_results.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA
                  and not e.is_user_annotation()]
        return (sum(e.duration_ns() for e in events) / 1e6 / 2, window_ms,
                len(events) / 2)

    head_steps(3)
    head_ms = timed(head_steps, 10)
    head_device_ms = device_ms(head_steps)[0]
    rows = {}
    for finetune in (False, True):
        for dtype in ("f32", "bf16"):
            bf16 = dtype == "bf16"
            model = pixels_model(
                freeze_backbone=not finetune,
                i3d_dtype=torch.bfloat16 if bf16 else None,
                i3d_act_dtype=torch.bfloat16 if bf16 else None)
            torch.cuda.reset_peak_memory_stats()
            tr, state = trainer_for(model, True)

            def eager(n, tr=tr, state=state):
                for _ in range(n):
                    tr.train_step(state, dev_batch, tr.generator)

            eager(2)
            eager_ms = [timed(eager, 1) for _ in range(3)]
            eager_peak = torch.cuda.max_memory_allocated()
            dev_ms, window_ms, kernels = device_ms(eager)
            # a K=2 graph holds a step's activations in a pool of its
            # own beside the eager run's cached blocks: run it where both
            # fit the card
            fits = 2 * eager_peak < 0.9 * total
            graph_ms = None
            if fits:
                multi = MultiStep(tr.train_step, 2, train=True,
                                  device="cuda", generator=tr.generator)

                def graph(n, multi=multi, state=state):
                    for _ in range(n // 2):
                        multi(state, [dev_batch, dev_batch])

                torch.cuda.empty_cache()
                graph(4)  # the warm-up group and the capture, a replay
                graph_ms = spread([timed(graph, 2) for _ in range(3)])
                del multi, graph
            label = f"{'finetune' if finetune else 'frozen'}_{dtype}"
            rows[label] = {
                "eager_step_ms": spread(eager_ms),
                "graph_k2_step_ms": (graph_ms if fits else
                                     "not run: twice the eager peak does "
                                     "not fit 90% of the card"),
                "device_ms_per_step": dev_ms,
                "device_busy_share": dev_ms * 2 / window_ms,
                "kernels_per_step": kernels,
                "i3d_share": 1.0 - head_device_ms / dev_ms,
                "peak_bytes_eager": eager_peak,
                "peak_bytes_with_graph": torch.cuda.max_memory_allocated(),
            }
            del tr, state, model
            torch.cuda.empty_cache()
    return {"head_step_ms": head_ms, "head_device_ms_per_step":
            head_device_ms, "modes": rows}


def pixels_step_vs_cpu(batch, card):
    """One finetune train step on the first train batch's first 2 windows
    (20 clips; the CPU takes seconds a clip), same weights, dropout off:
    the Trainer's f32 step on the card and on the CPU, each held to the
    exact step, and to each other.  The exact step is the same forward and
    backward in float64 on the card (``.double()``, activations f64), its
    loss in f32 through the lattice kernel (which takes f32 only; the
    logits' rounding is 1e-7 relative, far below the f32 batch statistics'
    error), and SGD's first update ``-lr (g + wd p)`` from its gradient.
    Prints the readings, then fails on any beyond its bound."""
    import numpy as np
    import torch

    from ctc_tpu_torch.losses import LOSS_FNS
    from ctc_tpu_torch.train import Trainer
    from ctc_tpu_torch.train.trainer import to_device

    lr, wd = 1e-3, 1e-4
    small = {k: v[:2] for k, v in batch.items()}
    out, seconds = {}, {}
    for dev in ("cpu", "cuda"):
        model = pixels_model(freeze_backbone=False, dropout_rate=0.0)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        tr = Trainer(model, device=dev, lr=lr, weight_decay=wd,
                     i3d_optimizer={"lr": lr, "momentum": 0.9,
                                    "weight_decay": wd, "finetune": True})
        state = tr.init_state(before)
        t0 = time.perf_counter()
        _, m = tr.train_step(state, to_device(small, dev), tr.generator)
        out[dev] = (float(m["loss"]), {k: v.detach().cpu() for k, v in
                                       model.state_dict().items()})
        seconds[dev] = time.perf_counter() - t0
    t0 = time.perf_counter()
    exact = pixels_model(freeze_backbone=False, dropout_rate=0.0,
                         i3d_act_dtype=torch.float64).double().to("cuda")
    dev_batch = to_device(small, "cuda")
    logits = exact(dev_batch["feats"].double(), train=True)
    loss = LOSS_FNS["noblank"](logits.float(), dev_batch["paths"],
                               dev_batch["input_lengths"],
                               dev_batch["target_lengths"])
    loss.backward()
    ref = {k: v.detach().cpu() for k, v in exact.state_dict().items()}
    params = dict(exact.named_parameters())
    ref_step = {k: (-lr * (p.grad + wd * p)).detach().cpu()
                for k, p in params.items() if k.startswith("i3d.")}
    torch.cuda.synchronize()
    seconds["cuda_f64"] = time.perf_counter() - t0
    l_ref = float(loss.detach())
    del exact, logits, loss, params
    torch.cuda.empty_cache()

    def rel_steps(after, other_step=None):
        """Each backbone tensor's max |dev| of the step from the exact
        (or ``other_step``'s), over the exact step's largest element."""
        devs = {}
        for k, want in ref_step.items():
            step = (after[k] - before[k]).double()
            other = want if other_step is None else other_step[k]
            devs[k] = max_dev(step, other) / max(float(want.abs().max()),
                                                 1e-30)
        return devs

    result = {"clips": int(np.prod(small["feats"].shape[:2])),
              "seconds": seconds, "loss_exact": l_ref}
    faults = []
    for dev in ("cuda", "cpu"):
        loss_, state = out[dev]
        if not np.isclose(loss_, l_ref, rtol=PIXELS_STEP_LOSS_RTOL,
                          atol=0.0):
            faults.append(f"pixels step loss {dev} {loss_} vs exact {l_ref}")
        worst_stats = 0.0
        for k, want in ref.items():
            if k.startswith("i3d.") and "running" in k:
                got = state[k].double()
                if not torch.allclose(got, want, rtol=PIXELS_STATS_RTOL,
                                      atol=PIXELS_STATS_ATOL):
                    faults.append(f"pixels step {dev} {k} vs exact: max "
                                  f"|dev| {max_dev(got, want)}")
                worst_stats = max(worst_stats, max_dev(got, want))
        steps = rel_steps(state)
        worst = max(steps, key=steps.get)
        median = float(np.median(list(steps.values())))
        result[dev] = {"loss": loss_,
                       "backbone_step_max_rel_dev": steps[worst],
                       "backbone_step_max_rel_dev_at": worst,
                       "backbone_step_median_rel_dev": median,
                       "backbone_stats_max_abs_dev": worst_stats}
        if (steps[worst] > PIXELS_BACKBONE_STEP_RTOL
                or median > PIXELS_BACKBONE_STEP_MEDIAN_RTOL):
            faults.append(f"pixels step: {dev} SGD step vs exact part by "
                          f"{steps[worst]} ({worst}), median {median}")
    (_, s_cpu), (_, s_gpu) = out["cpu"], out["cuda"]
    cpu_step = {k: (s_cpu[k] - before[k]).double() for k in ref_step}
    between = rel_steps(s_gpu, cpu_step)
    worst = max(between, key=between.get)
    result["cuda_vs_cpu"] = {
        "backbone_step_max_rel_dev": between[worst],
        "backbone_step_max_rel_dev_at": worst,
        "backbone_step_median_rel_dev": float(np.median(
            list(between.values()))),
        "head_param_max_abs_dev": max(
            max_dev(s_gpu[k], s_cpu[k]) for k in s_cpu
            if not k.startswith("i3d.") and "running" not in k
            and not k.endswith("num_batches_tracked"))}
    result["tolerance"] = {
        "loss_rtol": PIXELS_STEP_LOSS_RTOL,
        "backbone_step_rtol": PIXELS_BACKBONE_STEP_RTOL,
        "backbone_step_median_rtol": PIXELS_BACKBONE_STEP_MEDIAN_RTOL,
        "stats_rtol_atol": [PIXELS_STATS_RTOL, PIXELS_STATS_ATOL]}
    emit({"phase": "pixels_step_vs_cpu", **result, "nvidia_smi": card})
    if faults:
        fail("; ".join(faults))


def pixels_bf16_vs_f32(batch):
    """bf16 against f32 on the card, module by module: the LSTM head
    (``dtype=bf16``) on 1024-d features of the batch's shape, and the
    I3D's features (``dtype=act_dtype=bf16``) of the batch's first 2
    windows."""
    import numpy as np
    import torch

    from ctc_tpu_torch.models import InceptionI3d, LSTMHead

    b, t = batch["feats"].shape[:2]
    x = torch.randn((t, b, 1024), generator=torch.Generator().manual_seed(3))
    head = LSTMHead(1024, 33, dtype=torch.bfloat16)
    head.reset_parameters(torch.Generator().manual_seed(0))
    f32 = LSTMHead(1024, 33)
    f32.load_state_dict(head.state_dict())
    i3d = InceptionI3d(num_classes=None, dtype=torch.bfloat16,
                       act_dtype=torch.bfloat16)
    i3d.reset_parameters(torch.Generator().manual_seed(0))
    i3d32 = InceptionI3d(num_classes=None)
    i3d32.load_state_dict(i3d.state_dict())
    clips = torch.from_numpy(batch["feats"][:2]).to("cuda")
    with torch.no_grad():
        h16 = head.to("cuda")(x.to("cuda"), train=False)
        h32 = f32.to("cuda")(x.to("cuda"), train=False)
        f16 = i3d.to("cuda")(clips).float()
        f32_ = i3d32.to("cuda")(clips)
    if h16.dtype != torch.float32:
        fail(f"bf16 head output dtype {h16.dtype}")
    check_close("bf16 head vs f32", h16, h32, BF16_HEAD_TOL, BF16_HEAD_TOL)
    rel = max_dev(f16, f32_) / float(f32_.abs().max())
    if not (bool(torch.isfinite(f16).all()) and rel < BF16_I3D_REL):
        fail(f"bf16 I3D features vs f32: relative deviation {rel}")
    return {"head_max_abs_dev": max_dev(h16, h32),
            "i3d_feature_rel_dev": rel,
            "bounds": {"head_rtol_atol": BF16_HEAD_TOL,
                       "i3d_rel": BF16_I3D_REL}}


def phase_pixels(work, card):
    """Pixels mode on the card at full width: write the JPEG corpus; the
    frozen charades_pixels CLI run (rows 1-2 launched as the loader
    implies, the loss falls, the backbone bit for bit unchanged),
    --finetune-i3d (the backbone moves; one step on the card and on the
    CPU, each held to the exact float64 step), --i3d-chunk 20 (and
    chunked against one-shot), --compute-dtype bf16 --i3d-act-dtype bf16;
    the extraction run (charades_ctc_next_pred
    without --features-dir: features against the CPU's, the cache read on
    a rerun); --compute-dtype bf16 on the synthetic main path against
    f32; then the step times, the decode and the copy.  Returns ``{run:
    launch counts}``."""
    import numpy as np
    import torch

    from ctc_tpu_torch.data import native_loader
    from ctc_tpu_torch.data.charades_corpus import write_corpus
    from ctc_tpu_torch.data.loaders._common import filter_samples
    from ctc_tpu_torch.data.loaders.charades_ctc_next_pred import _prepared
    from ctc_tpu_torch import config
    from ctc_tpu_torch.data.features import (
        I3DFeatureExtractor,
        extract_split_features,
    )

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    root = os.path.join(work, "pixels_corpus")
    corpus = write_corpus(root, seed=0, train_videos=PIXELS_VIDEOS[0],
                          val_videos=PIXELS_VIDEOS[1], jpeg=True)
    write_s = time.perf_counter() - t0
    decoder = native_loader.decoder()
    emit({"phase": "pixels_corpus", "seconds": write_s,
          "videos": list(PIXELS_VIDEOS), "samples": {
              k: corpus["samples"][k] for k in ("features_train",
                                                "features_val")},
          "decoder": decoder, "native_build_error": native_loader.build_error,
          "nvidia_smi": card})
    paths = pixels_paths(corpus)
    all_launches = {}
    first_batch = None
    for label, flags, epochs in PIXELS_RUNS:
        cache = os.path.join(work, f"pixels_{label}")
        argv = (CHARADES_GEOMETRY + ["--dataset", "charades_pixels"] + paths
                + ["--cache-dir", cache, "--epochs", str(epochs),
                   "--device", "cuda"] + flags)
        (history, (train, val), launches, wall, stages, calls, peak,
         printed) = pixels_cli_run(label, argv, PIXELS_STAGES)
        n_train, n_val = len(train), len(val)
        # one backbone forward a batch (the chunk run one a chunk of a
        # batch's clips, so more), its pools' backward in each finetune
        # train step
        forwards = calls["i3d_forward"]
        run_batches = (n_train + n_val) * epochs
        if forwards < run_batches or (
                (forwards > run_batches) != (label == "chunk")):
            fail(f"pixels {label}: {forwards} I3D forwards for "
                 f"{run_batches} batches")
        want = {**expect_counts(noblank=(run_batches, n_train * epochs)),
                **pool_counts(forwards, n_train * epochs
                              if label == "finetune" else 0)}
        if launches != want:
            fail(f"pixels {label}: launch counts {launches}, expected "
                 f"{want}")
        if f"JPEG decoder: {decoder}" not in printed:
            fail(f"pixels {label}: no 'JPEG decoder: {decoder}' line")
        losses = [h["train"]["loss"] for h in history]
        if not all(np.isfinite(losses)) or len(losses) != epochs:
            fail(f"pixels {label}: training losses {losses}")
        if label == "frozen" and not losses[-1] < losses[0]:
            fail(f"pixels frozen: training loss did not fall: {losses}")
        ckpt = torch.load(os.path.join(cache, "test", "ckpt",
                                       f"{epochs - 1}.pt"),
                          map_location="cpu", weights_only=True)
        init = backbone_state(pixels_model().state_dict())
        got = backbone_state(ckpt["model"])
        unchanged = all(torch.equal(got[k], v) for k, v in init.items())
        if unchanged == (label == "finetune"):
            fail(f"pixels {label}: backbone "
                 f"{'unchanged' if unchanged else 'moved'}")
        if first_batch is None:
            first_batch = train[0]
        batches = calls["batch"]
        emit({"phase": "pixels", "run": label, "argv": argv,
              "train_batches": n_train, "val_batches": n_val,
              "batch_feats_shape": list(first_batch["feats"].shape),
              "launches": launches, "i3d_forwards": forwards,
              "train_loss_by_epoch": losses,
              "val_loss_by_epoch": [h["val"]["loss"] for h in history],
              "backbone_unchanged": unchanged, "seconds": wall,
              "step_s_host_avg": [h["train"]["time"] for h in history],
              "decoder": decoder,
              "batch_decode_s": stages["batch"] / max(batches, 1),
              # a window is T anchors x a stack of 10 frames
              "frame_decode_ms": (stages["window_decode"] * 1e3 / max(
                  calls["window_decode"] * first_batch["feats"].shape[1]
                  * first_batch["feats"].shape[2], 1)),
              "batches_decoded": batches,
              "max_memory_allocated": peak, "nvidia_smi": card})
        all_launches[f"pixels_{label}"] = launches

    pixels_step_vs_cpu(first_batch, card)

    # --i3d-chunk 20 against one-shot, on the card
    one = pixels_model().to("cuda")
    chunked = pixels_model(feat_chunk=PIXELS_CHUNK).to("cuda")
    chunked.load_state_dict(one.state_dict())
    clips = torch.from_numpy(first_batch["feats"]).to("cuda")
    with torch.no_grad():
        a, b = one(clips), chunked(clips)
    check_close("pixels chunked vs one-shot", b, a, PIXELS_CHUNK_RTOL,
                PIXELS_CHUNK_ATOL)
    emit({"phase": "pixels_chunk_vs_one_shot", "chunk": PIXELS_CHUNK,
          "clips": int(clips.shape[0] * clips.shape[1]),
          "logits_max_abs_dev": max_dev(a, b),
          "tolerance": [PIXELS_CHUNK_RTOL, PIXELS_CHUNK_ATOL]})
    del one, chunked, clips, a, b

    # extraction: charades_ctc_next_pred without --features-dir, twice
    cache = os.path.join(work, "pixels_extract")
    argv = (paths + ["--cache-dir", cache, "--epochs", "1",
                     "--device", "cuda"] + CHARADES_GEOMETRY)
    runs, printed = [], []
    for _ in range(2):
        (history, (train, val), launches, wall, stages, calls, peak,
         out) = pixels_cli_run("extract", argv, EXTRACT_STAGES)
        printed.append(out)
        want = {**expect_counts(noblank=(len(train) + len(val),
                                         len(train))),
                **pool_counts(calls["i3d_forward"])}
        if launches != want:
            fail(f"pixels extract: launch counts {launches}, expected "
                 f"{want}")
        runs.append({"seconds": wall, "stage_s": stages,
                     "stage_calls": calls, "launches": launches,
                     "train_loss": history[0]["train"]["loss"],
                     "max_memory_allocated": peak})
    if runs[0]["stage_calls"]["i3d_batches"] == 0 or \
            runs[1]["stage_calls"]["i3d_batches"] != 0:
        fail(f"pixels extract: I3D batches {runs[0]['stage_calls']} then "
             f"{runs[1]['stage_calls']}: the rerun did not read the cache")
    if ("WARNING: --rgb-pretrained-weights not set" not in printed[0]
            or "JPEG decoder: pil (feature extraction)" not in printed[0]):
        fail("pixels extract: no WARNING or decoder line in the first run")
    cfg = config.parse(argv)
    data, _ = _prepared(cfg, "train", cfg.train_file)
    card_feats = np.load(os.path.join(cfg.cache, "features_train",
                                      "features.npy"))
    model = pixels_model().i3d
    cpu_feats = extract_split_features(
        filter_samples(data, [0, 1]),
        I3DFeatureExtractor(model, device="cpu"),
        os.path.join(work, "pixels_extract_cpu"), gap=cfg.gap)
    check_close("pixels features card vs cpu",
                torch.from_numpy(card_feats[:2]),
                torch.from_numpy(np.asarray(cpu_feats)),
                PIXELS_FEAT_RTOL, PIXELS_FEAT_ATOL)
    emit({"phase": "pixels_extract", "argv": argv, "runs": runs,
          "features_shape": list(card_feats.shape),
          "cpu_windows": 2,
          "features_max_abs_dev": max_dev(torch.from_numpy(card_feats[:2]),
                                          torch.from_numpy(cpu_feats)),
          "tolerance": [PIXELS_FEAT_RTOL, PIXELS_FEAT_ATOL],
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "nvidia_smi": card})
    all_launches["pixels_extract"] = runs[0]["launches"]

    # --compute-dtype bf16 on the synthetic main path against f32
    histories = {}
    for dtype in ("f32", "bf16"):
        argv = MAIN_ARGS + ["--cache-dir", os.path.join(work, f"main_{dtype}"),
                            "--compute-dtype", dtype]
        history, loaders, launches, wall, _, _, _, _ = pixels_cli_run(
            f"main {dtype}", argv, {})
        steps = len(loaders[0]) * 2
        want = {**expect_counts(noblank=(steps + len(loaders[1]) * 2,
                                         steps)),
                **pool_counts()}
        if launches != want:
            fail(f"main path {dtype}: launch counts {launches}, expected "
                 f"{want}")
        histories[dtype] = [[h["train"]["loss"], h["val"]["loss"]]
                            for h in history]
        all_launches[f"main_{dtype}"] = launches
    if not np.allclose(histories["bf16"], histories["f32"],
                       rtol=BF16_LOSS_RTOL, atol=0.0):
        fail(f"main path bf16 losses {histories['bf16']} vs f32 "
             f"{histories['f32']}")
    emit({"phase": "pixels_bf16", "main_path_losses": histories,
          "loss_rtol": BF16_LOSS_RTOL, **pixels_bf16_vs_f32(first_batch),
          "nvidia_smi": card})

    times = pixels_step_times(first_batch)
    emit({"phase": "pixels_step", "batch_feats_shape":
          list(first_batch["feats"].shape), **times,
          "copy": pixels_copy(first_batch), "nvidia_smi": card})
    emit({"phase": "pixels_done", "seconds": time.perf_counter() - t_phase})
    return all_launches


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
# (STEP_ZERO_GRAD_PARAMS), which Adam scales to steps of up to lr, and
# where a step does not repeat bit for bit that noise differs from run to
# run
GRAPH_NOISE_CARRIERS = ("feature_head.proj.bias",
                        "feature_head.bn.running_mean")
GRAPH_LR = 1e-3  # the schedule's base rate in the graph cases
# a path whose eager steps do not repeat bit for bit is held to this many
# times their own run-to-run max |dev|: before the blank emission gather's
# backward became a one-hot product, two eager runs of blank at seq 4
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
    steps themselves do not repeat, to GRAPH_NOISE_FACTOR times their own
    run-to-run max |dev|.
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


# the parallel phase: the main path's run (synthetic, a global batch of 256,
# T=10, 1024-d, head 33, noblank, 2 epochs) over the data axis, dropout 0 so
# that runs which split the batch otherwise agree; the CLI is driven in
# processes of its own (``--cli-child``) where it starts ranks, in this one
# where it runs one rank
PAR_ARGS = MAIN_ARGS + ["--dropout", "0"]
PAR_SEQ_ARGS = SEQ_COMMON + SEQ_FLAGS + ["--seq-microbatches", "8",
                                         "--dropout", "0"]
PAR_BINARY_ARGS = PAR_ARGS + ["--loss", "binary"]
PAR_BLANK_ARGS = PAR_ARGS + ["--loss", "blank"]
PAR_K = 8  # --steps-per-dispatch of the one-rank NCCL run
PAR_LR = 1e-3  # the CLI's --lr
# runs that split the batch otherwise: the loss to rtol 1e-5; weights to
# rtol 1e-5 / atol STEP_PARAM_ATOL (a rank's rows run the head's matmuls at
# other shapes than the whole batch, so cuBLAS sums them in another order,
# as the card against the CPU does; Adam turns that rounding into steps of
# up to lr where a gradient is near it), the zero-gradient bias and the
# running mean that carries it to 2 lr an update
# (tests/torch_trainer_pair.py)
PAR_LOSS_RTOL = 1e-5
PAR_WEIGHT_RTOL, PAR_WEIGHT_ATOL = 1e-5, STEP_PARAM_ATOL
PAR_BIAS_CARRIERS = ("feature_head.proj.bias",
                     "feature_head.bn.running_mean")
PAR_TRAIN_STEPS = 16  # the synthetic loader's 8 batches, 2 epochs
PAR_TIMEOUT = 300  # seconds, one CLI process and the ranks it starts


def _instrument(calls):
    """Count ``all_reduce`` calls made eagerly and while a CUDA graph is
    captured, and graph replays; returns the undo."""
    import torch
    import torch.distributed as dist

    real_ar, real_replay = dist.all_reduce, torch.cuda.CUDAGraph.replay

    def all_reduce(tensor, *args, **kwargs):
        key = ("captured" if torch.cuda.is_current_stream_capturing()
               else "eager")
        calls[key] += 1
        return real_ar(tensor, *args, **kwargs)

    def replay(self):
        calls["graph_replays"] += 1
        return real_replay(self)

    dist.all_reduce, torch.cuda.CUDAGraph.replay = all_reduce, replay

    def undo():
        dist.all_reduce, torch.cuda.CUDAGraph.replay = real_ar, real_replay

    return undo


def _allreduce_ms(mesh, numel, iters=20):
    """Median ms of one all-reduce of ``numel`` f32 on the mesh's group,
    synchronized on both sides."""
    import torch
    import torch.distributed as dist

    buf = torch.zeros(numel, device=mesh.devices[0])
    times = []
    for i in range(iters + 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(buf, group=mesh.group)
        torch.cuda.synchronize()
        if i >= 3:
            times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def exchange_numel(cfg) -> int:
    """Floats one train step's exchange all-reduces: the head's
    parameters and BatchNorm statistics, and three metrics."""
    from ctc_tpu_torch.models import LSTMHead

    model = LSTMHead(cfg.extract_feat_dim, cfg.head_classes)
    return (sum(p.numel() for p in model.parameters())
            + sum(b.numel() for b in model.buffers()) + 3)


def counted_run_rank(report_dir, local_rank, cfg, plan):
    """``cli.main.run_rank`` with this rank's lattice launches, its
    all-reduces (eager and captured), its graph replays and the time of
    one exchange-sized all-reduce on its group written to
    ``report_dir/rank<r>.json``."""
    from ctc_tpu_torch.cli import main as cli_main

    real_run_rank = getattr(cli_main, "_smoke_real_run_rank",
                            cli_main.run_rank)
    real_run = cli_main.run
    calls = {"eager": 0, "captured": 0, "graph_replays": 0}
    counted, timing = {}, {}

    def timed_run(cfg, device, mesh=None):
        out = real_run(cfg, device, mesh)
        counted.update(calls)  # the run's, not the timing's below
        numel = exchange_numel(cfg)
        timing.update(backend=mesh.backend, bytes=4 * numel,
                      ms=_allreduce_ms(mesh, numel))
        return out

    undo = _instrument(calls)
    cli_main.run = timed_run
    reset_counts()
    try:
        history = real_run_rank(local_rank, cfg, plan)
    finally:
        cli_main.run = real_run
        undo()
    rank = plan.host_id * plan.local_ranks + local_rank
    with open(os.path.join(report_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "launches": read_counts(),
                   "collectives": counted, "allreduce": timing,
                   "history": history}, f)
    return history


def counted_main(argv, report_dir):
    """``cli.main.main(argv)`` with every rank it runs reporting to
    ``report_dir`` (:func:`counted_run_rank`)."""
    import functools

    from ctc_tpu_torch.cli import main as cli_main

    os.makedirs(report_dir, exist_ok=True)
    cli_main._smoke_real_run_rank = real = cli_main.run_rank
    cli_main.run_rank = functools.partial(counted_run_rank, report_dir)
    try:
        return cli_main.main(argv)
    finally:
        cli_main.run_rank = real


def rank_reports(report_dir) -> list:
    out = []
    for name in sorted(os.listdir(report_dir)):
        with open(os.path.join(report_dir, name)) as f:
            out.append(json.load(f))
    return sorted(out, key=lambda r: r["rank"])


def cli_children(label, argvs, work):
    """Run ``cli.main`` in one process per argv (``python3 chip_smoke.py
    --cli-child DIR ARGV``), at once, each bounded by PAR_TIMEOUT; returns
    (rank reports, the processes' outputs, seconds)."""
    report_dir = os.path.join(work, f"{label}_ranks")
    os.makedirs(report_dir, exist_ok=True)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cli-child",
         report_dir, *argv], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
        for argv in argvs]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=PAR_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                if q.poll() is None:
                    os.killpg(q.pid, 9)
            fail(f"parallel {label}: past {PAR_TIMEOUT} s:\n"
                 f"{p.communicate()[0][-4000:]}")
        if p.returncode:
            fail(f"parallel {label}: exit {p.returncode}:\n{out[-4000:]}")
        outs.append(out)
    return rank_reports(report_dir), outs, time.perf_counter() - t0


def final_weights(cache):
    import torch

    ckpt_dir = os.path.join(cache, "test", "ckpt")
    last = max(int(f[:-3]) for f in os.listdir(ckpt_dir)
               if f[:-3].isdigit())
    payload = torch.load(os.path.join(ckpt_dir, f"{last}.pt"),
                         map_location="cpu", weights_only=True)
    return payload["model"]


def weights_dev(label, got, want, updates, rtol=PAR_WEIGHT_RTOL,
                atol=PAR_WEIGHT_ATOL) -> dict:
    """Max |dev| of two runs' final weights, by parameter; fails beyond
    the tolerance (the noise carriers to 2 lr an update)."""
    import torch

    worst = {}
    for name, w in want.items():
        g = got[name]
        worst[name] = max_dev(g, w)
        tol = ((0.0, 2 * PAR_LR * updates) if name in PAR_BIAS_CARRIERS
               else (rtol, atol))
        if not torch.allclose(g, w, rtol=tol[0], atol=tol[1]):
            fail(f"parallel {label}: {name} max |dev| {max_dev(g, w)} "
                 f"beyond rtol {tol[0]} atol {tol[1]}")
    return worst


def history_rows(history) -> list:
    return [[h[part][c] for part in ("train", "val")
             for c in ("loss", "top1", "top5")] for h in history]


def check_histories(label, got, want, rtol=PAR_LOSS_RTOL, atol=0.0):
    """Per epoch: train and val loss, top-1 and top-5; returns max |dev|."""
    import numpy as np

    g, w = history_rows(got), history_rows(want)
    if len(g) != len(w) or not np.allclose(g, w, rtol=rtol, atol=atol):
        fail(f"parallel {label}: {g} against {w}")
    return float(np.max(np.abs(np.subtract(g, w))))


def step_ms(history) -> list:
    return [h["train"]["time"] * 1e3 for h in history]


def phase_parallel(work, card):
    """The data axis on the card at the main path's width: two gloo ranks
    sharing cuda:0 against one rank of the same global batch, rows 1-2
    launched once per rank a step, and again under --loss blank (rows
    5-6); one NCCL rank with K=8 steps a CUDA
    graph, its all-reduces captured, against its eager run; four class
    shards (binary) against none; 2 ranks x 4 seq shards at T=64 (rows
    3-4); two CLI processes joined by --num-hosts 2; two NCCL ranks on two
    cards where the machine has them.  Returns the launches of each run,
    by rank."""
    import torch

    from ctc_tpu_torch.cli.main import main

    def in_process(argv):
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            history = main(argv)
        torch.cuda.synchronize()
        return history, read_counts(), time.perf_counter() - t0

    per_step = expect_counts(noblank=(PAR_TRAIN_STEPS + 4,
                                      PAR_TRAIN_STEPS))
    launches = {}
    one_cache = os.path.join(work, "par_one")
    h_one, c_one, s_one = in_process(PAR_ARGS + ["--cache-dir", one_cache])
    if c_one != per_step:
        fail(f"parallel one rank: launches {c_one}, expected {per_step}")
    w_one = final_weights(one_cache)

    # two gloo ranks sharing the card (NCCL where each has a card)
    d2_cache = os.path.join(work, "par_d2")
    reports, outs, secs = cli_children(
        "d2", [PAR_ARGS + ["--data-parallel", "2", "--cache-dir",
                           d2_cache]], work)
    backend = reports[0]["allreduce"]["backend"]
    for r in reports:
        if r["launches"] != per_step:
            fail(f"parallel d2 rank {r['rank']}: launches "
                 f"{r['launches']}, expected {per_step}")
    launches["dp2"] = [r["launches"] for r in reports]
    h_d2 = reports[0]["history"]
    emit({"phase": "parallel", "run": "data_parallel_2",
          "argv": PAR_ARGS + ["--data-parallel", "2"], "seconds": secs,
          "ranks": len(reports), "backend": backend,
          "history_max_abs_dev": check_histories("d2", h_d2, h_one),
          "weights_max_abs_dev": weights_dev("d2", final_weights(d2_cache),
                                             w_one, PAR_TRAIN_STEPS),
          "launches_per_rank": {k: v for k, v in
                                reports[0]["launches"].items() if v},
          "allreduce_per_rank": reports[0]["collectives"],
          "exchange": reports[0]["allreduce"],
          "step_ms": {"one_rank": step_ms(h_one),
                      "two_ranks_one_card_not_a_scaling_figure"
                      if backend == "gloo" else "two_ranks_two_cards":
                      step_ms(h_d2)},
          "mesh_line": [ln for ln in outs[0].splitlines()
                        if ln.startswith("data-parallel:")],
          "nvidia_smi": card})

    # blank CTC (rows 5-6) on 2 ranks against one rank.  Its first step's
    # reduced gradient is the whole batch's (tests/test_torch_composed.py),
    # but over 16 steps a few weights part by more than the noblank run's
    # (a rounding difference at a ReLU's kink changes a gradient by a
    # step, which Adam turns into up to lr).  So its weights are held to the
    # noise carriers' bound, 2 lr an update, and its losses to rtol 1e-5
    blank_cache = os.path.join(work, "par_blank")
    h_blank, _, _ = in_process(PAR_BLANK_ARGS + ["--cache-dir", blank_cache])
    d2b_cache = os.path.join(work, "par_d2_blank")
    reports, _, secs = cli_children(
        "d2_blank", [PAR_BLANK_ARGS + ["--data-parallel", "2",
                                       "--cache-dir", d2b_cache]], work)
    want = expect_counts(blank=(PAR_TRAIN_STEPS + 4, PAR_TRAIN_STEPS))
    for r in reports:
        if r["launches"] != want:
            fail(f"parallel d2 blank rank {r['rank']}: launches "
                 f"{r['launches']}, expected {want}")
    launches["dp2_blank"] = [r["launches"] for r in reports]
    emit({"phase": "parallel", "run": "data_parallel_2_blank",
          "argv": PAR_BLANK_ARGS + ["--data-parallel", "2"],
          "seconds": secs,
          "history_max_abs_dev": check_histories(
              "d2 blank", reports[0]["history"], h_blank),
          "weights_max_abs_dev": weights_dev(
              "d2 blank", final_weights(d2b_cache),
              final_weights(blank_cache), PAR_TRAIN_STEPS, rtol=0.0,
              atol=2 * PAR_LR * PAR_TRAIN_STEPS),
          "launches_per_rank": {k: v for k, v in
                                reports[0]["launches"].items() if v},
          "exchange": reports[0]["allreduce"],
          "step_ms": {"one_rank": step_ms(h_blank),
                      "two_ranks_one_card_not_a_scaling_figure"
                      if backend == "gloo" else "two_ranks_two_cards":
                      step_ms(reports[0]["history"])},
          "nvidia_smi": card})

    # one NCCL rank: eager, then K steps a CUDA graph with the all-reduce
    runs = {}
    for k in (1, PAR_K):
        cache = os.path.join(work, f"par_nccl_k{k}")
        rdir = os.path.join(work, f"par_nccl_k{k}_ranks")
        argv = PAR_ARGS + ["--data-parallel", "1", "--steps-per-dispatch",
                           str(k), "--cache-dir", cache]
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            history = counted_main(argv, rdir)
        torch.cuda.synchronize()
        (report,) = rank_reports(rdir)
        runs[k] = (history, report, final_weights(cache),
                   time.perf_counter() - t0, argv)
    (h_e, r_e, w_e, s_e, _), (h_g, r_g, w_g, s_g, argv_g) = (runs[1],
                                                              runs[PAR_K])
    if r_g["allreduce"]["backend"] != "nccl":
        fail(f"parallel nccl: backend {r_g['allreduce']['backend']}")
    # counters tick at the warm-up group and the capture (8 + 8) and at
    # the 4 eager val steps; epoch 1's group is a replay
    for label, r in (("eager", r_e), ("graph", r_g)):
        if r["launches"] != per_step:
            fail(f"parallel nccl {label}: launches {r['launches']}")
    if not (r_g["collectives"]["captured"] > 0
            and r_g["collectives"]["graph_replays"] >= 1
            and r_e["collectives"]["captured"] == 0):
        fail(f"parallel nccl: collectives {r_g['collectives']} (graph), "
             f"{r_e['collectives']} (eager)")
    launches["dp1_nccl_k8"] = [r_g["launches"]]
    emit({"phase": "parallel", "run": "nccl_one_rank_graph",
          "argv": argv_g, "seconds": {"eager": s_e, "graph": s_g},
          "history_max_abs_dev": check_histories(
              "nccl graph", h_g, h_e, GRAPH_RTOL, GRAPH_ATOL),
          "weights_max_abs_dev": weights_dev(
              "nccl graph", w_g, w_e, PAR_TRAIN_STEPS, GRAPH_RTOL,
              GRAPH_ATOL),
          "vs_no_process_group_max_abs_dev": check_histories(
              "nccl eager vs none", h_e, h_one),
          "collectives": {"eager": r_e["collectives"],
                          "graph": r_g["collectives"]},
          "exchange": r_g["allreduce"],
          "step_ms": {"eager": step_ms(h_e), "graph": step_ms(h_g)},
          "nvidia_smi": card})

    # four class shards of the binary loss against none
    mp_cache, bin_cache = (os.path.join(work, n)
                           for n in ("par_mp4", "par_binary"))
    h_bin, _, _ = in_process(PAR_BINARY_ARGS + ["--cache-dir", bin_cache])
    h_mp, c_mp, s_mp = in_process(PAR_BINARY_ARGS + [
        "--model-parallel", "4", "--cache-dir", mp_cache])
    if c_mp != per_step:
        fail(f"parallel model 4: launches {c_mp}, expected {per_step}")
    launches["mp4_binary"] = [c_mp]
    emit({"phase": "parallel", "run": "model_parallel_4_binary",
          "argv": PAR_BINARY_ARGS + ["--model-parallel", "4"],
          "seconds": s_mp,
          "history_max_abs_dev": check_histories("model 4", h_mp, h_bin),
          "weights_max_abs_dev": weights_dev(
              "model 4", final_weights(mp_cache), final_weights(bin_cache),
              PAR_TRAIN_STEPS),
          "nvidia_smi": card})

    # 2 ranks x 4 seq shards at T=64 against one process's 4 shards
    T, _, _, m = SEQ_MAIN["noblank"]
    seq_one = os.path.join(work, "par_seq_one")
    h_s1, _, _ = in_process(PAR_SEQ_ARGS + ["--cache-dir", seq_one])
    ds_cache = os.path.join(work, "par_d2_seq4")
    reports, _, secs = cli_children(
        "d2_seq4", [PAR_SEQ_ARGS + ["--data-parallel", "2", "--cache-dir",
                                    ds_cache]], work)
    want = expect_counts(noblank_shard=(
        SEQ_SHARDS * m * (PAR_TRAIN_STEPS + 4),
        SEQ_SHARDS * m * PAR_TRAIN_STEPS))
    for r in reports:
        if r["launches"] != want:
            fail(f"parallel d2 x seq4 rank {r['rank']}: launches "
                 f"{r['launches']}, expected {want}")
    launches["dp2_seq4"] = [r["launches"] for r in reports]
    emit({"phase": "parallel", "run": "data_2_x_seq_4",
          "argv": PAR_SEQ_ARGS + ["--data-parallel", "2"], "seconds": secs,
          "T": T, "microbatches_per_rank": m,
          "history_max_abs_dev": check_histories(
              "d2 x seq4", reports[0]["history"], h_s1),
          "weights_max_abs_dev": weights_dev(
              "d2 x seq4", final_weights(ds_cache), final_weights(seq_one),
              PAR_TRAIN_STEPS),
          "launches_per_rank": {k: v for k, v in
                                reports[0]["launches"].items() if v},
          "exchange": reports[0]["allreduce"],
          "step_ms": {"one_process": step_ms(h_s1),
                      "two_ranks_one_card_not_a_scaling_figure"
                      if backend == "gloo" else "two_ranks_two_cards":
                      step_ms(reports[0]["history"])},
          "nvidia_smi": card})

    # two CLI processes, one a host, on the card
    from ctc_tpu_torch.parallel.launch import free_port

    hosts_cache = os.path.join(work, "par_hosts")
    coordinator = f"127.0.0.1:{free_port()}"
    host_argv = [a for a in PAR_ARGS] + ["--num-hosts", "2",
                                         "--coordinator", coordinator,
                                         "--cache-dir", hosts_cache]
    host_argv[host_argv.index("--batch-size") + 1] = "128"
    reports, outs, secs = cli_children(
        "hosts2", [host_argv + ["--host-id", str(h)] for h in range(2)],
        work)
    for r in reports:
        if r["launches"] != per_step:
            fail(f"parallel hosts rank {r['rank']}: launches "
                 f"{r['launches']}, expected {per_step}")
    launches["hosts2"] = [r["launches"] for r in reports]
    emit({"phase": "parallel", "run": "num_hosts_2",
          "argv": host_argv + ["--host-id", "h"], "seconds": secs,
          "history_max_abs_dev": check_histories(
              "hosts", reports[0]["history"], h_one),
          "weights_max_abs_dev": weights_dev(
              "hosts", final_weights(hosts_cache), w_one, PAR_TRAIN_STEPS),
          "mesh_line": [ln for ln in outs[0].splitlines()
                        if ln.startswith("data-parallel:")],
          "exchange": reports[0]["allreduce"],
          "step_ms": {"one_rank": step_ms(h_one),
                      "two_processes_one_card_not_a_scaling_figure":
                      step_ms(reports[0]["history"])},
          "nvidia_smi": card})

    count = torch.cuda.device_count()
    if count < 2:
        emit({"phase": "parallel", "run": "nccl_two_cards",
              "not_run": f"torch.cuda.device_count() = {count}"})
    elif backend != "nccl":
        fail(f"parallel d2 on {count} cards ran {backend}, not nccl")
    else:
        emit({"phase": "parallel", "run": "nccl_two_cards",
              "ran_as": "data_parallel_2 above (backend nccl)"})
    return launches


# the ST-graph (models/stgraph.py) and the gradient tools (ops/grad_tools.py)
# at full width: the I3D feature width, ctc_tpu's s / o / v classes and rank
# (hidden 1000), msg_n = T and B of the main path; o / v label sequences of
# STGRAPH_L, so the lattice is S = 3 (s) and S = 9 (o, v) cells wide
STGRAPH_FEAT = 1024
STGRAPH_CLASSES = (16, 38, 33)  # s, o, v
STGRAPH_RANK = 5
STGRAPH_L = 4
STGRAPH_TRAIN_STEPS = 5  # Adam updates of the training check
# the loss is ~1e10-1e12 at init (the mean-field iterations compound the
# pair energies over msg_n = 10): at lr 1e-3 it swung up and down over 6
# steps on the CPU (B = 32), at 1e-4 it fell at each
STGRAPH_LR = 1e-4
STGRAPH_WINDOWS = 5  # timed windows of the step
STGRAPH_WINDOW_STEPS = 4
STGRAPH_PAIR_ROWS = ("blank_lattice_forward", "blank_lattice_backward")
# At init the sequences reach ~4e11 (the mean-field iterations compound
# the pair energies), so the lattice's posteriors turn on differences at
# f32's rounding there: f32 gradients, on the card or the CPU, miss the
# exact (float64) ones by up to a few percent of a tensor's largest
# element.  Each f32 side is held to the exact gradient: each tensor's max
# |dev| over its largest element, the worst and the median over the
# tensors, at 2.0x / 2.3x the card's readings (B = 256: 4.95% / 0.523% on
# the card and on the CPU alike; 3.8% / 0.28% on the CPU at B = 32).
STGRAPH_GRAD_MAX = 0.10
STGRAPH_GRAD_MEDIAN = 0.012


def close_scaled(name, got, want, rtol, atol) -> float:
    """``check_close`` with ``atol`` scaled by the largest ``|want|`` (at
    least 1), as ``tests/test_torch_stgraph.py`` holds the heads and the
    gradients; returns the max |dev| over that scale."""
    scale = max(1.0, float(want.abs().max()))
    check_close(name, got, want, rtol, atol * scale)
    return max_dev(got, want) / scale


def stgraph_batch(device):
    """Features ``[T, B, 1024]`` and targets from a seed: s in [1, 16),
    o / v sequences of 4 labels in [1, C), lengths in [1, 4]."""
    import torch

    T, B, _ = MAIN_SHAPE
    s, o, v = STGRAPH_CLASSES
    gen = torch.Generator().manual_seed(11)
    batch = (torch.randn((T, B, STGRAPH_FEAT), generator=gen),
             torch.randint(1, s, (B,), generator=gen),
             torch.randint(1, o, (B, STGRAPH_L), generator=gen),
             torch.randint(1, v, (B, STGRAPH_L), generator=gen),
             torch.randint(1, STGRAPH_L + 1, (B,), generator=gen))
    return [x.to(device) for x in batch]


def stgraph_model(device, dropout_rate=0.0):
    import torch

    from ctc_tpu_torch.models import STGraphBase

    s, o, v = STGRAPH_CLASSES
    model = STGraphBase(STGRAPH_FEAT, s, o, v, num_low_rank=STGRAPH_RANK,
                        dropout_rate=dropout_rate)
    model.reset_parameters(torch.Generator().manual_seed(13))
    return model.to(device)


def multi_hot(labels, lengths, classes):
    """``[B, C]`` multi-hot of each sample's first ``length`` labels
    (``gtmat`` gives the padding, marked -1, a zero row)."""
    import torch

    from ctc_tpu_torch.models.stgraph import gtmat

    b, n = labels.shape
    valid = torch.arange(n, device=labels.device)[None, :] < lengths[:, None]
    rows = gtmat((b * n, classes), torch.where(valid, labels, -1).reshape(-1))
    return rows.reshape(b, n, classes).amax(dim=1)


def stgraph_exact(heads, s_t, o_t, v_t, lengths):
    """``STGraphCriterion(msg_n=T)``'s sequences and loss in the heads'
    dtype (float64 here) through the plain blank lattice, which takes any
    float dtype (the kernels and the checked entry points take float32)."""
    import torch

    from ctc_tpu_torch.losses.blank import blank_emissions_and_skip
    from ctc_tpu_torch.models import mean_field_messages
    from ctc_tpu_torch.ops.blank_lattice_cuda import BlankLatticeNLL

    T = MAIN_SHAPE[0]
    seqs = mean_field_messages(heads, msg_n=T)
    in_len = torch.full_like(lengths, T, dtype=torch.int32)
    loss = 0.0
    for seq, tgt, tlen in zip(seqs, (s_t[:, None], o_t, v_t),
                              (torch.ones_like(lengths), lengths, lengths)):
        em, skip = blank_emissions_and_skip(seq, tgt, 0)
        tlen = tlen.to(torch.int32)
        nll = BlankLatticeNLL.apply(em, skip.to(torch.uint8), in_len, tlen,
                                    False)
        loss = loss + (nll / tlen.clamp(min=1).to(nll.dtype)).mean()
    return (*seqs, loss)


def grad_devs(got, want) -> dict:
    """Each tensor's max |dev| over its largest element (at least 1):
    the worst tensor and the median."""
    import statistics

    devs = {n: max_dev(got[n].double(), w) / max(1.0, float(w.abs().max()))
            for n, w in want.items()}
    worst = max(devs, key=devs.get)
    return {"worst": devs[worst], "worst_tensor": worst,
            "median": statistics.median(devs.values())}


def stgraph_tools_run(device):
    """The gradient tools on the heads (leaves: the tools' backward reads
    the cotangents, never the heads' values): balance_labels on the o / v
    unary heads (the batch's multi-hot targets, counted once),
    equalize_grad_norm over the two, the scene head blocked, then the
    backward of every head against seeded cotangents; then
    verbose_gradients on o / v through the criterion, eagerly, its lines
    caught.  Returns the heads' gradients and the printed norms."""
    import torch

    from ctc_tpu_torch.models import STGraphCriterion
    from ctc_tpu_torch.ops import grad_tools as gt

    T, B, _ = MAIN_SHAPE
    feat, s_t, o_t, v_t, lengths = stgraph_batch(device)
    with torch.no_grad():
        leaves = {k: h.requires_grad_() for k, h in
                  stgraph_model(device)(feat).items()}
    gen = torch.Generator().manual_seed(17)
    cots = {k: torch.randn(h.shape, generator=gen).to(device)
            for k, h in leaves.items()}
    heads = dict(leaves)
    for k, c in zip("ov", STGRAPH_CLASSES[1:]):
        hot = multi_hot(o_t if k == "o" else v_t, lengths, c)
        state = gt.update_balance(gt.BalanceState.create(c, device=device),
                                  hot)
        targets = hot[None].expand(T, B, c).reshape(T * B, c)
        heads[k] = gt.balance_labels(heads[k].reshape(T * B, c), targets,
                                     state).reshape(T, B, c)
    heads["o"], heads["v"] = gt.equalize_grad_norm(heads["o"], heads["v"])
    heads["s"] = gt.block_gradient(heads["s"])
    sum((heads[k] * cots[k]).sum() for k in heads).backward()
    grads = {k: h.grad for k, h in leaves.items()}
    # verbose_gradients, its lines kept off the smoke's stdout
    heads = {k: h.detach().requires_grad_() for k, h in leaves.items()}
    heads["o"], heads["v"] = gt.verbose_gradients(heads["o"], heads["v"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        STGraphCriterion(msg_n=T)(heads, s_t, o_t, v_t,
                                  lengths)[3].backward()
    norms = [float(line.rsplit(" ", 1)[1])
             for line in out.getvalue().splitlines()]
    return grads, norms


def phase_stgraph(card):
    """The ST-graph model and criterion on the card at full width, through
    the blank lattice kernels (rows 5-6): one criterion call launches the
    forward 3 times (s, o, v), its backward the backward 3 times; heads,
    mean-field sequences and loss against the CPU (dropout off), and every
    parameter's gradient, on the card and on the CPU, against the exact
    float64 run; Adam steps with dropout 0.3 lower the loss; the gradient
    tools against the CPU; the train step's time, device time, kernels and
    the lattice's share of the device time.  Returns the training run's
    launch counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ctc_tpu_torch.models import STGraphCriterion
    from ctc_tpu_torch.train.optim import TorchStyleAdam

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    T, B, _ = MAIN_SHAPE
    crit = STGraphCriterion(msg_n=T)

    # card against CPU and both against the exact (float64) run, dropout
    # off; the launches of one call
    out = {}
    for run in ("cpu", "cuda", "exact"):
        dev = "cpu" if run == "cpu" else "cuda"
        feat, *tgts = stgraph_batch(dev)
        model = stgraph_model(dev)
        if run == "exact":
            model.double()
            feat = feat.double()
        heads = model(feat)
        if run == "cuda":
            reset_counts()
        *seqs, loss = (stgraph_exact(heads, *tgts) if run == "exact"
                       else crit(heads, *tgts))
        if run == "cuda":
            torch.cuda.synchronize()
            forward = read_counts()
        loss.backward()
        if run == "cuda":
            torch.cuda.synchronize()
            both = read_counts()
            if forward != expect_counts(blank=(3, 0)):
                fail(f"stgraph: one criterion call launched {forward}, "
                     f"expected rows 5-6 at (3, 0)")
            if both != expect_counts(blank=(3, 3)):
                fail(f"stgraph: criterion and backward launched {both}, "
                     f"expected rows 5-6 at (3, 3)")
        out[run] = ({k: h.detach().cpu() for k, h in heads.items()},
                    [s.detach().cpu() for s in seqs], float(loss.detach()),
                    {n: p.grad.cpu() for n, p in model.named_parameters()})
        del model, heads, seqs, loss
    (h_cpu, s_cpu, l_cpu, g_cpu), (h_gpu, s_gpu, l_gpu, g_gpu) = (
        out["cpu"], out["cuda"])
    g_exact = {n: g.double() for n, g in out["exact"][3].items()}
    if not abs(l_gpu - l_cpu) <= LOSS_ATOL + LOSS_RTOL * abs(l_cpu):
        fail(f"stgraph loss card {l_gpu} vs cpu {l_cpu}")
    devs = {"heads": max(close_scaled(f"stgraph head {k}", h_gpu[k],
                                      h_cpu[k], STEP_LOSS_RTOL,
                                      STEP_PARAM_ATOL) for k in h_cpu),
            "sequences": max(close_scaled(f"stgraph sequence {i}", g, w,
                                          STEP_LOSS_RTOL, STEP_PARAM_ATOL)
                             for i, (g, w) in enumerate(zip(s_gpu, s_cpu))),
            "grads_card_vs_exact": grad_devs(g_gpu, g_exact),
            "grads_cpu_vs_exact": grad_devs(g_cpu, g_exact),
            "grads_card_vs_cpu": grad_devs(g_gpu, {
                n: g.double() for n, g in g_cpu.items()})}
    for side in ("card", "cpu"):
        d = devs[f"grads_{side}_vs_exact"]
        if d["worst"] > STGRAPH_GRAD_MAX or d["median"] > STGRAPH_GRAD_MEDIAN:
            fail(f"stgraph: the {side}'s f32 gradients miss the exact ones "
                 f"by {d}, beyond {STGRAPH_GRAD_MAX} worst / "
                 f"{STGRAPH_GRAD_MEDIAN} median")
    emit({"phase": "stgraph_vs_cpu", "shape_TBD": [T, B, STGRAPH_FEAT],
          "classes_sov": list(STGRAPH_CLASSES), "rank": STGRAPH_RANK,
          "label_len": STGRAPH_L, "loss_cuda": l_gpu, "loss_cpu": l_cpu,
          "loss_exact": out["exact"][2],
          "max_abs_dev_over_scale": devs,
          "tolerance": {"loss": [LOSS_RTOL, LOSS_ATOL],
                        "heads_sequences": [STEP_LOSS_RTOL,
                                            STEP_PARAM_ATOL],
                        "atol_scaled_by": "max(1, largest |element|)",
                        "grads_vs_exact": [STGRAPH_GRAD_MAX,
                                           STGRAPH_GRAD_MEDIAN]}})
    del out, h_cpu, s_cpu, g_cpu, h_gpu, s_gpu, g_gpu, g_exact

    # training: Adam on one device-resident batch, dropout 0.3
    feat, *tgts = stgraph_batch("cuda")
    model = stgraph_model("cuda", dropout_rate=0.3)
    opt = TorchStyleAdam(list(model.parameters()))
    gen = torch.Generator(device="cuda").manual_seed(0)
    count = torch.zeros((), dtype=torch.int64, device="cuda")

    def train_step():
        opt.begin(count)
        *_, loss = crit(model(feat, train=True, generator=gen), *tgts)
        loss.backward()
        opt.step(count, STGRAPH_LR)
        count.add_(1)
        return loss.detach()

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses = [float(train_step()) for _ in range(STGRAPH_TRAIN_STEPS + 1)]
    torch.cuda.synchronize()
    launches = read_counts()
    n = STGRAPH_TRAIN_STEPS + 1
    if launches != expect_counts(blank=(3 * n, 3 * n)):
        fail(f"stgraph: {n} train steps launched {launches}, expected rows "
             f"5-6 at ({3 * n}, {3 * n})")
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        fail(f"stgraph: the loss did not fall over {STGRAPH_TRAIN_STEPS} "
             f"Adam steps: {losses}")

    def steps(k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(k):
            train_step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / k * 1e3

    step_ms = spread([steps(STGRAPH_WINDOW_STEPS)
                      for _ in range(STGRAPH_WINDOWS)])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STGRAPH_WINDOW_STEPS):
            train_step()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA
              and not e.is_user_annotation()]
    device_ms = sum(e.duration_ns() for e in events) / 1e6
    rows = {k: [0, 0.0] for k in STGRAPH_PAIR_ROWS}
    for e in events:
        key = lattice_key(e.name())
        if key is not None:
            if key not in rows:
                fail(f"stgraph: the profile holds lattice kernel {key}")
            rows[key][0] += 1
            rows[key][1] += e.duration_ns() / 1e6
    per = STGRAPH_WINDOW_STEPS
    if any(c != 3 * per for c, _ in rows.values()):
        fail(f"stgraph: the profiled steps ran rows 5-6 {rows}, expected "
             f"3 each a step")
    emit({"phase": "stgraph_train", "losses": losses,
          "launches": {k: launches[k] for k in STGRAPH_PAIR_ROWS},
          "step_ms": step_ms, "device_ms_per_step": device_ms / per,
          "device_busy_share": device_ms / window_ms,
          "kernels_per_step": len(events) / per,
          "rows_5_6_ms_per_step": {k: ms / per for k, (_, ms) in
                                   rows.items()},
          "rows_5_6_share": sum(ms for _, ms in rows.values()) / device_ms,
          "peak_bytes": torch.cuda.max_memory_allocated(),
          "nvidia_smi": card})
    del model, opt, feat, tgts

    # the gradient tools, card against CPU
    g_gpu, n_gpu = stgraph_tools_run("cuda")
    g_cpu, n_cpu = stgraph_tools_run("cpu")
    if g_gpu["s"] is not None or g_cpu["s"] is not None:
        fail("stgraph tools: block_gradient let a gradient reach the scene "
             "head")
    tool_dev = max(close_scaled(f"stgraph tools head grad {k}",
                                g_gpu[k].cpu(), w, GRAD_RTOL, GRAD_ATOL)
                   for k, w in g_cpu.items() if w is not None)
    if len(n_gpu) != 2 or not all(
            abs(a - b) <= GRAD_RTOL * abs(b) for a, b in zip(n_gpu, n_cpu)):
        fail(f"stgraph tools: verbose_gradients printed {n_gpu} on the "
             f"card, {n_cpu} on the CPU")
    emit({"phase": "stgraph_tools",
          "head_grads_max_abs_dev_over_scale": tool_dev,
          "verbose_norms_cuda": n_gpu, "verbose_norms_cpu": n_cpu,
          "seconds": time.perf_counter() - t_phase})
    return launches


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


def kernel_device_ms(fn, symbol=None, iters=20):
    """Device execution time of one launch of ``fn``'s kernel ``symbol``
    from the profiler (the CUDA-event time of back-to-back launches at a
    small shape is the host's launch rate instead), or without a symbol of
    every kernel one call of ``fn`` launches: the mean of each of
    ``DEVICE_WINDOWS`` windows of ``iters`` calls, as the row fields
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
        ev = [e for e in device_kernels(prof)
              if symbol is None or symbol in e.key]
        if ev:
            calls = iters if symbol is None else sum(e.count for e in ev)
            readings.append(sum(dev_us(e) for e in ev) / calls / 1e3)
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


def phase_max_pool(card, name):
    """The TF-same max pool kernels (``csrc/max_pool3d_same.cu``) on the
    inputs of the 13 pools of one frozen step: 100 clips of 10 x 224 x 224
    through a seeded ``InceptionI3d`` in float32, in the layout the model
    gives them.  Per pool: that layout, the kernel output's strides against
    the plain version's, parity (the forward exact; the gradient exact
    under an integer cotangent), and the card ms (CUDA events; device, by
    the profiler) of the forward without offsets (the frozen path), with
    offsets and the gather backward (the finetune path), beside each one's
    bytes bound, the plain version's ms (``F.pad`` and ``F.max_pool3d``)
    and the library's: ``F.max_pool3d`` alone on the padded input and its
    backward (what the port ran before).  Then the sums over a step's 13
    pools, and the launches of a frozen forward and of a finetune step."""
    import torch

    from ctc_tpu_torch.models import i3d
    from ctc_tpu_torch.ops import max_pool as mp

    torch.manual_seed(0)
    model = i3d.InceptionI3d(num_classes=None).to("cuda").eval()
    clips = torch.randn((10, 10, 10, 224, 224, 3), device="cuda")
    names = [pool[0] for pool in i3d.pool_shapes(100)]
    inputs = []

    def recording(x, kernel, stride):
        inputs.append((x, kernel, stride))
        return mp.max_pool3d_same(x, kernel, stride)

    original = i3d.max_pool3d_same
    i3d.max_pool3d_same = recording
    mp.reset_launch_counts()
    try:
        with torch.no_grad():
            model(clips)
    finally:
        i3d.max_pool3d_same = original
    torch.cuda.synchronize()
    launches = dict(mp.launch_counts)
    if launches != {"max_pool3d_same_forward": 13,
                    "max_pool3d_same_backward": 0}:
        fail(f"max_pool: one frozen forward launched {launches}")
    # one finetune step of one clip: both kernels, 13 launches each
    mp.reset_launch_counts()
    step_model = i3d.InceptionI3d(num_classes=None).to("cuda")
    step_model(torch.randn((1, 1, 10, 224, 224, 3), device="cuda"),
               train=True).sum().backward()
    torch.cuda.synchronize()
    step_launches = dict(mp.launch_counts)
    if step_launches != {"max_pool3d_same_forward": 13,
                         "max_pool3d_same_backward": 13}:
        fail(f"max_pool: one finetune step launched {step_launches}")
    del model, clips, step_model
    rate = hbm_rate(name)
    rows, totals = [], {}
    for pool, (x, kernel, stride) in zip(names, inputs):
        pads = mp.same_pads(x.shape[2:], kernel, stride)
        padded = torch.nn.functional.pad(x, pads)
        y = mp.max_pool3d_same(x, kernel, stride)
        want = mp.max_pool3d_same_plain(x, kernel, stride)
        xg = x.detach().requires_grad_()
        ref = x.detach().clone().requires_grad_()
        yg = mp.max_pool3d_same(xg, kernel, stride)
        gy = torch.randint(1, 9, yg.shape, device="cuda").float().contiguous(
            memory_format=torch.channels_last_3d if mp.channels_last(yg)
            else torch.contiguous_format)
        (gx,) = torch.autograd.grad(yg, xg, gy)
        (want_gx,) = torch.autograd.grad(
            mp.max_pool3d_same_plain(ref, kernel, stride), ref, gy)
        torch.cuda.synchronize()
        fwd_err = max_dev(y, want)
        grad_err = max_dev(gx, want_gx)
        if fwd_err or grad_err or y.stride() != want.stride():
            fail(f"max_pool {pool}: forward |dev| {fwd_err}, gradient "
                 f"|dev| {grad_err}, strides {y.stride()} / "
                 f"{want.stride()}")
        _, offsets = mp.max_pool3d_same_kernel(x, kernel, stride,
                                               with_offsets=True)
        lib_y, lib_idx = torch.nn.functional.max_pool3d(
            padded, kernel, stride, return_indices=True)
        fns = {
            "forward": lambda: mp.max_pool3d_same_kernel(
                x, kernel, stride, with_offsets=False),
            "forward_offsets": lambda: mp.max_pool3d_same_kernel(
                x, kernel, stride, with_offsets=True),
            "backward": lambda: mp.max_pool3d_same_grad_kernel(
                gy, offsets, x.shape, kernel, stride),
            "plain": lambda: mp.max_pool3d_same_plain(x, kernel, stride),
            "library": lambda: torch.nn.functional.max_pool3d(
                padded, kernel, stride),
            "library_backward": lambda: (
                torch.ops.aten.max_pool3d_with_indices_backward(
                    gy, padded, kernel, stride, (0, 0, 0), (1, 1, 1), False,
                    lib_idx)),
        }
        ebytes = x.element_size()
        n_in, n_out = x.numel(), y.numel()
        bounds = {
            "forward": (n_in + n_out) * ebytes,
            "forward_offsets": (n_in + n_out) * ebytes + n_out,
            "backward": n_out * (ebytes + 1) + n_in * ebytes,
        }
        row = {"phase": "max_pool", "pool": pool, "shape": list(x.shape),
               "kernel": list(kernel), "stride": list(stride),
               "channels_last": mp.channels_last(x),
               "out_channels_last": mp.channels_last(y),
               "out_strides": list(y.stride()),
               "plain_out_strides": list(want.stride()),
               "tile": list(mp.tile_plan(tuple(y.shape[3:]), kernel,
                                         stride)),
               "forward_max_abs_dev": fwd_err, "grad_max_abs_dev": grad_err}
        order = ("plain", "library", "forward", "forward_offsets",
                 "backward", "library_backward")
        events = {k: [] for k in order}
        for k in order + order[::-1]:  # in turns
            events[k].append(time_ms(fns[k], 10))
        for k in order:
            row[f"{k}_ms"] = sum(events[k]) / 2
            row[f"{k}_device_ms"] = kernel_device_ms(
                fns[k], iters=10)["kernel_device_ms"]
            if row[f"{k}_device_ms"] is None:
                fail(f"max_pool {pool}: no device record of {k}")
            if k in bounds:
                row[f"{k}_bytes"] = bounds[k]
                row[f"{k}_bound_ms"] = bounds[k] / rate * 1e3
                row[f"{k}_roofline_pct"] = (
                    100 * row[f"{k}_bound_ms"] / row[f"{k}_device_ms"])
            totals[k] = totals.get(k, 0.0) + row[f"{k}_device_ms"]
            totals[f"{k}_events"] = (totals.get(f"{k}_events", 0.0)
                                     + row[f"{k}_ms"])
            totals[f"{k}_bound"] = (totals.get(f"{k}_bound", 0.0)
                                    + row.get(f"{k}_bound_ms", 0.0))
        emit(row)
        rows.append(row)
        del padded, lib_y, lib_idx, offsets, gx, want_gx, y, want, yg
    summary = {"phase": "max_pool_step", "pools": len(rows),
               "launches_frozen_forward": launches,
               "launches_finetune_step": step_launches,
               **{f"{k}_ms": totals[f"{k}_events"] for k in order},
               **{f"{k}_device_ms": totals[k] for k in order},
               "forward_max_abs_dev": max(r["forward_max_abs_dev"]
                                          for r in rows),
               "grad_max_abs_dev": max(r["grad_max_abs_dev"] for r in rows),
               **{f"{k}_bound_ms": totals[f"{k}_bound"]
                  for k in ("forward", "forward_offsets", "backward")},
               "forward_roofline_pct": 100 * totals["forward_bound"]
               / totals["forward"],
               "hbm_bytes_per_s": rate, "card": card}
    emit(summary)
    return summary


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

    if len(sys.argv) > 2 and sys.argv[1] == "--cli-child":
        # one CLI process of the parallel phase (cli_children)
        counted_main(sys.argv[3:], sys.argv[2])
        return
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this needs a CUDA card")
    only_pool = sys.argv[1:] == ["--only", "max_pool"]
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
    pool = phase_max_pool(card, name)
    if only_pool:
        emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                     "count": torch.cuda.device_count()}})
        return
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
        parallel_launches = phase_parallel(work, card)
        pixels_launches = phase_pixels(work, card)
    stgraph_launches = phase_stgraph(card)
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
            # the pixels phase's runs (the I3D's loss)
            "pixels_launches": {run: n[kname] for run, n in
                                pixels_launches.items() if n[kname]},
            # the ST-graph's Adam steps (rows 5-6 only)
            **({"stgraph_launches": stgraph_launches[kname]}
               if kname in STGRAPH_PAIR_ROWS else {}),
            # and in each run of the parallel phase, rank by rank
            "parallel_launches": {run: [n[kname] for n in ranks]
                                  for run, ranks in parallel_launches.items()
                                  if any(n[kname] for n in ranks)},
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
    # the pool kernels replace no Pallas kernel.  Launches: the frozen and
    # the finetune charades_pixels runs (13 a backbone forward, 13 a
    # finetune step's backward); times, bounds and the largest deviation
    # from the plain version: the 13 pools of a frozen step, summed
    for kname, key, err, run in (
            ("max_pool3d_same_forward", "forward", "forward_max_abs_dev",
             "pixels_frozen"),
            ("max_pool3d_same_backward", "backward", "grad_max_abs_dev",
             "pixels_finetune")):
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "ctc_tpu_torch/csrc/max_pool3d_same.cu",
            "replaces": None,
            "launches": pixels_launches[run][kname],
            "max_abs_err": pool[err],
            "ms": pool[f"{key}_ms"], "device_ms": pool[f"{key}_device_ms"],
            "plain_ms": pool["plain_device_ms"],
            "bound_ms": pool[f"{key}_bound_ms"], "bound_by": "bytes",
            "library_ms": pool["library_device_ms" if key == "forward"
                               else "library_backward_device_ms"],
            "pixels_launches": {run: n[kname] for run, n in
                                pixels_launches.items() if n.get(kname)},
        })
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
