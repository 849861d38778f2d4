"""Smoke run of ctc_tpu_torch on one CUDA card.

Builds the hand-written CUDA kernels from ``ctc_tpu_torch/csrc/``, holds
each against its plain PyTorch version on the card, trains the feature-mode
LSTM head through the command-line entry point at full width with the
NoBlankCTC loss and with the blank CTC loss, then both again with the
lattice's T axis split into 4 shards (``--seq-parallel 4``), decodes from
the checkpoints they wrote (greedy, beam, Viterbi alignment, and the
sharded greedy decode), checks that each run went through its kernels, and
times each kernel beside its plain version, its bound and, where one
exists, the PyTorch call that computes the same function.  Then the same
for the ten forward-lattice probe kernels at three shapes (the last at the
edges of the row-9 kernels' em ring), and both probe entry points
(``python -m ctc_tpu_torch.probes.fwd_ops`` and ``.expdomain_fwd``) at the
bench shape, each in a process of its own.  Prints one JSON line per
phase; the last line is ``{"ok": true, "device": {...}}``.  Any failure
exits non-zero.

Run from the repository root: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import json
import os
import re
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


def make_case(gen, shape, *, degenerate=False, device):
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
    cot = torch.randn((B,), generator=gen)
    return [x.to(device) for x in (em, inlen, tgt, cot)]


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
    """Each kernel against the plain version on the card: NLL (forward),
    reachable alpha cells, and d nll / d em under a random cotangent."""
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
    ]
    errs = {}
    for label, shape, degenerate in cases:
        em, inlen, tgt, cot = make_case(gen, shape, degenerate=degenerate,
                                        device=dev)
        inlen32, tgt32 = inlen.int(), tgt.int()
        alpha_k = lc.noblank_alpha_kernel(em, tgt32)
        alpha_p = lc.noblank_alpha_plain(em, tgt32)
        nll_k = lc.gather_nll(alpha_k, inlen32, tgt32)
        nll_p = lc.gather_nll(alpha_p, inlen32, tgt32)
        g_k = lc.noblank_grad_kernel(alpha_k, inlen32, tgt32, cot)
        g_p = lc.noblank_grad_plain(alpha_p, inlen32, tgt32, cot)
        torch.cuda.synchronize()
        reach = alpha_p > -1e12  # cells a path reaches (others hold ~-1e13)
        check_close(f"{label} nll", nll_k, nll_p, LOSS_RTOL, LOSS_ATOL)
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
                    infeasible=False):
    """Raw gathered emissions ``[T, B, S]`` from random logits, the uint8
    skip mask, int32 lengths and a cotangent, on ``device``.  Sample 0 has
    the full T and L; the flags add repeated labels, labels equal to the
    blank id 0, zero-length targets, input lengths 1 and 2, and one
    infeasible sample (fewer frames than its labels need)."""
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
    em, skip = blank_emissions_and_skip(logits, targets, 0)
    cot = torch.randn((B,), generator=gen)
    return [x.to(device) for x in (em.contiguous(), skip.to(torch.uint8),
                                   inlen.int(), tgt.int(), cot)]


def phase_parity_blank():
    """Each blank kernel against the plain version on the card: NLL,
    reachable alpha cells, d nll / d em under a random cotangent, the
    autograd op, and exact zeros at t >= input length."""
    import torch

    from ctc_tpu_torch.ops import blank_lattice_cuda as bl

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
    ]
    errs = {}
    for label, shape, flags in cases:
        em, skip, inlen, tgt, cot = make_blank_case(gen, shape, device=dev,
                                                    **flags)
        alpha_k = bl.blank_alpha_kernel(em, skip)
        alpha_p = bl.blank_alpha_plain(em, skip)
        nll_k = bl.gather_nll(alpha_k, inlen, tgt)
        nll_p = bl.gather_nll(alpha_p, inlen, tgt)
        g_k = bl.blank_grad_kernel(alpha_k, skip, inlen, tgt, cot)
        g_p = bl.blank_grad_plain(alpha_p, skip, inlen, tgt, cot)
        torch.cuda.synchronize()
        reach = alpha_p > -1e29  # unreachable cells hold ~-1e30
        check_close(f"blank {label} nll", nll_k, nll_p, LOSS_RTOL, LOSS_ATOL)
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
    steps = 20 if microbatches else 50
    for _ in range(5):
        step(state, batch, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step(state, batch, gen)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(state, batch, gen)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3

    events = device_kernels(prof)
    device_ms = sum(dev_us(e) for e in events) / 1e3
    top = sorted(events, key=dev_us, reverse=True)[:10]
    symbol = re.compile(rf"(?<![a-z]){loss}_(forward|backward)_kernel")
    lattice_us = sum(dev_us(e) for e in events if symbol.search(e.key))
    emit({"phase": "profile", "loss": loss, "classes": classes,
          "shape_TBL": list(shape),
          "seq_shards": SEQ_SHARDS if microbatches else None,
          "seq_microbatches": microbatches,
          "step_ms": step_ms, "profiled_window_ms": window_ms,
          "device_ms_per_step": device_ms / steps if events else None,
          "device_busy_share": device_ms / window_ms if events else None,
          "kernels_per_step": sum(e.count for e in events) / steps,
          "lattice_us_per_step": lattice_us / steps,
          "top_device_kernels": [
              {"name": e.key[:80], "us_per_step": dev_us(e) / steps,
               "calls_per_step": e.count / steps} for e in top]})


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


def kernel_device_ms(fn, symbol, iters=20):
    """Device execution time of one launch of ``fn``'s kernel ``symbol``
    from the profiler (the CUDA-event time of back-to-back launches at a
    small shape is the host's launch rate instead).  A window whose trace
    holds no record of the kernel (the tracer dropped it) is taken again,
    at most twice; None if none holds one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in device_kernels(prof) if symbol in e.key]
        if ev:
            return sum(dev_us(e) for e in ev) / sum(e.count for e in ev) / 1e3
    return None


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
        alpha = lc.noblank_alpha_kernel(em, tgt)
        cells = T * B * L
        fns = {
            "noblank_lattice_forward": (
                "noblank_forward_kernel",
                lambda: lc.noblank_alpha_kernel(em, tgt),
                lambda: lc.noblank_alpha_plain(em, tgt),
                # em in, alpha out, target lengths in
                8 * cells + 4 * B,
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
            device_ms = kernel_device_ms(kernel, symbol)
            bytes_ms = nbytes / rate * 1e3
            ops_ms = nops / FP32_PEAK * 1e3
            row = {
                "phase": "times", "kernel": kname, "shape": label,
                "shape_TBL": list(shape),
                "kernel_ms": (k1 + k2) / 2, "kernel_ms_runs": [k1, k2],
                "kernel_device_ms": device_ms,
                "plain_ms": (p1 + p2) / 2, "plain_ms_runs": [p1, p2],
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "bytes": nbytes, "operations": nops,
                "hbm_bytes_per_s": rate, "fp32_ops_per_s": FP32_PEAK,
                "library_ms": None, "launches_per_step": 1,
                "card": card,
            }
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
        alpha = bl.blank_alpha_kernel(em, skip)
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
                lambda: bl.blank_alpha_kernel(em, skip),
                lambda: bl.blank_alpha_plain(em, skip),
                # em in, skip mask in, alpha out
                8 * cells + B * S,
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
            device_ms = kernel_device_ms(kernel, symbol)
            bytes_ms = nbytes / rate * 1e3
            ops_ms = nops / FP32_PEAK * 1e3
            row = {
                "phase": "times", "kernel": kname, "shape": label,
                "shape_TBL": list(shape), "S": S, "classes": BLANK_CLASSES,
                "kernel_ms": (k1 + k2) / 2, "kernel_ms_runs": [k1, k2],
                "kernel_device_ms": device_ms,
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
            emit(row)
            result[(kname, label)] = row
    return result

def make_shard_case(gen, family, shape, *, rows, repeats=False,
                    zero_len=False):
    """One shard's operands on the card: em ``[t_s, B, W]`` (blank: the
    normalized gather of random logits, as the pipeline builds it), the two
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
    skip = None
    if family == "noblank":
        width, neg = L, NEG_SENTINEL
        em = torch.randn((t_s, B, L), generator=gen) - 1.0
        tgt = torch.randint(1, L + 1, (B,), generator=gen)
        init = lc.noblank_alpha_init(B, width)
    else:
        width, neg = 2 * L + 1, BLANK_NEG
        targets = torch.randint(1, BLANK_CLASSES, (B, L), generator=gen)
        if repeats:
            targets[:, 1::2] = targets[:, 0::2][:, : targets[:, 1::2].shape[1]]
        logits = torch.randn((t_s, B, BLANK_CLASSES), generator=gen)
        em, skip = blank_emissions_and_skip(logits, targets, 0,
                                            normalize=True)
        skip = skip.to(torch.uint8)
        tgt = torch.randint(0 if zero_len else 1, L + 1, (B,), generator=gen)
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
    out = {"em": em.contiguous(), "r0": r0, "r1": r1, "skip": skip,
           "inlen": inlen.int(), "tgt": tgt.int(), "d_final": d_final,
           "d_boundary": d_boundary}
    return {k: (v.to("cuda") if v is not None else None)
            for k, v in out.items()}


def shard_fns(family, c):
    """(alpha kernel, alpha plain, grad kernel, grad plain, op kernel, op
    plain) of one family, bound to the case ``c``'s operands."""
    from ctc_tpu_torch.ops import blank_lattice_cuda as bl
    from ctc_tpu_torch.ops import lattice_cuda as lc

    if family == "noblank":
        mod, head, tail = lc, (c["tgt"],), (c["inlen"], c["tgt"])
        g_args = (c["inlen"], c["tgt"])
    else:
        mod, head, tail = bl, (c["skip"],), (c["skip"], c["inlen"], c["tgt"])
        g_args = (c["skip"], c["inlen"], c["tgt"])
    rows = (c["r0"], c["r1"])
    bars = (c["d_final"], c["d_boundary"])
    return {
        "alpha_kernel": lambda: getattr(mod, f"{family}_shard_alpha_kernel")(
            c["em"], *head, *rows),
        "alpha_plain": lambda: getattr(mod, f"{family}_shard_alpha_plain")(
            c["em"], *head, *rows),
        "grad_kernel": lambda alpha: getattr(
            mod, f"{family}_shard_grad_kernel")(alpha, *g_args, *bars),
        "grad_plain": lambda alpha: getattr(
            mod, f"{family}_shard_grad_plain")(alpha, *g_args, *bars),
        "op_kernel": getattr(mod, f"{family}_shard_lattice_cuda"),
        "op_plain": getattr(mod, f"{family}_shard_lattice_plain"),
        "final": mod.gather_final,
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
        cases = [
            ("main_path", main_shard, dict(rows="random")),
            ("main_path_shard0", main_shard, dict(rows="shard0")),
            ("long_T", (lT // SEQ_SHARDS, lB // lM, lL), dict(rows="random")),
            ("edges", (6, 16, 5), dict(rows="random", repeats=True,
                                       zero_len=True)),
            ("L1", (5, 4, 1), dict(rows="random")),
        ]
        for label, shape, flags in cases:
            c = make_shard_case(gen, family, shape, **flags)
            f = shard_fns(family, c)
            alpha_k, alpha_p = f["alpha_kernel"](), f["alpha_plain"]()
            final_k = f["final"](alpha_k, c["inlen"], c["tgt"])
            final_p = f["final"](alpha_p, c["inlen"], c["tgt"])
            g_k, g_p = f["grad_kernel"](alpha_k), f["grad_plain"](alpha_p)
            grads = {}
            for impl in ("op_kernel", "op_plain"):
                e, a, b = (c[k].clone().requires_grad_()
                           for k in ("em", "r0", "r1"))
                final, boundary = f[impl](e, a, b, *f["tail"])
                ((final * c["d_final"]).sum()
                 + (boundary * c["d_boundary"]).sum()).backward()
                grads[impl] = (e.grad, a.grad, b.grad)
            torch.cuda.synchronize()
            reach = alpha_p > (-1e12 if family == "noblank" else -1e29)
            tag = f"seq {family} {label}"
            check_close(f"{tag} final", final_k, final_p, LOSS_RTOL,
                        LOSS_ATOL)
            check_close(f"{tag} alpha", alpha_k[reach], alpha_p[reach],
                        LOSS_RTOL, LOSS_ATOL)
            check_close(f"{tag} grad", g_k, g_p, GRAD_RTOL, GRAD_ATOL)
            op_dev = {}
            for name, gk, gp in zip(("em", "init_row_0", "init_row_1"),
                                    grads["op_kernel"], grads["op_plain"]):
                check_close(f"{tag} autograd d {name}", gk, gp, GRAD_RTOL,
                            GRAD_ATOL)
                op_dev[name] = max_dev(gk, gp)
            row = {"phase": "parity_seq", "family": family, "case": label,
                   "shard_shape_TBL": list(shape),
                   "width": int(c["em"].shape[2]),
                   "final_max_abs_dev": max_dev(final_k, final_p),
                   "alpha_reachable_max_abs_dev": max_dev(alpha_k[reach],
                                                          alpha_p[reach]),
                   "grad_max_abs_dev": max_dev(g_k, g_p),
                   "autograd_grad_max_abs_dev": op_dev,
                   "rtol_atol_loss": [LOSS_RTOL, LOSS_ATOL],
                   "rtol_atol_grad": [GRAD_RTOL, GRAD_ATOL]}
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
        history = main(args + ["--cache-dir", cache])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = read_counts()
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
            alpha = f["alpha_kernel"]()
            t_s, mb, width = c["em"].shape
            cells, row = t_s * mb * width, mb * width
            if family == "noblank":
                # em in, alpha out, two init rows and target lengths in;
                # alpha in, g out, g_seed and three [B] vectors in
                fwd_bytes = 8 * cells + 8 * row + 4 * mb
                bwd_bytes = 8 * cells + 4 * row + 12 * mb
                fwd_ops, bwd_ops = 8 * cells, 17 * cells  # as rows 1-2
            else:
                # as above plus the [B, S] byte mask in each
                fwd_bytes = 8 * cells + 9 * row
                bwd_bytes = 8 * cells + 5 * row + 12 * mb
                fwd_ops, bwd_ops = 14 * cells, 49 * cells  # as rows 5-6
            fns = {
                f"{family}_shard_forward": (
                    f"{family}_forward_kernel", f["alpha_kernel"],
                    f["alpha_plain"], fwd_bytes, fwd_ops),
                f"{family}_shard_backward": (
                    f"{family}_backward_kernel",
                    lambda: f["grad_kernel"](alpha),
                    lambda: f["grad_plain"](alpha), bwd_bytes, bwd_ops),
            }
            iters = 200 if label == "main_path" else 20
            for kname, (symbol, kernel, plain, nbytes, nops) in fns.items():
                p1 = time_ms(plain, 3)
                k1 = time_ms(kernel, iters)
                k2 = time_ms(kernel, iters)
                p2 = time_ms(plain, 3)
                device_ms = kernel_device_ms(kernel, symbol)
                bytes_ms = nbytes / rate * 1e3
                ops_ms = nops / FP32_PEAK * 1e3
                row_out = {
                    "phase": "times", "kernel": kname, "shape": label,
                    "shard_shape_TBW": [t_s, mb, width],
                    "global_shape_TBLM": list(shape),
                    "kernel_ms": (k1 + k2) / 2, "kernel_ms_runs": [k1, k2],
                    "kernel_device_ms": device_ms,
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
    bench, the edge and the ring-edge shape, then its times in turns
    (plain, kernel, kernel, plain), its device time, its bound, its em ring
    depth (row 9; row 10 loads em inside the step) and, for copy and add,
    the PyTorch calls that compute the same function."""
    import torch

    from ctc_tpu_torch.ops import probe_cuda as pc

    rate = hbm_rate(name)
    result = {}
    for label, shape in (("bench", PROBE_SHAPE), ("edge", PROBE_EDGE),
                         ("ring_edge", PROBE_RING_EDGE)):
        cases, em = probe_cases(shape, "cuda")
        chunk = probe_chunk(shape[0])
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
            device_ms = kernel_device_ms(kernel, symbol)
            bytes_ms = nbytes / rate * 1e3
            ops_ms = nops / FP32_PEAK * 1e3
            bound_ms = max(bytes_ms, ops_ms)
            t_run = (shape[0] - shape[0] % chunk if kname == "probe_noout"
                     else shape[0])
            row = {
                "phase": "probes", "kernel": kname, "shape": label,
                "shape_TBL": list(shape), "l_pad": pc.pad_rows(shape[2]),
                "T_run": t_run,
                "chunk": chunk if kname == "probe_noout" else PROBE_CHUNK,
                "ring_depth": (None if symbol == "expdomain_kernel"
                               else pc.ring_plan(pc.pad_rows(shape[2]))[0]),
                "max_abs_dev": max_dev(got, want),
                "rtol_atol": [PROBE_RTOL, atol],
                "kernel_ms": (k1 + k2) / 2, "kernel_ms_runs": [k1, k2],
                "kernel_device_ms": device_ms,
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
    phase_step_vs_cpu()
    phase_seq_vs_plain()
    phase_profile()
    phase_profile("blank", BLANK_CLASSES, BLANK_MAIN_SHAPE)
    # the seq main-path step, and the unsharded step at the same shape
    for family, classes in (("noblank", 33), ("blank", BLANK_CLASSES)):
        T, B, L, M = SEQ_MAIN[family]
        phase_profile(family, classes, (T, B, L), microbatches=M)
        phase_profile(family, classes, (T, B, L))
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
            err = (err["final_max_abs_dev"] if kname.endswith("forward")
                   else err["grad_max_abs_dev"])
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
