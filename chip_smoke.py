"""Smoke run of ctc_tpu_torch on one CUDA card.

Builds the hand-written CUDA kernels from ``ctc_tpu_torch/csrc/``, holds
each against its plain PyTorch version on the card, trains the feature-mode
NoBlankCTC LSTM head through the command-line entry point at full width,
checks that the training went through the kernels, and times each kernel
beside its plain version and its bound.  Prints one JSON line per phase; the
last line is ``{"ok": true, "device": {...}}``.  Any failure exits non-zero.

Run from the repository root: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

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
}

# main path: the CLI's synthetic run at the LSTM head's full width
MAIN_ARGS = ["--dataset", "synthetic", "--batch-size", "256",
             "--temporal", "10", "--extract-feat-dim", "1024",
             "--epochs", "2", "--device", "cuda"]
MAIN_SHAPE = (10, 256, 10)  # T, B, L (L = max path = temporal)
BENCH_SHAPE = (128, 1024, 157)  # bench.py's no-blank lattice shape
FP32_PEAK = 67e12  # H100 SXM f32 outside the tensor cores (data sheet)


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


def phase_main_path():
    """The CLI's training run on the card; returns the launch counts."""
    import torch

    from ctc_tpu_torch.cli.main import main
    from ctc_tpu_torch.ops import lattice_cuda as lc

    with tempfile.TemporaryDirectory() as cache:
        lc.reset_launch_counts()
        t0 = time.perf_counter()
        history = main(MAIN_ARGS + ["--cache-dir", cache])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(lc.launch_counts)
        files = sorted(os.listdir(os.path.join(cache, "test")))
    epochs = len(history)
    train_steps, eval_steps = 8 * epochs, 2 * epochs  # the synthetic loader
    want = {"noblank_lattice_forward": train_steps + eval_steps,
            "noblank_lattice_backward": train_steps}
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


def phase_profile():
    """Where a main-path train step's time goes: the step's wall time with
    a synchronize at the end, then a torch.profiler window over the same
    steps for device time by kernel and the device's busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ctc_tpu_torch.data import synthetic_feature_batches
    from ctc_tpu_torch.models import LSTMHead
    from ctc_tpu_torch.train.trainer import (
        TrainState, make_train_step, to_device, torch_style_adam,
    )

    T, B, _ = MAIN_SHAPE
    batch = to_device(synthetic_feature_batches(
        num_batches=1, batch_size=B, temporal=T, feat_dim=1024,
        num_classes=33, seed=4)[0], "cuda")
    model = LSTMHead(1024, 33)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to("cuda")
    state = TrainState(model, torch_style_adam(model.parameters(), 1e-4))
    step = make_train_step("noblank", None, 0.0, lambda k: 1e-3)
    gen = torch.Generator(device="cuda").manual_seed(0)
    steps = 50
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
    lattice_us = sum(dev_us(e) for e in events if "noblank" in e.key)
    emit({"phase": "profile", "shape_TBL": list(MAIN_SHAPE),
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
    small shape is the host's launch rate instead)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in device_kernels(prof) if symbol in e.key]
    if not ev:
        return None
    return sum(dev_us(e) for e in ev) / sum(e.count for e in ev) / 1e3


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


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this needs a CUDA card")
    try:
        from ctc_tpu_torch.ops import lattice_cuda  # noqa: F401
    except ImportError as e:
        fail(f"run from the repository root; ctc_tpu_torch not importable "
             f"({e})")
    name = torch.cuda.get_device_name(0)
    card = card_line()
    emit({"phase": "device", "name": name, "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    phase_build()
    errs = phase_parity()
    launches = phase_main_path()
    phase_step_vs_cpu()
    phase_profile()
    times = phase_times(card, name)
    main_errs = errs["main_path"]
    kernels = []
    for kname, meta in KERNELS.items():
        t = times[(kname, "main_path")]
        kernels.append({
            "name": kname, **meta,
            "launches": launches[kname],
            "max_abs_err": (main_errs["nll_max_abs_dev"]
                            if kname.endswith("forward")
                            else main_errs["grad_max_abs_dev"]),
            "ms": t["kernel_ms"], "device_ms": t["kernel_device_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None,
        })
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
