"""Rows 3 and 7, the shard forward kernels, before and after their
redesign, side by side on one card.

    python -m ctc_tpu_torch.probes.shard_ab --parent DIR

``DIR`` holds a tree from before the redesign (``git archive <commit> |
tar -x -C DIR``).  Its ``ctc_tpu_torch/csrc/noblank_lattice.cu`` and
``blank_lattice.cu`` are compiled with the flags of ``ops/cuda_build.py``
into ``build/ctc_tpu_torch/parent/``, both at once, and their
``*_shard_forward`` launchers called with that tree's arguments: alpha
only, from a contiguous copy of em, with the final cell's gather and the
boundary row's copy left to torch ops, as that tree's shard op ran them.
"after" is this package's kernel, which reads the batch slice of em in
place and returns alpha, the final cell and the boundary row from one
launch.

For each family at the seq main path's shard shape and the long-T one
(``SHAPES``; em the second of four microbatches of a wider batch, as the
pipeline hands it in), it prints one JSON line per side: the kernel's
device time from ``torch.profiler`` (the median of ``WINDOWS`` windows,
taken twice in turns: before, after, after, before; each run's median and
the min and max of its windows), ``step_us``, the device kernels a call
launches and, on the "after" line, max |dev| of alpha, final and the
boundary row from the "before" side's.  Then one line per family and side
of the seq train step at the main path's shape (T=64, B=256, 4 shards;
noblank 8 microbatches, blank 4; the shard ops' forward done each way, the
rest unchanged; 20 steps after 5 warm-up, in turns): host ms per step,
and from a profiled window of the same steps, device ms per step, device
kernels per step, the device's busy share and the lattice kernels' device
us per step.  The first line is the card's name and power limit.  Card
only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import time
from pathlib import Path

import torch

from ctc_tpu_torch.losses.blank import blank_emissions_and_skip
from ctc_tpu_torch.ops import blank_lattice_cuda as bl
from ctc_tpu_torch.ops import cuda_build
from ctc_tpu_torch.ops import lattice_cuda as lc
from ctc_tpu_torch.ops.lattice_cuda import _check
from ctc_tpu_torch.ops.logspace import BLANK_NEG, NEG_SENTINEL
from ctc_tpu_torch.probes import max_abs_dev
from ctc_tpu_torch.probes.ring_sweep import card_line, device_ms
from ctc_tpu_torch.train.trainer import resolve_device

PARENT_BUILD = cuda_build.BUILD_DIR / "parent"
WINDOWS = 5
CLASSES = {"noblank": 33, "blank": 157}  # the smoke's heads
# [t_s, B, labels] of one shard launch: the seq main path's (T=64 over 4
# shards; noblank 8 microbatches of 32 at L=64, blank 4 of 64 at L=32, S=65)
# and bench_seq_scaling.py:30's long T (4096 over 4 shards, 4 microbatches
# of 4, L=24: noblank W=24, blank S=49)
SHAPES = {"noblank": {"main_path": (16, 32, 64), "long_T": (1024, 4, 24)},
          "blank": {"main_path": (16, 64, 32), "long_T": (1024, 4, 24)}}
STEP_SHAPE = {"noblank": (64, 256, 64, 8), "blank": (64, 256, 32, 4)}
MICROBATCHES = 4  # em is the second of this many microbatches
_P, _I = ctypes.c_void_p, ctypes.c_int
#: the earlier tree's shard forward launchers: em, [skip_ok,] tgt or
#: nothing, init rows, alpha, T, B, W, stream
OLD_SIGNATURES = {"noblank": (*(_P,) * 5, _I, _I, _I, _P),
                  "blank": (*(_P,) * 5, _I, _I, _I, _P)}


def compile_parent(parent: Path, sources: dict[str, str], edit=None,
                   tag="") -> dict[str, ctypes.CDLL]:
    """Compile ``ctc_tpu_torch/csrc/<sources[key]>`` of ``parent`` for each
    key (with ``edit(text, key)`` applied, where given), one ``nvcc`` each,
    all started together, with the parent's own headers first on the
    include path, into ``PARENT_BUILD`` as libraries named after the source
    and ``tag``; return each key's library, its launchers not yet typed."""
    csrc = parent / "ctc_tpu_torch" / "csrc"
    PARENT_BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for key, source in sources.items():
        src = csrc / source
        stem = Path(source).stem
        if edit is not None:
            text = edit(src.read_text(), key)
            src = PARENT_BUILD / f"{stem}{tag}.cu"
            src.write_text(text)
        out = PARENT_BUILD / f"{stem}{tag}.so"
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, f"-I{csrc}", "-o",
               str(out), str(src)]
        procs[key] = (out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the parent's {key}:\n{log}")
        libs[key] = ctypes.CDLL(str(out))
    return libs


def type_launcher(lib, name: str, argtypes) -> None:
    """Give ``lib``'s launcher ``name`` its argtypes; it returns a
    ``cudaError_t``."""
    fn = getattr(lib, name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int


def build_parent(parent: Path, symbol="shard_forward", edit=None, tag="",
                 signatures=None) -> dict[str, ctypes.CDLL]:
    """Compile both lattice sources of ``parent`` (:func:`compile_parent`)
    and return each family's library with its ``*_<symbol>`` launcher typed
    as ``signatures[family]`` (default ``OLD_SIGNATURES``, the shard
    forward's)."""
    signatures = signatures or OLD_SIGNATURES
    libs = compile_parent(
        parent, {family: f"{family}_lattice.cu" for family in OLD_SIGNATURES},
        edit, tag)
    for family, lib in libs.items():
        type_launcher(lib, f"{family}_{symbol}", signatures[family])
    return libs


def old_forward(family, lib):
    """The earlier tree's shard forward with the package's
    ``*_shard_forward_kernel`` arguments and outputs: em copied to a
    contiguous tensor, its kernel for alpha, then ``gather_final`` and the
    boundary row's copy as torch ops."""
    name = f"{family}_shard_forward"
    fn = getattr(lib, name)

    def launch(operands, em):
        alpha = torch.empty_like(em)
        stream = torch.cuda.current_stream(em.device).cuda_stream
        _check(fn(*(t.data_ptr() for t in operands), alpha.data_ptr(),
                  *em.shape, stream), name)
        return alpha

    if family == "noblank":
        def forward(em, inlen, tgt, stay0, adv0):
            em = em.contiguous()
            alpha = launch((em, tgt, stay0, adv0), em)
            return (alpha, lc.gather_final(alpha, inlen, tgt),
                    alpha[-1].clone())
    else:
        def forward(em, skip, inlen, tgt, init0, skip0):
            em = em.contiguous()
            alpha = launch((em, skip, init0, skip0), em)
            return (alpha, bl.gather_final(alpha, inlen, tgt),
                    alpha[-1].clone())
    return forward


def make_case(family, shape, device, seed):
    """The operands of one shard (as ``chip_smoke.py``'s random case): em
    the second of ``MICROBATCHES`` batch slices of a wider batch, shard-local
    input lengths below 1, inside the shard and above it, random init rows
    with unreached cells at the sentinel, and both cotangents.  Returns
    ``(forward operands, backward operands but alpha)``: the arguments of
    ``*_shard_forward_kernel`` and, after alpha, of
    ``*_shard_grad_kernel``."""
    t_s, batch, labels = shape
    wide = MICROBATCHES * batch
    gen = torch.Generator().manual_seed(seed)
    skip = None
    if family == "noblank":
        width, neg = labels, NEG_SENTINEL
        em = torch.randn((t_s, wide, width), generator=gen) - 1.0
        tgt = torch.randint(1, width + 1, (batch,), generator=gen)
    else:
        width, neg = 2 * labels + 1, BLANK_NEG
        logits = torch.randn((t_s, wide, CLASSES["blank"]), generator=gen)
        targets = torch.randint(1, CLASSES["blank"], (wide, labels),
                                generator=gen)
        em, skip = blank_emissions_and_skip(logits, targets, 0,
                                            normalize=True)
        skip = skip[batch:2 * batch].to(torch.uint8).to(device)
        tgt = torch.randint(1, labels + 1, (batch,), generator=gen)
    inlen = torch.randint(-(t_s // 2), 2 * t_s + 1, (batch,), generator=gen)
    inlen[0] = t_s
    r0, r1 = (3.0 * torch.randn((batch, width), generator=gen) - 8.0
              for _ in range(2))
    r0[::2, -2:] = neg
    r1[::2, -2:] = neg
    final_bar = torch.randn((batch,), generator=gen)
    g_seed = torch.randn((batch, width), generator=gen)
    em = em.to(device)[:, batch:2 * batch]
    r0, r1, final_bar, g_seed = (x.contiguous().to(device) for x in (
        r0, r1, final_bar, g_seed))
    inlen, tgt = inlen.int().to(device), tgt.int().to(device)
    head = (inlen, tgt) if family == "noblank" else (skip, inlen, tgt)
    return (em, *head, r0, r1), (*head, final_bar, g_seed, r0, r1)


def windows_ms(fn, symbol):
    """The median, min and max over ``WINDOWS`` profiled windows of
    ``fn``'s mean device time of ``symbol``."""
    got = [ms for ms in (device_ms(fn, symbol) for _ in range(WINDOWS))
           if ms is not None]
    if not got:
        return None, None
    return statistics.median(got), [min(got), max(got)]


def _device_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def device_events(prof):
    """The device kernels of a profile (not the CPU ops and annotations
    that carry their time again)."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and _device_us(e) > 0]


def kernels_per_call(fn, iters=20):
    """Device kernels (of any name) that one call of ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.count for e in device_events(prof)) / iters


def kernels(family, shape, old_fwd, card):
    """The before and after rows of one family at one shard shape."""
    args, _ = make_case(family, shape, "cuda", seed=sum(shape))
    new_fwd = (lc.noblank_shard_forward_kernel if family == "noblank"
               else bl.blank_shard_forward_kernel)
    sides = {"before": (lambda: old_fwd(*args), f"{family}_forward_kernel"),
             "after": (lambda: new_fwd(*args),
                       f"{family}_shard_forward_kernel")}
    runs = {side: [] for side in sides}
    for side in ("before", "after", "after", "before"):
        fn, symbol = sides[side]
        fn()
        runs[side].append(windows_ms(fn, symbol))
    want, got = old_fwd(*args), new_fwd(*args)
    torch.cuda.synchronize()
    t_s = args[0].shape[0]
    rows = []
    for side, (fn, _) in sides.items():
        medians = [m for m, _ in runs[side]]
        row = {"probe": "shard_ab", "family": family,
               "kernel": f"{family}_shard_forward", "side": side,
               "shard_shape_TBW": list(args[0].shape),
               "em_strides": list(args[0].stride()),
               "device_ms_runs": medians,
               "device_ms_min_max_runs": [mm for _, mm in runs[side]],
               "step_us_runs": [m * 1e3 / t_s if m is not None else None
                                for m in medians],
               "device_kernels_per_call": kernels_per_call(fn),
               "windows": WINDOWS, "card": card}
        if side == "after":
            row["max_abs_dev_from_before"] = {
                name: max_abs_dev(a, b)
                for name, a, b in zip(("alpha", "final", "boundary"), got,
                                      want)}
        rows.append(row)
    return rows


def train_step(family, shape, microbatches=None, steps=20):
    """A train step at ``shape`` (T, B, L; the sequence-sharded loss over 4
    shards with ``microbatches``, else the unsharded one) and a call that
    runs ``steps`` of them and returns ``(host ms per step, device ms per
    step, kernels per step, busy share, lattice kernels' device us per
    step)``; the lattice kernels are those
    :func:`~ctc_tpu_torch.ops.lattice_cuda.lattice_kernel_symbol` names."""
    from torch.profiler import ProfilerActivity, profile

    from ctc_tpu_torch.data import synthetic_feature_batches
    from ctc_tpu_torch.models import LSTMHead
    from ctc_tpu_torch.parallel import make_seq_mesh, make_seq_sharded_loss
    from ctc_tpu_torch.train.trainer import (
        TrainState, make_train_step, to_device, torch_style_adam,
    )

    T, B, L = shape
    classes = CLASSES[family]
    batch = to_device(synthetic_feature_batches(
        num_batches=1, batch_size=B, temporal=T, feat_dim=1024,
        num_classes=classes, max_path=L, seed=4)[0], "cuda")
    model = LSTMHead(1024, classes)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to("cuda")
    state = TrainState(model, torch_style_adam(model.parameters(), 1e-4))
    loss_fn = None
    if microbatches:
        loss_fn = make_seq_sharded_loss(make_seq_mesh(4, "cuda"), family,
                                        num_microbatches=microbatches)
    step = make_train_step(family, None, 0.0, lambda k: 1e-3,
                           loss_fn=loss_fn)
    gen = torch.Generator(device="cuda").manual_seed(0)
    symbol = lc.lattice_kernel_symbol(family)

    def run():
        for _ in range(5):
            step(state, batch, gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step(state, batch, gen)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / steps * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                step(state, batch, gen)
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
        events = device_events(prof)
        busy_ms = sum(_device_us(e) for e in events) / 1e3
        lattice_us = sum(_device_us(e) for e in events
                         if symbol.search(e.key))
        return (host_ms, busy_ms / steps,
                sum(e.count for e in events) / steps, busy_ms / window_ms,
                lattice_us / steps)

    return run


def steps(family, old_fwd, card):
    """The seq train step with the shard ops' forward done each way."""
    module = lc if family == "noblank" else bl
    name = f"{family}_shard_forward_kernel"
    new_fwd = getattr(module, name)
    T, B, L, M = STEP_SHAPE[family]
    run = train_step(family, (T, B, L), M)
    runs = {"before": [], "after": []}
    for side in ("before", "after", "after", "before"):
        setattr(module, name, old_fwd if side == "before" else new_fwd)
        try:
            runs[side].append(run())
        finally:
            setattr(module, name, new_fwd)
    T, B, L, M = STEP_SHAPE[family]
    return [{"probe": "shard_ab_step", "family": family, "side": side,
             "shape_TBLM": [T, B, L, M], "shards": 4,
             "step_ms_runs": [r[0] for r in got],
             "device_ms_per_step_runs": [r[1] for r in got],
             "kernels_per_step_runs": [r[2] for r in got],
             "device_busy_share_runs": [r[3] for r in got],
             "lattice_us_per_step_runs": [r[4] for r in got], "card": card}
            for side, got in runs.items()]


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(prog="python -m ctc_tpu_torch.probes.shard_ab",
                                description=__doc__.splitlines()[0])
    p.add_argument("--parent", required=True, type=Path,
                   help="a tree from before the redesign")
    args = p.parse_args(argv)
    resolve_device("cuda")
    card = card_line()
    print(card, flush=True)
    old = build_parent(args.parent)
    rows = []
    for family in OLD_SIGNATURES:
        old_fwd = old_forward(family, old[family])
        for part in [kernels(family, shape, old_fwd, card)
                     for shape in SHAPES[family].values()] + [
                         steps(family, old_fwd, card)]:
            for row in part:
                print(json.dumps(row), flush=True)
            rows += part
    return rows


if __name__ == "__main__":
    main()
