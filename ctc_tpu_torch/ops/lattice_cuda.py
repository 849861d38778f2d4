"""Blank-free CTC lattice DP: the two CUDA kernels and their plain version.

Port of ``ctc_tpu/ops/lattice_pallas.py`` (kernels) and
``ctc_tpu/ops/lattice_xla.py`` (plain version).  The lattice is the
(T x L) grid of (time step, label-path position) with only ``stay``
(l -> l) and ``advance`` (l-1 -> l) transitions::

    alpha[t, l] = em[t, l] + logaddexp(alpha[t-1, l], alpha[t-1, l-1])

with cells at ``l >= target_length`` set to the -1e13 sentinel before the
emission add.  The per-sample NLL is ``-alpha[input_length-1,
target_length-1]``; the gradient is the analytic posterior recursion over
the same lattice.  The forward kernel writes the NLL beside alpha
(:func:`gather_nll` runs on the plain path only).

* :func:`noblank_lattice_nll_cuda` launches the kernels of
  ``csrc/noblank_lattice.cu`` on a CUDA tensor and runs the plain version on
  a CPU tensor.  It takes nothing else and never falls back.
* :func:`noblank_lattice_nll_plain` is the plain PyTorch version on any
  device: the CPU path, and the oracle the kernels are held to.

One T-shard of the sequence-parallel pipeline (port of
``noblank_shard_lattice_pallas``) is the same recursion with its two
boundaries handed in: ``stay0`` seeds the carry and ``adv0`` is the advance
source of the first local step.  :func:`noblank_shard_lattice_cuda` and
:func:`noblank_shard_lattice_plain` return ``(final [B], boundary_out [B,
L])``: the final log-prob ``alpha[inlen_local-1, b, tgt-1]`` (0 unless ``1 <=
inlen_local <= t_s``) and the last alpha row.  The shard forward kernel
writes both beside alpha and reads a batch slice of em in place; its plain
version :func:`noblank_shard_forward_plain` returns the same triple.  The
whole lattice is the shard whose init rows are :func:`noblank_alpha_init`
and the sentinel row.
"""

from __future__ import annotations

import re

import torch

from ctc_tpu_torch.ops.logspace import NEG_SENTINEL

#: launches of each kernel, counted where the wrapper launches it
launch_counts = {"noblank_lattice_forward": 0, "noblank_lattice_backward": 0,
                 "noblank_shard_forward": 0, "noblank_shard_backward": 0}

_SOURCE = "noblank_lattice.cu"

#: shared memory one block may use on Hopper (227 KB)
SMEM_LIMIT = 232_448
#: the alpha chunks (rows) the shard backward kernels are built for,
#: largest first
SHARD_CHUNKS = (16, 4, 1)
#: the shard backward's block (its launch bounds): a chunk's weights
#: spread over all of it, and the kernel ran faster with more threads up
#: to 512 (PERF.md, PR 6)
SHARD_THREADS = 512
#: the em ring depths (rows) the shard forward kernels are built for,
#: deepest first
SHARD_DEPTHS = (8, 2)
#: static shared memory of the shard forward's block kernels (the final
#: cells, as ptxas lays them out)
SHARD_FORWARD_STATIC_BYTES = 16
#: the halo lanes of the shard forward's warps layout (the kernels'
#: kHalo), noblank and blank: a warp of a row wider than 32 cells owns
#: 32 - halo cells and carries the halo before them
WARPS_HALO = {False: 8, True: 16}
#: the whole-lattice backward kernels' layouts, in the order of the
#: kernels' kLayout: the row loop (alpha read in the step); two cells a
#: lane, one block a sample (warps); alpha staged in chunks and weighted by
#: the block, stepped by one warp (chunks_warp)
BACKWARD_LAYOUTS = ("rows", "warps", "chunks_warp")
#: the widest row of the chunks-warp layout (one warp) and of the warps
#: layout (16 warps of two cells a lane)
BACKWARD_NARROW_WIDTH = 32
BACKWARD_WARPS_WIDTH = 1024
#: the chunks-warp layout's block and alpha chunk (rows), and the warps
#: layout's alpha chunk (its weights live in registers)
BACKWARD_NARROW_THREADS = 128
BACKWARD_NARROW_CHUNK = 16
BACKWARD_WARPS_CHUNK = 8
#: the most threads of a block of the rows layout (its launch bounds)
BACKWARD_ROWS_THREADS = 1024
#: the whole-lattice forward kernels' layouts, in the order of the kernels'
#: kLayout: the row loop (em read in the step); a sample a warp and a lane
#: a cell (warp); two cells a lane, one block a sample (pairs); the shard
#: forward's block layout, em on a ring of shared rows (block)
FORWARD_LAYOUTS = ("rows", "warp", "pairs", "block")
#: the widest row of the warp layout (one warp) and of the pairs layout
#: (16 warps of two cells a lane)
FORWARD_WARP_WIDTH = 32
FORWARD_PAIRS_WIDTH = 1024
#: the em ring's rows in the warp and pairs layouts (16 and 32 ran no
#: faster; PERF.md §6)
FORWARD_DEPTH = 8
#: the warp layout's block: a sample a warp, four a block (1-2% faster than
#: one at the main shapes; PERF.md §6)
FORWARD_WARP_THREADS = 128


def lattice_kernel_symbol(family: str) -> re.Pattern:
    """The profiler names of ``family``'s (``noblank`` or ``blank``)
    lattice kernels, the forward and backward and their shard twins, whose
    device time a profile's ``lattice_us_per_step`` sums."""
    return re.compile(rf"(?<![a-z]){family}_(shard_)?(forward|backward)"
                      r"_kernel")


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# ---------------------------------------------------------------------------
# plain version ([T, B, L], any device)
# ---------------------------------------------------------------------------


def _shift_right(x: torch.Tensor) -> torch.Tensor:
    """``out[..., l] = x[..., l-1]``, the sentinel at ``l = 0``."""
    pad = torch.full_like(x[..., :1], NEG_SENTINEL)
    return torch.cat([pad, x[..., :-1]], dim=-1)


def noblank_alpha_init(batch, width, *, dtype=torch.float32, device=None):
    """The ``alpha(-1)`` row ``[B, W]``: 0 at ``l = 0``, the sentinel
    elsewhere (shard 0's ``stay0``)."""
    row = torch.full((batch, width), NEG_SENTINEL, dtype=dtype, device=device)
    row[:, 0] = 0.0
    return row


def noblank_alpha_plain(em, target_lengths):
    """The full alpha lattice ``[T, B, L]`` (the backward's residual)."""
    _, batch, max_l = em.shape
    stay0 = noblank_alpha_init(batch, max_l, dtype=em.dtype, device=em.device)
    # t == 0 has no advance branch; the sentinel row is still log-added
    adv0 = torch.full_like(stay0, NEG_SENTINEL)
    return noblank_shard_alpha_plain(em, target_lengths, stay0, adv0)


def noblank_shard_alpha_plain(em, target_lengths, stay0, adv0):
    """alpha ``[t_s, B, L]`` of one T-shard: ``stay0 [B, L]`` is the carry
    before the first local step, ``adv0 [B, L]`` that step's advance
    source (shifted here; no ``t > 0`` gate)."""
    max_l = em.shape[2]
    pos = torch.arange(max_l, device=em.device)
    outside = pos[None, :] >= target_lengths[:, None]
    alpha = stay0
    rows = []
    for t in range(em.shape[0]):
        advance = _shift_right(alpha if t > 0 else adv0)
        lse = torch.logaddexp(alpha, advance)
        lse = torch.where(outside, NEG_SENTINEL, lse)
        alpha = lse + em[t]
        rows.append(alpha)
    return torch.stack(rows)


def noblank_shard_forward_plain(em, input_lengths, target_lengths, stay0,
                                adv0):
    """``(alpha [t_s, B, L], final [B], boundary [B, L])`` of one T-shard:
    the recursion from the init rows, :func:`gather_final` with the
    shard-local ``input_lengths``, and the last alpha row (the kernel's
    three outputs)."""
    alpha = noblank_shard_alpha_plain(em, target_lengths, stay0, adv0)
    return (alpha, gather_final(alpha, input_lengths, target_lengths),
            alpha[-1].clone())


def noblank_grad_plain(alpha, input_lengths, target_lengths, nll_bar):
    """``g = d(sum nll * nll_bar) / d em`` from the alpha lattice."""
    return noblank_shard_grad_plain(alpha, input_lengths, target_lengths,
                                    -nll_bar, torch.zeros_like(alpha[0]))


def noblank_shard_grad_plain(alpha, input_lengths, target_lengths, final_bar,
                             g_seed):
    """``g`` of one T-shard: ``final_bar [B]`` is the cotangent of the
    final log-prob (injected at ``t == inlen_local - 1`` only), ``g_seed
    [B, L]`` that of the outgoing boundary row (added at the last local
    row)."""
    max_t, batch, max_l = alpha.shape
    pos = torch.arange(max_l, device=alpha.device)
    inside = (pos[None, :] < target_lengths[:, None]).to(alpha.dtype)
    inject = torch.where(
        pos[None, :] == (target_lengths - 1)[:, None], final_bar[:, None], 0.0
    ).to(alpha.dtype)  # [B, L], lands at t == input_length - 1
    zero = torch.zeros((batch, 1), dtype=alpha.dtype, device=alpha.device)
    g_next = torch.zeros((batch, max_l), dtype=alpha.dtype,
                         device=alpha.device)
    rows = [None] * max_t
    for t in range(max_t - 1, -1, -1):
        g_t = torch.where((input_lengths - 1 == t)[:, None], inject, 0.0)
        if t == max_t - 1:
            g_t = g_t + g_seed
        else:
            # weights of the step t -> t+1, read off alpha[t] as
            # sigmoid(stay - advance): on degenerate lattices both branches
            # are exactly the sentinel and the split must be 1/2, 1/2
            w_raw = torch.sigmoid(alpha[t] - _shift_right(alpha[t]))
            w_stay = w_raw * inside
            w_adv = (1.0 - w_raw) * inside
            from_adv = g_next * w_adv
            g_t = g_t + (
                g_next * w_stay + torch.cat([from_adv[:, 1:], zero], dim=1)
            )
        rows[t] = g_t
        g_next = g_t
    return torch.stack(rows)


def init_row_grads(g0, stay0, adv0, target_lengths):
    """``(d stay0, d adv0)`` from ``g0``, the gradient of the first local
    alpha row: one step of the same sigmoid branch weights."""
    pos = torch.arange(g0.shape[1], device=g0.device)
    inside = (pos[None, :] < target_lengths[:, None]).to(g0.dtype)
    w_raw = torch.sigmoid(stay0 - _shift_right(adv0))
    d_stay0 = g0 * w_raw * inside
    d_shift = g0 * (1.0 - w_raw) * inside
    d_adv0 = torch.cat([d_shift[:, 1:], torch.zeros_like(d_shift[:, :1])],
                       dim=1)
    return d_stay0, d_adv0


def gather_final(alpha, input_lengths, target_lengths):
    """``alpha[inlen-1, b, tgt-1]``; 0 where ``inlen`` is outside ``[1,
    T]`` (the XLA path's final cell is never set there, and in a shard the
    sample's final cell lies on another shard)."""
    max_t, batch, max_l = alpha.shape
    t_idx = (input_lengths - 1).clamp(0, max_t - 1).long()
    l_idx = (target_lengths - 1).clamp(0, max_l - 1).long()
    b_idx = torch.arange(batch, device=alpha.device)
    final = alpha[t_idx, b_idx, l_idx]
    own = (input_lengths >= 1) & (input_lengths <= max_t)
    return torch.where(own, final, 0.0)


def gather_nll(alpha, input_lengths, target_lengths):
    """``nll[b] = -alpha[inlen-1, b, tgt-1]``; 0 where ``inlen`` is outside
    ``[1, T]``."""
    return -gather_final(alpha, input_lengths, target_lengths)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {rc}")


def _require(kernel: str, **tensors) -> None:
    """Raise unless every operand is a contiguous CUDA tensor of the type
    the kernel reads (int32 lengths, a uint8 ``skip_ok`` mask, float32
    otherwise) on one device."""
    device = None
    for name, t in tensors.items():
        want = (torch.int32 if name.endswith("lengths")
                else torch.uint8 if name == "skip_ok" else torch.float32)
        if not (t.is_cuda and t.dtype == want and t.is_contiguous()):
            raise ValueError(
                f"{kernel}: {name} must be a contiguous CUDA {want} tensor, "
                f"got {t.dtype} on {t.device}"
                + ("" if t.is_contiguous() else " (not contiguous)")
            )
        if device is not None and t.device != device:
            raise ValueError(f"{kernel}: operands on {device} and {t.device}")
        device = t.device


def launch(source, name, counts, operands, out, dims):
    """Launch ``name`` from ``csrc/<source>`` on the current stream of the
    output's device: pointers of ``operands`` then of ``out`` (one tensor,
    or a tuple of them), then the int ``dims``; raise on a refused launch
    and count it in ``counts``.  Returns ``out``."""
    from ctc_tpu_torch.ops import cuda_build

    outs = (out,) if isinstance(out, torch.Tensor) else tuple(out)
    lib = cuda_build.load(source)
    with torch.cuda.device(outs[0].device):
        stream = torch.cuda.current_stream(outs[0].device).cuda_stream
        rc = getattr(lib, name)(*(t.data_ptr() for t in operands),
                                *(t.data_ptr() for t in outs), *dims, stream)
    _check(rc, name)
    counts[name] += 1
    return out


def forward_bytes(layout: str, width: int, depth: int, threads: int,
                  blank: bool = False) -> int:
    """Dynamic shared memory of a whole-lattice forward launch in
    ``layout``: in the warp layout each thread's ``depth`` em ring slots;
    in the pairs layout each thread's two ring columns of ``depth`` slots
    and two exchange rows of 1 (blank 2) slots a warp (the kernels'
    ``kForwardExchange``); in the block layout
    ``2 + depth`` rows of floats (the kernels'
    ``shard_forward_floats_per_cell``); in the rows layout the two carried
    rows; blank adds the skip mask's byte a cell to the last two."""
    if layout == "warp":
        return 4 * depth * threads
    if layout == "pairs":
        return 4 * 2 * (depth * threads + threads // 32 * (1 + blank))
    if layout == "block":
        return (4 * (2 + depth) + blank) * width
    if layout == "rows":
        return (4 * 2 + blank) * width
    raise ValueError(f"unknown forward layout {layout!r}: "
                     f"{', '.join(FORWARD_LAYOUTS)}")


def pairs_threads(width: int, blank: bool = False) -> int:
    """Threads of the forward's pairs layout at lattice width ``width``: two
    cells a lane, in whole warps; noblank's pairs are cells -1 .. width-1
    (8-byte aligned, a row that starts at an odd float pairs its first cell
    with the one before it)."""
    return -(-(width + (not blank)) // 64) * 32


def block_depth(width: int, blank: bool = False) -> int | None:
    """The em ring of the block layout (the shard forward's, and the
    whole-lattice forward's) at width ``width``: the deepest of
    ``SHARD_DEPTHS`` whose rows fit beside the carried rows and
    ``SHARD_FORWARD_STATIC_BYTES`` in ``SMEM_LIMIT`` (8 up to 5810 noblank
    and 5669 blank, then 2 up to 14527 and 13672), else None."""
    threads = min(-(-width // 32) * 32, 1024)
    for depth in SHARD_DEPTHS:
        if (forward_bytes("block", width, depth, threads, blank)
                <= SMEM_LIMIT - SHARD_FORWARD_STATIC_BYTES):
            return depth
    return None


def forward_plan(width: int,
                 blank: bool = False) -> tuple[str, int, int, int]:
    """``(layout, depth, threads, shared bytes)`` of the noblank (``blank``
    False) or blank whole-lattice forward kernel at lattice width
    ``width``.

    Rows of up to ``FORWARD_WARP_WIDTH`` cells take the warp layout (a
    sample a warp, ``FORWARD_WARP_THREADS`` threads a block, em on a
    ``FORWARD_DEPTH``-row ring); rows of up to ``FORWARD_PAIRS_WIDTH`` the
    pairs layout (:func:`pairs_threads`, the same ring).  Wider rows take
    the block layout (the row in whole warps up to 1024 threads, which
    stride over wider rows; the ring :func:`block_depth` rows deep) while
    it fits, then the rows layout (the first kernels' row loop, em read in
    the step) up to the widths whose two rows fit in ``SMEM_LIMIT`` (29056
    noblank, 25827 blank), every width the first kernels took; raises
    ``ValueError`` above them."""
    if width <= FORWARD_WARP_WIDTH:
        depth, threads = FORWARD_DEPTH, FORWARD_WARP_THREADS
        return ("warp", depth, threads,
                forward_bytes("warp", width, depth, threads, blank))
    if width <= FORWARD_PAIRS_WIDTH:
        depth, threads = FORWARD_DEPTH, pairs_threads(width, blank)
        return ("pairs", depth, threads,
                forward_bytes("pairs", width, depth, threads, blank))
    threads = min(-(-width // 32) * 32, 1024)
    depth = block_depth(width, blank)
    if depth is not None:
        return ("block", depth, threads,
                forward_bytes("block", width, depth, threads, blank))
    smem = forward_bytes("rows", width, 0, 0, blank)
    if smem <= SMEM_LIMIT:
        return "rows", 0, threads, smem
    raise ValueError(
        f"lattice width {width}: the forward's two carried rows do not fit "
        f"in the {SMEM_LIMIT} bytes of shared memory a block may use")


def forward_dims(shape, plan) -> tuple[int, ...]:
    """The int arguments of a whole-lattice forward launch: ``T, B, W``,
    then ``plan`` with its layout as the kernels' number."""
    layout, depth, threads, smem = plan
    return (*shape, FORWARD_LAYOUTS.index(layout), depth, threads, smem)


def forward_operand(em, plan):
    """em as the noblank forward kernel in ``plan`` reads it: the pairs
    layout reads em in 8-byte pairs, so an em whose base is not 8-byte
    aligned (a slice of a wider tensor) is copied; torch's allocations
    are aligned."""
    if plan[0] == "pairs" and em.data_ptr() % 8:
        return em.clone()
    return em


def forward_outputs(em):
    """The forward kernels' outputs for em ``[T, B, W]``: alpha and nll
    ``[B]``."""
    return (torch.empty_like(em),
            torch.empty((em.shape[1],), dtype=em.dtype, device=em.device))


def noblank_alpha_kernel(em, input_lengths, target_lengths):
    """Launch the forward kernel in :func:`forward_plan`'s layout for the
    width: ``(alpha [T, B, L], nll [B])`` from em ``[T, B, L]``, nll as
    :func:`gather_nll` computes it."""
    plan = forward_plan(em.shape[2])
    _require("noblank_lattice_forward", em=em, input_lengths=input_lengths,
             target_lengths=target_lengths)
    em = forward_operand(em, plan)
    return launch(_SOURCE, "noblank_lattice_forward", launch_counts,
                  (em, input_lengths, target_lengths), forward_outputs(em),
                  forward_dims(em.shape, plan))


def backward_bytes(layout: str, width: int, chunk: int, threads: int,
                   blank: bool = False) -> int:
    """Dynamic shared memory of a whole-lattice backward launch in
    ``layout``: in the warps layout each thread's two staging columns of
    ``chunk`` rows of two cells, two of ``chunk`` rows of 1 (blank 2) halo
    cells a warp and two exchange rows of 1 (blank 3) slots a warp (the
    kernels' ``kBackwardHalo``, ``kBackwardExchange``); in the chunks-warp
    layout two staged alpha chunks, the chunk's 2 (blank 3) weight rows a
    row and the carried g double buffer, ``(4 + blank) * chunk + 2`` floats
    a cell (the kernels' ``chunked_floats_per_cell``); in the rows layout
    the two carried rows; blank adds the skip mask's byte a cell to the
    last two."""
    if layout == "warps":
        warps = threads // 32
        return 4 * 2 * (chunk * (2 * threads + warps * (1 + blank))
                        + warps * (1 + 2 * blank))
    if layout == "chunks_warp":
        return (4 * ((4 + blank) * chunk + 2) + blank) * width
    if layout == "rows":
        return (4 * 2 + blank) * width
    raise ValueError(f"unknown backward layout {layout!r}: "
                     f"{', '.join(BACKWARD_LAYOUTS)}")


def backward_plan(width: int,
                  blank: bool = False) -> tuple[str, int, int, int]:
    """``(layout, chunk, threads, shared bytes)`` of the noblank (``blank``
    False) or blank whole-lattice backward kernel at lattice width
    ``width``.

    Rows of up to ``BACKWARD_NARROW_WIDTH`` cells take the chunks-warp
    layout (``BACKWARD_NARROW_THREADS`` threads stage and weight 16-row
    chunks, one warp steps); rows of up to ``BACKWARD_WARPS_WIDTH`` the
    warps layout (two cells a lane, in whole warps, 8-row chunks).
    Wider rows take the rows layout (the first kernels' row loop, the row
    in whole warps up to ``BACKWARD_ROWS_THREADS``, which stride over wider
    rows) up to the widths whose two rows fit in ``SMEM_LIMIT`` (29056
    noblank, 25827 blank), every width the first kernels took; raises
    ``ValueError`` above them."""
    row_threads = -(-width // 32) * 32
    if width <= BACKWARD_NARROW_WIDTH:
        chunk, threads = BACKWARD_NARROW_CHUNK, BACKWARD_NARROW_THREADS
        return ("chunks_warp", chunk, threads,
                backward_bytes("chunks_warp", width, chunk, threads, blank))
    if width <= BACKWARD_WARPS_WIDTH:
        chunk, threads = BACKWARD_WARPS_CHUNK, -(-width // 64) * 32
        return ("warps", chunk, threads,
                backward_bytes("warps", width, chunk, threads, blank))
    smem = backward_bytes("rows", width, 0, 0, blank)
    if smem <= SMEM_LIMIT:
        return ("rows", 0, min(row_threads, BACKWARD_ROWS_THREADS), smem)
    raise ValueError(
        f"lattice width {width}: the backward's two carried rows do not fit "
        f"in the {SMEM_LIMIT} bytes of shared memory a block may use")


def backward_dims(shape, plan) -> tuple[int, ...]:
    """The int arguments of a whole-lattice backward launch: ``T, B, W``,
    then ``plan`` with its layout as the kernels' number."""
    layout, chunk, threads, smem = plan
    return (*shape, BACKWARD_LAYOUTS.index(layout), chunk, threads, smem)


def noblank_grad_kernel(alpha, input_lengths, target_lengths, nll_bar):
    """Launch the backward kernel: g ``[T, B, L]`` from alpha, in
    :func:`backward_plan`'s layout for the width."""
    plan = backward_plan(alpha.shape[2])
    _require("noblank_lattice_backward", alpha=alpha,
             input_lengths=input_lengths, target_lengths=target_lengths,
             nll_bar=nll_bar)
    return launch(_SOURCE, "noblank_lattice_backward", launch_counts,
                  (alpha, input_lengths, target_lengths, nll_bar),
                  torch.empty_like(alpha), backward_dims(alpha.shape, plan))


def shard_forward_threads(width: int, blank: bool = False) -> int | None:
    """Threads of a shard forward kernel's warps layout at lattice width
    ``width`` (one lane a cell: one warp up to 32 cells, else warps that
    each own ``32 - halo`` cells, ``WARPS_HALO``), or None past
    ``32 * (32 - halo)`` cells, where the block layout takes the row."""
    own = 32 - WARPS_HALO[blank]
    if width <= 32:
        return 32
    if width <= 32 * own:
        return 32 * -(-width // own)
    return None


def shard_forward_bytes(width: int, depth: int, threads: int,
                        blank: bool = False) -> int:
    """Dynamic shared memory of a shard forward launch: in the warps
    layout each thread's ``depth`` em ring slots and two exchange rows of
    ``width`` floats; in the block layout, ``2 + depth`` rows of floats and
    (blank) the skip mask's byte per cell (the kernels'
    ``shard_forward_floats_per_cell``)."""
    if shard_forward_threads(width, blank) is not None:
        return 4 * (depth * threads + 2 * width)
    return (4 * (2 + depth) + int(blank)) * width


def shard_forward_plan(width: int,
                       blank: bool = False) -> tuple[int, int, int]:
    """``(depth, threads, shared bytes)`` of the noblank (``blank`` False)
    or blank shard forward kernel at lattice width ``width``.

    Rows of up to 768 cells (noblank) or 512 (blank) take the warps layout
    (:func:`shard_forward_threads`) and an em ring 8 rows deep.  Wider rows
    take the block layout: the row in whole warps, at most 1024 threads,
    which stride over wider rows, and a ring ``depth`` rows deep, the
    deepest of ``SHARD_DEPTHS`` that fits beside the carried rows and
    ``SHARD_FORWARD_STATIC_BYTES`` of static shared memory in
    ``SMEM_LIMIT`` (8 up to width 5810 noblank and 5669 blank, then 2).
    Raises ``ValueError`` above the widths where a two-row ring does not fit
    (14527 noblank, 13672 blank)."""
    threads = shard_forward_threads(width, blank)
    if threads is not None:
        depth = SHARD_DEPTHS[0]
        return depth, threads, shard_forward_bytes(width, depth, threads,
                                                   blank)
    threads = min(-(-width // 32) * 32, 1024)
    depth = block_depth(width, blank)
    if depth is not None:
        return depth, threads, shard_forward_bytes(width, depth, threads,
                                                   blank)
    raise ValueError(
        f"lattice width {width}: the shard forward's carried rows and em "
        f"ring do not fit in the {SMEM_LIMIT} bytes of shared memory a "
        "block may use")


def _rows_side_by_side(em) -> bool:
    """Whether the rows ``em[t, b]`` of em ``[T, B, W]`` are contiguous and
    lie side by side in ``b`` (a batch slice of a contiguous tensor)."""
    _, batch, width = em.shape
    return ((width == 1 or em.stride(2) == 1)
            and (batch == 1 or em.stride(1) == width))


def _require_rows(kernel: str, em) -> None:
    """Raise unless em is a CUDA float32 tensor the shard forward kernels
    read in place (rows side by side; the row stride is passed on)."""
    if not (em.is_cuda and em.dtype == torch.float32):
        raise ValueError(f"{kernel}: em must be a CUDA float32 tensor, got "
                         f"{em.dtype} on {em.device}")
    if not _rows_side_by_side(em):
        raise ValueError(f"{kernel}: em's rows must be contiguous and side "
                         f"by side, got strides {em.stride()}")


def rows_layout(em):
    """em as the shard forward kernels read it: itself where its rows are
    side by side (the pipeline's batch slices), else a contiguous copy."""
    return em if _rows_side_by_side(em) else em.contiguous()


def noblank_shard_forward_kernel(em, input_lengths, target_lengths, stay0,
                                 adv0):
    """Launch the shard forward kernel: ``(alpha [t_s, B, L], final [B],
    boundary [B, L])`` from em and the ``[B, L]`` init rows, as
    :func:`noblank_shard_forward_plain` computes them.  em is read in place
    through its row stride (see :func:`rows_layout`)."""
    t_s, batch, width = em.shape
    plan = shard_forward_plan(width)
    _require_rows("noblank_shard_forward", em)
    _require("noblank_shard_forward", input_lengths=input_lengths,
             target_lengths=target_lengths, stay0=stay0, adv0=adv0)
    alpha = torch.empty((t_s, batch, width), device=em.device)
    return launch(_SOURCE, "noblank_shard_forward", launch_counts,
                  (em, input_lengths, target_lengths, stay0, adv0),
                  (alpha, torch.empty((batch,), device=em.device),
                   torch.empty_like(stay0)),
                  (t_s, batch, width, em.stride(0), *plan))


def shard_backward_plan(width: int, weights: int,
                        mask_bytes: int = 0) -> tuple[int, int, int]:
    """``(chunk, threads, shared bytes)`` of a shard backward kernel at
    lattice width ``width``, whose cells each take ``weights`` branch
    weights and ``mask_bytes`` mask bytes (noblank 2 and 0, blank 3 and 1).

    A block holds two staged alpha chunks of ``chunk`` rows, the chunk's
    weights, the carried g double buffer, the ``g_seed`` row, the two init
    rows and their weights: ``(2 + weights) * chunk + 5 + weights`` floats
    per cell (the kernels' ``shard_floats_per_cell``).  ``chunk`` is the
    largest of ``SHARD_CHUNKS`` that fits in ``SMEM_LIMIT`` (16 up to width
    818 noblank and 658 blank, 4 up to 2526 and 2057, then 1); the block is
    ``SHARD_THREADS`` threads, which stride over wider rows.  Raises
    ``ValueError`` above the widths where even one row does not fit (5282
    noblank, 4385 blank)."""
    for chunk in SHARD_CHUNKS:
        floats = (2 + weights) * chunk + 5 + weights
        smem = (4 * floats + mask_bytes) * width
        if smem <= SMEM_LIMIT:
            return chunk, SHARD_THREADS, smem
    raise ValueError(
        f"lattice width {width}: the shard backward's rows do not fit in the "
        f"{SMEM_LIMIT} bytes of shared memory a block may use")


def noblank_shard_grad_kernel(alpha, input_lengths, target_lengths,
                              final_bar, g_seed, stay0, adv0):
    """Launch the shard backward kernel: ``(g [t_s, B, L], d stay0 [B, L],
    d adv0 [B, L])`` from alpha, the final log-prob's cotangent, the
    boundary row's ``g_seed`` and the init rows (the plain path's
    :func:`noblank_shard_grad_plain` and :func:`init_row_grads` in one
    launch)."""
    plan = shard_backward_plan(alpha.shape[2], weights=2)
    _require("noblank_shard_backward", alpha=alpha,
             input_lengths=input_lengths, target_lengths=target_lengths,
             final_bar=final_bar, g_seed=g_seed, stay0=stay0, adv0=adv0)
    return launch(_SOURCE, "noblank_shard_backward", launch_counts,
                  (alpha, input_lengths, target_lengths, final_bar, g_seed,
                   stay0, adv0),
                  (torch.empty_like(alpha), torch.empty_like(stay0),
                   torch.empty_like(adv0)), (*alpha.shape, *plan))


# ---------------------------------------------------------------------------
# the differentiable op
# ---------------------------------------------------------------------------


def _validate(em, input_lengths, target_lengths):
    """Check the operands and return the int32 length vectors on em's
    device."""
    if em.dim() != 3:
        raise ValueError(f"emissions must be [T, B, L], got {tuple(em.shape)}")
    if em.dtype != torch.float32:
        raise TypeError(f"emissions must be float32, got {em.dtype}")
    batch = em.shape[1]
    out = []
    for name, x in (("input_lengths", input_lengths),
                    ("target_lengths", target_lengths)):
        if x.shape != (batch,):
            raise ValueError(f"{name} must be [{batch}], got {tuple(x.shape)}")
        if x.device != em.device:
            raise ValueError(
                f"{name} is on {x.device}, emissions on {em.device}"
            )
        out.append(x.to(torch.int32).contiguous())
    return out


def validate_rows(em, **rows):
    """Check that every init row is a float32 ``[B, W]`` tensor on em's
    device, ``W`` the lattice width of em ``[t_s, B, W]``."""
    want = (em.shape[1], em.shape[2])
    for name, row in rows.items():
        if tuple(row.shape) != want:
            raise ValueError(f"{name} must be {list(want)}, got "
                             f"{tuple(row.shape)}")
        if row.dtype != torch.float32 or row.device != em.device:
            raise ValueError(f"{name} must be float32 on {em.device}, got "
                             f"{row.dtype} on {row.device}")


class NoBlankLatticeNLL(torch.autograd.Function):
    """Per-sample NLL ``[B]`` of em ``[T, B, L]``; saves alpha for the
    analytic backward.  ``use_kernel`` picks the CUDA kernels for both
    passes, else the plain version."""

    @staticmethod
    def forward(ctx, em, input_lengths, target_lengths, use_kernel):
        em = em.contiguous()
        if use_kernel:
            alpha, nll = noblank_alpha_kernel(em, input_lengths,
                                              target_lengths)
        else:
            alpha = noblank_alpha_plain(em, target_lengths)
            nll = gather_nll(alpha, input_lengths, target_lengths)
        ctx.save_for_backward(alpha, input_lengths, target_lengths)
        ctx.use_kernel = use_kernel
        return nll

    @staticmethod
    def backward(ctx, nll_bar):
        alpha, input_lengths, target_lengths = ctx.saved_tensors
        nll_bar = nll_bar.contiguous()
        if ctx.use_kernel:
            g = noblank_grad_kernel(alpha, input_lengths, target_lengths,
                                    nll_bar)
        else:
            g = noblank_grad_plain(alpha, input_lengths, target_lengths,
                                   nll_bar)
        return g, None, None, None


def _to_tbl(emissions, layout):
    if layout == "tbl":
        return emissions
    if layout == "tlb":
        return emissions.transpose(1, 2)
    raise ValueError(f"unknown layout {layout!r}")


def noblank_lattice_nll_plain(emissions, input_lengths, target_lengths, *,
                              layout="tbl"):
    """Plain PyTorch lattice NLL ``[B]`` on any device, analytic gradient."""
    em = _to_tbl(emissions, layout)
    inlen, tgt = _validate(em, input_lengths, target_lengths)
    return NoBlankLatticeNLL.apply(em, inlen, tgt, False)


def noblank_lattice_nll_cuda(emissions, input_lengths, target_lengths, *,
                             layout="tbl"):
    """Per-sample NLL ``[B]`` through the CUDA kernels (signature of
    ``noblank_lattice_nll_pallas``).

    ``layout='tbl'`` takes emissions ``[T, B, L]``; ``'tlb'`` takes
    ``[T, L, B]``, transposed here.  A CUDA tensor launches the kernels; a
    CPU tensor runs the plain version; any other device raises.
    """
    em = _to_tbl(emissions, layout)
    if em.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no lattice implementation for {em.device}")
    inlen, tgt = _validate(em, input_lengths, target_lengths)
    return NoBlankLatticeNLL.apply(em, inlen, tgt, em.is_cuda)


class NoBlankShardLattice(torch.autograd.Function):
    """One T-shard ``(em, stay0, adv0) -> (final [B], boundary_out [B,
    L])``; saves alpha for the analytic backward.  ``use_kernel`` picks the
    CUDA kernels for both passes, else the plain version.

    The cotangent of an output nobody reads (the last shard's boundary row)
    arrives as zeros: ``ctx.set_materialize_grads`` keeps its default."""

    @staticmethod
    def forward(ctx, em, stay0, adv0, input_lengths, target_lengths,
                use_kernel):
        stay0, adv0 = stay0.contiguous(), adv0.contiguous()
        if use_kernel:
            alpha, final, boundary = noblank_shard_forward_kernel(
                rows_layout(em), input_lengths, target_lengths, stay0, adv0)
        else:
            alpha, final, boundary = noblank_shard_forward_plain(
                em, input_lengths, target_lengths, stay0, adv0)
        ctx.save_for_backward(alpha, stay0, adv0, input_lengths,
                              target_lengths)
        ctx.use_kernel = use_kernel
        return final, boundary

    @staticmethod
    def backward(ctx, final_bar, boundary_bar):
        alpha, stay0, adv0, input_lengths, target_lengths = ctx.saved_tensors
        bars = (final_bar.contiguous(), boundary_bar.contiguous())
        if ctx.use_kernel:
            g, d_stay0, d_adv0 = noblank_shard_grad_kernel(
                alpha, input_lengths, target_lengths, *bars, stay0, adv0)
        else:
            g = noblank_shard_grad_plain(alpha, input_lengths, target_lengths,
                                         *bars)
            d_stay0, d_adv0 = init_row_grads(g[0], stay0, adv0,
                                             target_lengths)
        return g, d_stay0, d_adv0, None, None, None


def noblank_shard_lattice_plain(em, stay0, adv0, input_lengths,
                                target_lengths):
    """One T-shard through the plain version, on any device; see
    :func:`noblank_shard_lattice_cuda`."""
    inlen, tgt = _validate(em, input_lengths, target_lengths)
    validate_rows(em, stay0=stay0, adv0=adv0)
    return NoBlankShardLattice.apply(em, stay0, adv0, inlen, tgt, False)


def noblank_shard_lattice_cuda(em, stay0, adv0, input_lengths,
                               target_lengths):
    """One sequence-shard of the blank-free lattice (port of
    ``noblank_shard_lattice_pallas``, layout ``[t_s, B, L]``).

    ``stay0`` / ``adv0`` are ``[B, L]``: the incoming boundary row for both
    on an interior shard, :func:`noblank_alpha_init` and the sentinel row on
    shard 0.  ``input_lengths`` are SHARD-LOCAL (``inlen - t_offset``).
    Returns ``(final [B], boundary_out [B, L])``, differentiable in em and
    both init rows.  A CUDA tensor launches the kernels; a CPU tensor runs
    the plain version; any other device raises.
    """
    if em.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no lattice implementation for {em.device}")
    inlen, tgt = _validate(em, input_lengths, target_lengths)
    validate_rows(em, stay0=stay0, adv0=adv0)
    return NoBlankShardLattice.apply(em, stay0, adv0, inlen, tgt, em.is_cuda)
