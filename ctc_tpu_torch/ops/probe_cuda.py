"""Forward-lattice probes: the CUDA kernels and their plain versions.

Port of the two development probes at the repository root,
``probe_fwd_ops.py`` (``make(body_kind)``, ``make_noout``) and
``probe_expdomain_fwd.py`` (``fwd_{log,exp,exp_renorm}_kernel``).  Each is
a stripped variant of the blank-free forward recursion, timed to show which
operation binds a step; no training path runs them.  Layout is the probes'
``[T, L, B]``, float32; NEG is the -1e13 sentinel.

Row 9, em ``[T, L, B]`` -> ``[T, L_PAD, B]`` with ``L_PAD`` = L rounded up
to 8 and em's rows ``L..L_PAD-1`` read as 0.  The carry starts at 0 in row
0 and NEG elsewhere; ``s`` is the carry shifted down one row with NEG in
row 0:

* :func:`probe_body` ``(em, kind)``: ``copy`` (alpha = e), ``add`` (alpha +
  e), ``roll`` (max(alpha, s) + e), ``lse`` (logaddexp(alpha, s) + e),
  ``lse_manual`` (max + log1p(exp(-|alpha - s|)) + e), ``lse_exp2`` (max +
  exp(-|alpha - s|) + e);
* :func:`probe_noout` ``(em, chunk)``: the ``lse`` body, writing only the
  carry after each chunk's last step, ``[T / chunk, L_PAD, B]``; T must be
  a multiple of ``chunk``.

Row 10, em ``[T, L_PAD, B]`` and ``outside [L_PAD, B]`` (outside where >
0.5) -> ``[T, L_PAD, B]``; the shift source is 0 (exp) or NEG (log) in row
0 and at t = 0:

* :func:`probe_fwd_log`: the production recursion, carry 0 / NEG,
  ``alpha = (outside ? NEG : logaddexp(alpha, s)) + em[t]``;
* :func:`probe_fwd_exp`: carry 1 / 0, ``A = outside ? 0 : (A + s) *
  exp(em[t])``;
* :func:`probe_fwd_exp_renorm` ``(em, outside, chunk)``: as ``exp``, and
  after each chunk's last step the carry (not the stored row) is divided by
  its per-column max over all rows, 1 where that max is <= 0.

Each public function launches its kernel of ``csrc/fwd_probes.cu`` on a
CUDA tensor and runs the plain version (``*_plain``) on a CPU tensor; it
takes nothing else and never falls back.  Row 9's kernels stage em through
a shared-memory ring whose depth :func:`ring_plan` picks from ``L_PAD``;
they refuse, before any launch, an ``L_PAD`` whose carry and a two-slot
ring do not fit in a block's shared memory (``L_PAD`` above 1816).  Row
10's kernels take a ring of the same slots where it fits
(:func:`expdomain_plan`; filled by tensor copies, :func:`tensor_copies`,
or by each thread's 4-byte copies), else read em inside the step, up to
``L_PAD`` 2408; wider ones are refused before any launch.
"""

from __future__ import annotations

import torch

from ctc_tpu_torch.ops.lattice_cuda import _require, launch
from ctc_tpu_torch.ops.logspace import NEG_SENTINEL

BODIES = ("copy", "add", "roll", "lse", "lse_manual", "lse_exp2")

#: launches of each kernel, counted where the wrapper launches it
launch_counts = {**{f"probe_{body}": 0 for body in BODIES},
                 "probe_noout": 0, "probe_fwd_log": 0, "probe_fwd_exp": 0,
                 "probe_fwd_exp_renorm": 0}

_SOURCE = "fwd_probes.cu"

#: shared memory one block may use on Hopper (227 KB)
SMEM_LIMIT = 232_448
#: the em ring depths the kernels are built for, deepest first
_RING_DEPTHS = (8, 2)
_TILE_B = 8  # samples per block (``kTileB``)
_ROW_THREADS = 64  # row threads of a block's column (``kRingRows``)
#: exp_renorm's per-warp column maxima, two buffers (``kPartialFloats``)
PARTIAL_BYTES = 2 * (_TILE_B * _ROW_THREADS // 32) * _TILE_B * 4
#: the widest ``L_PAD`` row 10's kernels take: the first row-10 kernel's
#: widest, ``(3 L_PAD + 32) * 32`` bytes of shared memory
EXPDOMAIN_MAX_L_PAD = 2408
#: row 10's variants, as ``expdomain_plan`` takes them
EXPDOMAIN_KINDS = ("log", "exp", "exp_renorm")
#: the log variant reads em inside the step below this ``L_PAD`` (one row
#: a thread): its em enters the step last, behind the log-add, which hides
#: the load there; at L_PAD 24 the ring ran 1.10-1.13x the first row-10
#: kernel's time, the step 0.88x, at every B from 100 to 1024 (PERF.md §6)
LOG_IN_STEP_BELOW = 64


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def pad_rows(n: int) -> int:
    """``L_PAD``: the label rows rounded up to a multiple of 8."""
    return -(-n // 8) * 8


def _ring_fit(l_pad: int, extra: int = 0) -> tuple[int, int] | None:
    """The deepest ring of ``_RING_DEPTHS`` whose slots, the carry's double
    buffer (each ``[L_PAD, 8]`` f32) and ``extra`` bytes fit in
    ``SMEM_LIMIT``: ``(depth, bytes)``, or None."""
    slot = l_pad * _TILE_B * 4
    for depth in _RING_DEPTHS:
        smem = (depth + 2) * slot + extra
        if smem <= SMEM_LIMIT:
            return depth, smem
    return None


def ring_plan(l_pad: int) -> tuple[int, int]:
    """``(depth, shared-memory bytes)`` of row 9's kernels at ``L_PAD``
    rows: a ring of ``depth`` em slots and the carry's double buffer, each
    slot ``[L_PAD, 8]`` f32.  Eight slots where they fit beside the carry
    in ``SMEM_LIMIT`` (``L_PAD`` up to 720), else two, whose one slot in
    flight is then 23 KB or more.  Raises ``ValueError`` where not even
    two fit (``L_PAD`` above 1816)."""
    plan = _ring_fit(l_pad)
    if plan is None:
        slot = l_pad * _TILE_B * 4
        raise ValueError(
            f"L_PAD={l_pad}: the em ring does not fit; two slots of {slot} "
            f"bytes beside the {2 * slot}-byte carry need more than the "
            f"{SMEM_LIMIT} bytes of shared memory a block may use")
    return plan


def expdomain_plan(l_pad: int, kind: str) -> tuple[int, int]:
    """``(depth, shared-memory bytes)`` of row 10's ``kind`` kernel
    (:data:`EXPDOMAIN_KINDS`) at ``L_PAD`` rows: as :func:`ring_plan`, with
    ``PARTIAL_BYTES`` more for ``exp_renorm``'s partials (its two-slot ring
    ends at ``L_PAD`` 1808, the others' at 1816); depth 0, em read inside
    the step beside the carry, past the ring up to ``EXPDOMAIN_MAX_L_PAD``
    and for ``log`` below ``LOG_IN_STEP_BELOW``.  Raises ``ValueError``
    above ``EXPDOMAIN_MAX_L_PAD``."""
    if kind not in EXPDOMAIN_KINDS:
        raise ValueError(f"unknown row-10 kind {kind!r}; one of "
                         f"{EXPDOMAIN_KINDS}")
    if l_pad > EXPDOMAIN_MAX_L_PAD:
        raise ValueError(
            f"L_PAD={l_pad}: row 10's kernels take rows up to "
            f"{EXPDOMAIN_MAX_L_PAD}, the widest the first row-10 kernel "
            "took in a block's shared memory")
    extra = PARTIAL_BYTES if kind == "exp_renorm" else 0
    plan = _ring_fit(l_pad, extra)
    if plan is None or (kind == "log" and l_pad < LOG_IN_STEP_BELOW):
        return 0, 2 * l_pad * _TILE_B * 4 + extra
    return plan


def tensor_copies(em, depth: int) -> bool:
    """Whether row 10's ring of ``depth`` slots over em ``[T, L_PAD, B]``
    is filled by tensor copies (the launcher's rule): eight slots, rows of
    whole 16-byte pieces (B a multiple of 4, em's base 16-byte aligned) and
    ``L_PAD`` a multiple of 8."""
    _, l_pad, batch = em.shape
    return (depth == 8 and batch % 4 == 0 and l_pad % 8 == 0
            and em.data_ptr() % 16 == 0)


def _check_em(em) -> None:
    if em.dim() != 3:
        raise ValueError(f"emissions must be [T, L, B], got {tuple(em.shape)}")
    if em.dtype != torch.float32:
        raise TypeError(f"emissions must be float32, got {em.dtype}")
    if em.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no probe implementation for {em.device}")


def _check_chunk(chunk: int, steps: int | None = None) -> None:
    if chunk < 1:
        raise ValueError(f"chunk must be at least 1, got {chunk}")
    if steps is not None and steps % chunk:
        raise ValueError(f"T={steps} is not a multiple of chunk={chunk}")


def _check_outside(em, outside) -> None:
    want = (em.shape[1], em.shape[2])
    if tuple(outside.shape) != want:
        raise ValueError(f"outside must be {list(want)}, got "
                         f"{tuple(outside.shape)}")
    if outside.dtype != torch.float32 or outside.device != em.device:
        raise ValueError(f"outside must be float32 on {em.device}, got "
                         f"{outside.dtype} on {outside.device}")


# ---------------------------------------------------------------------------
# plain version (any device)
# ---------------------------------------------------------------------------


def _shift_down(a: torch.Tensor, fill: float) -> torch.Tensor:
    """``out[l] = a[l-1]`` along rows, ``fill`` in row 0 (``pltpu.roll``
    by one, its wrapped row masked)."""
    return torch.cat([torch.full_like(a[:1], fill), a[:-1]])


def _carry_init(l_pad, batch, first, rest, like):
    row = torch.full((l_pad, batch), rest, dtype=like.dtype,
                     device=like.device)
    row[0] = first
    return row


def _widen(em: torch.Tensor) -> torch.Tensor:
    """em ``[T, L, B]`` with zero rows appended up to ``L_PAD``."""
    steps, rows, batch = em.shape
    wide = em.new_zeros((steps, pad_rows(rows), batch))
    wide[:, :rows] = em
    return wide


def _body_step(kind, a, e):
    if kind == "copy":
        return e
    if kind == "add":
        return a + e
    s = _shift_down(a, NEG_SENTINEL)
    if kind == "roll":
        return torch.maximum(a, s) + e
    if kind == "lse":
        return torch.logaddexp(a, s) + e
    tail = torch.exp(-(a - s).abs())
    if kind == "lse_manual":
        tail = torch.log1p(tail)
    return torch.maximum(a, s) + tail + e


def _body_rows(em, kind, chunk=None):
    """The carry after every step (``chunk``: after each chunk's last)."""
    e = _widen(em)
    a = _carry_init(e.shape[1], e.shape[2], 0.0, NEG_SENTINEL, e)
    rows = []
    for t in range(e.shape[0]):
        a = _body_step(kind, a, e[t])
        if chunk is None or (t + 1) % chunk == 0:
            rows.append(a)
    return torch.stack(rows)


def probe_body_plain(em, kind):
    """Row 9, variant ``kind``, plain: ``[T, L_PAD, B]``."""
    _check_em(em)
    if kind not in BODIES:
        raise ValueError(f"unknown probe body {kind!r}; one of {BODIES}")
    return _body_rows(em, kind)


def probe_noout_plain(em, chunk):
    """Row 9's carry-only variant, plain: ``[T / chunk, L_PAD, B]``."""
    _check_em(em)
    _check_chunk(chunk, em.shape[0])
    return _body_rows(em, "lse", chunk)


def probe_fwd_log_plain(em, outside):
    """Row 10, the log-domain recursion, plain: ``[T, L_PAD, B]``."""
    _check_em(em)
    _check_outside(em, outside)
    out_mask = outside > 0.5
    a = _carry_init(em.shape[1], em.shape[2], 0.0, NEG_SENTINEL, em)
    rows = []
    for t in range(em.shape[0]):
        s = (torch.full_like(a, NEG_SENTINEL) if t == 0
             else _shift_down(a, NEG_SENTINEL))
        lse = torch.where(out_mask, NEG_SENTINEL, torch.logaddexp(a, s))
        a = lse + em[t]
        rows.append(a)
    return torch.stack(rows)


def _exp_rows(em, outside, chunk=None):
    inside = outside <= 0.5
    a = _carry_init(em.shape[1], em.shape[2], 1.0, 0.0, em)
    rows = []
    for t in range(em.shape[0]):
        s = torch.zeros_like(a) if t == 0 else _shift_down(a, 0.0)
        a = torch.where(inside, (a + s) * torch.exp(em[t]), 0.0)
        rows.append(a)
        if chunk is not None and (t + 1) % chunk == 0:
            m = a.amax(dim=0, keepdim=True)
            a = a / torch.where(m > 0, m, 1.0)
    return torch.stack(rows)


def probe_fwd_exp_plain(em, outside):
    """Row 10, the exp-domain recursion, plain: ``[T, L_PAD, B]``."""
    _check_em(em)
    _check_outside(em, outside)
    return _exp_rows(em, outside)


def probe_fwd_exp_renorm_plain(em, outside, chunk):
    """Row 10, exp domain with the per-chunk renormalization, plain:
    ``[T, L_PAD, B]``, each row as stored before its chunk's renorm."""
    _check_em(em)
    _check_outside(em, outside)
    _check_chunk(chunk)
    return _exp_rows(em, outside, chunk)


# ---------------------------------------------------------------------------
# kernels (CUDA tensors only)
# ---------------------------------------------------------------------------


def probe_body_kernel(em, kind):
    """Launch row 9's ``kind`` kernel: ``[T, L_PAD, B]`` from em."""
    if kind not in BODIES:
        raise ValueError(f"unknown probe body {kind!r}; one of {BODIES}")
    name = f"probe_{kind}"
    steps, rows, batch = em.shape
    ring = ring_plan(pad_rows(rows))
    _require(name, em=em)
    out = em.new_empty((steps, pad_rows(rows), batch))
    return launch(_SOURCE, name, launch_counts, (em,), out,
                  (steps, rows, out.shape[1], batch, *ring))


def probe_noout_kernel(em, chunk):
    """Launch row 9's carry-only kernel: ``[T / chunk, L_PAD, B]``."""
    steps, rows, batch = em.shape
    ring = ring_plan(pad_rows(rows))
    _require("probe_noout", em=em)
    _check_chunk(chunk, steps)
    out = em.new_empty((steps // chunk, pad_rows(rows), batch))
    return launch(_SOURCE, "probe_noout", launch_counts, (em,), out,
                  (steps, rows, out.shape[1], batch, chunk, *ring))


def _expdomain_kernel(name, em, outside, *chunk, plan=None):
    """Launch row 10's ``name`` in ``plan`` (``(depth, shared bytes)``;
    default :func:`expdomain_plan`'s for em's ``L_PAD``)."""
    plan = plan or expdomain_plan(em.shape[1], name[len("probe_fwd_"):])
    _require(name, em=em, outside=outside)
    _check_outside(em, outside)
    return launch(_SOURCE, name, launch_counts, (em, outside),
                  torch.empty_like(em), (*em.shape, *chunk, *plan))


def probe_fwd_log_kernel(em, outside):
    """Launch row 10's log-domain kernel."""
    return _expdomain_kernel("probe_fwd_log", em, outside)


def probe_fwd_exp_kernel(em, outside):
    """Launch row 10's exp-domain kernel."""
    return _expdomain_kernel("probe_fwd_exp", em, outside)


def probe_fwd_exp_renorm_kernel(em, outside, chunk):
    """Launch row 10's exp-domain kernel with the per-chunk renorm."""
    _check_chunk(chunk)
    return _expdomain_kernel("probe_fwd_exp_renorm", em, outside, chunk)


# ---------------------------------------------------------------------------
# by device: the kernel on a CUDA tensor, the plain version on a CPU one
# ---------------------------------------------------------------------------


def _by_device(kernel, plain, em, *args):
    _check_em(em)
    return (kernel if em.is_cuda else plain)(em, *args)


def probe_body(em, kind):
    """Row 9, variant ``kind`` (port of ``probe_fwd_ops.make(kind)``)."""
    return _by_device(probe_body_kernel, probe_body_plain, em, kind)


def probe_noout(em, chunk):
    """Row 9's carry-only variant (``probe_fwd_ops.make_noout("lse")``)."""
    return _by_device(probe_noout_kernel, probe_noout_plain, em, chunk)


def probe_fwd_log(em, outside):
    """Row 10, ``probe_expdomain_fwd.fwd_log_kernel``."""
    return _by_device(probe_fwd_log_kernel, probe_fwd_log_plain, em, outside)


def probe_fwd_exp(em, outside):
    """Row 10, ``probe_expdomain_fwd.fwd_exp_kernel``."""
    return _by_device(probe_fwd_exp_kernel, probe_fwd_exp_plain, em, outside)


def probe_fwd_exp_renorm(em, outside, chunk):
    """Row 10, ``probe_expdomain_fwd.fwd_exp_renorm_kernel``."""
    return _by_device(probe_fwd_exp_renorm_kernel, probe_fwd_exp_renorm_plain,
                      em, outside, chunk)
