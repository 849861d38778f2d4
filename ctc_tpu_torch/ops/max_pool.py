"""TF-SAME 3D max pool: one hand-written CUDA kernel pair and its plain
version.

The I3D's 13 max pools (``models/i3d.py``) take XLA's SAME padding: a
window tap outside the tensor counts as -inf, total padding ``max((ceil(n /
s) - 1) s + k - n, 0)`` with ``total // 2`` in front (:func:`same_pads`).

* :func:`max_pool3d_same` launches ``csrc/max_pool3d_same.cu`` on a CUDA
  tensor and runs the plain version on a CPU tensor.  It takes nothing else
  and never falls back.  The kernel skips the taps outside the tensor (no
  padded copy) and writes, only when autograd will run a backward, one
  ``uint8`` beside each output: its tap within the window.  The backward
  kernel gathers each input's gradient from the outputs that name it, in
  one fixed order, so it is the same every run.
* :func:`max_pool3d_same_plain` pads with -inf and calls ``F.max_pool3d``:
  the CPU path, and the oracle the kernels are held to.  It follows
  ``ctc_tpu`` (``flax.linen.max_pool``) for inputs of either sign.

The kernels are built for the I3D's four windows (:data:`TILES`) in
``channels_last_3d``, the layout the model gives its pools, with C a
multiple of 16 bytes (every I3D pool's is); any other window or channel
count raises.  The op adapts to what its input shows: float32, bfloat16 or
float64; an NCDHW input (as ``Tensor.suggest_memory_format`` reads the
strides, :func:`channels_last`) is copied to channels last around the
kernels, and its output and gradient come back in NCDHW, the layout
``F.max_pool3d`` gives; offsets only under grad mode and an input that
requires grad.  The maximum is exact; without offsets, where +0 and -0 tie
for it, either may come out.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

#: launches of each kernel, counted where the wrapper launches it
launch_counts = {"max_pool3d_same_forward": 0, "max_pool3d_same_backward": 0}

_SOURCE = "max_pool3d_same.cu"
#: the kernels' dtype codes
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
#: the I3D's four windows (kernel, stride), each built into a forward kernel
#: per (TH, TW) output tile listed (32 channels a block, a warp a column)
#: and into one backward kernel
TILES = {
    ((1, 3, 3), (1, 2, 2)): ((8, 8), (7, 7)),
    ((3, 3, 3), (2, 2, 2)): ((7, 7),),
    ((2, 2, 2), (2, 2, 2)): ((7, 7),),
    ((3, 3, 3), (1, 1, 1)): ((7, 7),),
}
#: the bytes of the forward's copies: C must fill them whole
VECTOR_BYTES = 16


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def same_pads(sizes, kernel, stride) -> tuple:
    """``F.pad``'s argument for XLA's SAME padding of the trailing
    ``len(kernel)`` dims of sizes ``sizes`` (last dim first)."""
    pads = []
    for n, k, s in zip(reversed(sizes), reversed(kernel), reversed(stride)):
        total = max((math.ceil(n / s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return tuple(pads)


def max_pool3d_same_plain(x, kernel, stride):
    """TF-same max pool of ``[N, C, D, H, W]``: -inf padding, then
    ``F.max_pool3d``."""
    pads = same_pads(x.shape[2:], kernel, stride)
    if any(pads):
        x = F.pad(x, pads, value=-math.inf)
    return F.max_pool3d(x, kernel, stride)


def channels_last(x) -> bool:
    """Whether ``x.suggest_memory_format()`` is ``channels_last_3d``: its
    strides ordered C, W, H, D, N from the smallest, with ATen's rules for
    dims of size 1 (``is_channels_last_strides_3d_s5``)."""
    sizes, strides = x.shape, x.stride()
    if strides[1] == 0:
        return False
    least = 0
    for d in (1, 4, 3, 2, 0):
        if sizes[d] == 0 or strides[d] < least:
            return False
        if d == 0 and least == strides[1]:
            return False
        least = strides[d] * max(sizes[d], 1)
    return True


@functools.lru_cache(maxsize=None)
def tile_plan(out_hw, kernel, stride) -> tuple:
    """``(TH, TW)``: the forward's output tile for ``out_hw`` outputs, the
    built tile of :data:`TILES` that loads the fewest input positions
    (halos and ragged edges included)."""
    (oh, ow), (kh, kw), (sh, sw) = out_hw, kernel[1:], stride[1:]

    def loads(tile):
        th, tw = tile
        return (-(-oh // th) * ((th - 1) * sh + kh)
                * -(-ow // tw) * ((tw - 1) * sw + kw))

    return min(TILES[(kernel, stride)], key=loads)


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {rc}")


def _require(x, kernel, stride) -> None:
    if x.dim() != 5:
        raise ValueError(f"max_pool3d_same: input must be [N, C, D, H, W], "
                         f"got {tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise TypeError(f"max_pool3d_same: no kernel for {x.dtype} (takes "
                        f"{', '.join(str(t) for t in DTYPES)})")
    if (kernel, stride) not in TILES:
        raise ValueError(f"max_pool3d_same: no kernel for window {kernel} "
                         f"stride {stride} (takes the I3D's: "
                         f"{', '.join(map(str, TILES))})")
    if (x.shape[1] * x.element_size()) % VECTOR_BYTES:
        raise ValueError(f"max_pool3d_same: {x.shape[1]} channels of "
                         f"{x.dtype} are not a multiple of {VECTOR_BYTES} "
                         f"bytes")


def _geometry(shape, kernel, stride) -> tuple:
    """``(N, C, D, H, W, OD, OH, OW, kd, kh, kw, sd, sh, sw, pd, ph, pw)``,
    the kernels' geometry arguments."""
    n, c, *dhw = shape
    out = [-(-size // s) for size, s in zip(dhw, stride)]
    front = same_pads(dhw, kernel, stride)[::2][::-1]
    return (n, c, *dhw, *out, *kernel, *stride, *front)


def _launch(name, *args) -> None:
    from ctc_tpu_torch.ops import cuda_build

    lib = cuda_build.load(_SOURCE)
    device = next(a for a in args if isinstance(a, torch.Tensor)).device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, name)(
            *(a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args), stream)
    _check(rc, name)
    launch_counts[name] += 1


def max_pool3d_same_kernel(x, kernel, stride, *, with_offsets):
    """The forward kernel on a CUDA tensor: ``(y, offsets)``, y in x's
    layout, offsets a channels-last ``uint8`` tensor of y's shape (the tap
    within each window in (d, h, w) scan order), or None unless
    ``with_offsets``."""
    _require(x, kernel, stride)
    if not x.is_cuda:
        raise ValueError(f"max_pool3d_same_kernel: input on {x.device}, "
                         f"not a CUDA device")
    last = channels_last(x)
    x = x.contiguous(memory_format=torch.channels_last_3d)
    if x.data_ptr() % VECTOR_BYTES:
        x = x.clone(memory_format=torch.channels_last_3d)
    geom = _geometry(x.shape, kernel, stride)
    out_shape = (*geom[:2], *geom[5:8])
    y = torch.empty(out_shape, dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last_3d)
    offsets = (torch.empty(out_shape, dtype=torch.uint8, device=x.device,
                           memory_format=torch.channels_last_3d)
               if with_offsets else None)
    if y.numel():
        _launch("max_pool3d_same_forward", x, y,
                0 if offsets is None else offsets, DTYPES[x.dtype], *geom,
                *tile_plan(out_shape[3:], kernel, stride))
    return (y if last else y.contiguous()), offsets


def max_pool3d_same_grad_kernel(gy, offsets, in_shape, kernel, stride):
    """The gather backward on the card: d loss / d x of shape ``in_shape``,
    channels last, from the output gradient ``gy`` and the forward's
    ``offsets``."""
    if gy.device != offsets.device:
        raise ValueError(f"max_pool3d_same backward: gradient on "
                         f"{gy.device}, offsets on {offsets.device}")
    gy = gy.contiguous(memory_format=torch.channels_last_3d)
    gx = torch.empty(in_shape, dtype=gy.dtype, device=gy.device,
                     memory_format=torch.channels_last_3d)
    if gx.numel():
        _launch("max_pool3d_same_backward", gy, offsets, gx,
                DTYPES[gy.dtype], *_geometry(in_shape, kernel, stride))
    return gx


class MaxPool3dSame(torch.autograd.Function):
    """The forward kernel with offsets, and the gather backward; saves the
    offsets only (the backward never reads the input)."""

    @staticmethod
    def forward(ctx, x, kernel, stride):
        y, offsets = max_pool3d_same_kernel(x, kernel, stride,
                                            with_offsets=True)
        ctx.save_for_backward(offsets)
        ctx.geometry = (x.shape, kernel, stride)
        ctx.channels_last = channels_last(x)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, gy):
        (offsets,) = ctx.saved_tensors
        gx = max_pool3d_same_grad_kernel(gy, offsets, *ctx.geometry)
        return gx if ctx.channels_last else gx.contiguous(), None, None


def max_pool3d_same(x, kernel, stride):
    """TF-same max pool of ``[N, C, D, H, W]`` ``x``: the kernels on a CUDA
    tensor (offsets and a backward only where autograd needs them), the
    plain version on a CPU tensor."""
    kernel, stride = tuple(kernel), tuple(stride)
    if not x.is_cuda:
        return max_pool3d_same_plain(x, kernel, stride)
    if torch.is_grad_enabled() and x.requires_grad:
        return MaxPool3dSame.apply(x, kernel, stride)
    return max_pool3d_same_kernel(x, kernel, stride, with_offsets=False)[0]
