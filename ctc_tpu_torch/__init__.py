"""ctc_tpu_torch — the PyTorch/CUDA port of ``ctc_tpu``.

The package keeps ``ctc_tpu``'s module names so each piece has a visible
counterpart.  It imports ``torch`` and numpy only: never JAX and nothing of
``ctc_tpu``.  The blank-free lattice DP runs in two hand-written CUDA kernels
(``csrc/noblank_lattice.cu``) on a CUDA tensor and in a plain PyTorch version
on a CPU tensor.  Entry points run on ``cuda`` unless the caller asks for
the CPU.
"""

__version__ = "0.1.0"
