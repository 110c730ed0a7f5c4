"""otfusion_tpu_torch — PyTorch/CUDA port of ``otfusion_tpu`` for one NVIDIA H100.

The JAX package ``otfusion_tpu`` is the reference: every module here keeps
its counterpart's path, names and public layouts (volumes ``(B, D, H, W, 1)``,
feature plans ``(d_pet, d_mri)``), so the tests can feed both packages the
same numpy inputs and compare.

The two Pallas TPU kernels of the reference become CUDA kernels written for
``sm_90a`` (``csrc/``), built with ``nvcc`` at first use and bound through
``ctypes``:

  * ``ops/gw_kernel.py``       — per-label entropic-GW whole solve (K1);
  * ``ops/sinkhorn_kernel.py`` — log-domain Sinkhorn sweeps (K2).

Each has a plain PyTorch version beside it. A wrapper takes the plain
version only for tensors on the CPU; for CUDA tensors it launches the kernel
or raises.

This package imports ``torch`` and never ``jax``, ``flax`` or ``optax``.
"""

__version__ = "0.1.0"
