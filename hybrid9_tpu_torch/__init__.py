"""HYBRID9 in PyTorch: the port of ``hybrid9_tpu`` to CUDA GPUs.

A second package beside the JAX one, with the same module and function
names.  Plain tensor code is PyTorch; the hydrology day, the one TPU
kernel on the main path, is a hand-written CUDA kernel for Hopper
(``csrc/day_kernel.cu``) with a plain PyTorch twin that the CPU runs.
``python -m hybrid9_tpu_torch run`` runs years of it (``cli.py``).  The
package imports neither JAX nor ``hybrid9_tpu``.
"""

__version__ = "0.1.0"
