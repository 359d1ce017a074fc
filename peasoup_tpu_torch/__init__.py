"""peasoup_tpu_torch: the PyTorch / CUDA port of peasoup_tpu for NVIDIA
Hopper (H100).

The JAX package ``peasoup_tpu`` is the reference; this package keeps its
module names and imports nothing of it. Plain tensor code is PyTorch;
each TPU kernel on the ported path is a hand-written CUDA kernel under
``csrc/``, built at first use (``kernels.py``). Entry points run on the
card unless the caller passes ``device="cpu"``, where every kernel
wrapper runs its plain torch version instead.
"""

__version__ = "0.1.0"
