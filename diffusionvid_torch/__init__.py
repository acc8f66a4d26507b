"""diffusionvid_torch — the PyTorch / CUDA port of diffusionvid_tpu.

The JAX package beside it is the reference; this package keeps its module
layout and names.  Plain tensor code is PyTorch; each Pallas kernel of the
ported path is a hand-written CUDA kernel for Hopper (``csrc/``), built at
first use by ``ops/_build.py``.  Entry points run on ``cuda`` unless the
caller asks for ``device="cpu"``; on a CPU tensor each kernel wrapper runs
its plain PyTorch version.
"""

__version__ = "0.1.0"
