"""image2text_torch: the PyTorch/CUDA port of image2text_tpu for one
NVIDIA H100.

The JAX package (``image2text_tpu``) is the reference; this package
imports nothing of it and nothing of JAX.  Module paths mirror the JAX
package's (``configs/``, ``nn/``, ``ops/``, ``models/``, ``utils/``).
Entry points run on the card unless the caller passes ``device='cpu'``.
The TPU kernels on the serving path are hand-written CUDA kernels under
``csrc/``, built with ``nvcc`` at first use (``ops/_build.py``).
"""
