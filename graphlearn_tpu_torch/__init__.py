"""graphlearn_tpu_torch: the PyTorch/CUDA port of graphlearn_tpu.

It runs the JAX package's sampled GraphSAGE pipeline (``NeighborLoader``
-> ``NeighborSampler`` -> ``collate_batch`` -> layered ``GraphSAGE``) on
an NVIDIA GPU, with the TPU kernels of that path rewritten by hand in
CUDA (``csrc/``). The JAX package stays the reference: the same inputs
and the same threefry stream give the same ids, masks and counts. This
package imports torch and numpy, never jax. Entry points run on the card
(``device=None``) unless the caller passes ``device='cpu'``.
"""
from . import data, loader, models, ops, random, sampler, typing, utils

__version__ = '0.1.0'
