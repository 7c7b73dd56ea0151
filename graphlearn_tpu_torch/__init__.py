"""graphlearn_tpu_torch: the PyTorch/CUDA port of graphlearn_tpu.

It runs the JAX package's sampled GraphSAGE pipeline (``NeighborLoader``
-> ``NeighborSampler`` -> ``collate_batch`` -> layered ``GraphSAGE``), its
training entry points (``models.train``; ``loader.ScanTrainer``,
``RunTrainer`` and ``OverlappedTrainer``; ``recovery.ChunkCheckpointer``),
its embedding-serving tier (``serving``: full-graph materializer,
``EmbeddingStore``, ``ServingEngine``) and its out-of-core feature store
(``storage``: ``TieredFeature``, ``TieredScanTrainer``), its typed
(heterogeneous) path (dict datasets, the typed sampler and typed link
sampling, ``HeteroData``, ``RGNN``, the typed materializer) and its
partitioners (``partition``) and its partitioned sampling and training
path (``distributed``: sharded graph, features, sampler and loader;
``loader.DistScanTrainer``, ``recovery.FailoverRunner``, the tiered
distributed store and the sharded serving stores; the multiprocess and
server-client sampling stack over ``channel``) and its one-call tuner
(``tune``: ``graphlearn_tpu_torch.tune(dataset, loader_cfg)`` gives the
artifact every chunked trainer and the serving engine take as
``config=``) on an NVIDIA GPU,
with the TPU kernels of those paths rewritten by hand in CUDA
(``csrc/``). The JAX
package stays the reference: the same inputs and the same threefry
stream give the same ids, masks and counts. This package imports torch
and numpy, never jax. Entry points run on the card
(``device=None``) unless the caller passes ``device='cpu'``.
"""
from . import (channel, data, distributed, loader, metrics, models, ops,
               partition, random, recovery, sampler, serving, storage,
               tune, typing, utils)

from .loader import OverlappedTrainer, RunTrainer, ScanTrainer

__version__ = '0.1.0'
