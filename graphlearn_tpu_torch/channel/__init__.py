"""Channels that carry sampled batches between processes.

Counterpart of ``graphlearn_tpu/channel``: ``ShmChannel`` (a SysV
shared-memory ring, ``csrc/shm_queue.cc``), ``MpChannel`` (a
multiprocessing queue), ``RemoteReceivingChannel`` (a client pulling
batches from sampling servers over the RPC), and the ``SampleMessage``
wire format (``serialize_message`` / ``deserialize_message``,
byte-compatible with the JAX package's). A message is a flat dict of
numpy arrays: torch tensors never ride a channel.
"""
from .base import (ChannelBase, QueueTimeoutError, SampleMessage,
                   deserialize_message, serialize_message)
from .mp_channel import MpChannel
from .remote_channel import PeerDeadError, RemoteReceivingChannel
from .shm_channel import ShmChannel, live_channel_count
