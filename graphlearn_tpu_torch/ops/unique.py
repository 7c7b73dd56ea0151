"""Padding sentinel shared by every op (``graphlearn_tpu/ops/unique.py``)."""

FILL = -1  # invalid/padded ids (all real ids are >= 0)
