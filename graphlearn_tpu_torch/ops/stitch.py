"""Stitch per-partition sampling results back into seed order.

Counterpart of ``graphlearn_tpu/ops/stitch.py``: each partition returns
rows for the seeds it owns with their positions in the request;
stitching is a fixed-shape scatter.
"""
import torch


def stitch_rows(index_list, rows_list, mask_list, out_len: int):
  """Scatter per-partition row blocks into the original seed order.

  Args:
    index_list: ``[Bp]`` positions into the output per partition (padded
      entries may be arbitrary where their mask row is all False).
    rows_list: ``[Bp, K]`` payloads.
    mask_list: ``[Bp, K]`` validity masks.
    out_len: the number of output rows.

  Returns ``(out [out_len, K], out_mask [out_len, K])``. A row with a
  valid slot whose position lies outside the output is dropped (a
  negative position counts from the end, as in jnp indexing); later
  partitions overwrite earlier ones.
  """
  k = rows_list[0].shape[1]
  dev = rows_list[0].device
  out = torch.zeros((out_len + 1, k), dtype=rows_list[0].dtype, device=dev)
  out_mask = torch.zeros((out_len + 1, k), dtype=torch.bool, device=dev)
  for idx, rows, mask in zip(index_list, rows_list, mask_list):
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + out_len, idx)
    keep = mask.any(dim=1) & (idx >= 0) & (idx < out_len)
    slot = torch.where(keep, idx, out_len)
    out[slot] = torch.where(mask, rows, torch.zeros((), dtype=rows.dtype,
                                                    device=dev))
    out_mask[slot] = mask
  return out[:out_len], out_mask[:out_len]
