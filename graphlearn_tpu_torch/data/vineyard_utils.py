"""Vineyard (GraphScope object store) adapters: gated.

Counterpart of ``graphlearn_tpu/data/vineyard_utils.py``: loading a CSR
topology and vertex or edge features from a vineyard socket needs the
vineyard runtime, which is not here, so each function raises
``ImportError`` without it (and ``NotImplementedError`` with it), as the
JAX package's do. The signatures are the reference's.
"""


def _require_vineyard():
  try:
    import vineyard  # noqa: F401
  except ImportError as e:
    raise ImportError(
        'vineyard is not installed; vineyard adapters load GraphScope '
        'fragments (reference vineyard_utils.cc) and need the vineyard '
        'runtime') from e


def vineyard_to_csr(sock: str, object_id: str, v_label: int, e_label: int,
                    edge_dir: str = 'out'):
  _require_vineyard()
  raise NotImplementedError(
      'vineyard fragment -> CSR: implement against the GraphScope '
      'fragment API when vineyard is present')


def load_vertex_feature_from_vineyard(sock: str, object_id: str,
                                      cols, v_label: int):
  _require_vineyard()
  raise NotImplementedError


def load_edge_feature_from_vineyard(sock: str, object_id: str,
                                    cols, e_label: int):
  _require_vineyard()
  raise NotImplementedError
