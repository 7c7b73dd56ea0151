"""``CastMixin``: permissive construction from tuples and dicts."""


class CastMixin:
  """``cls.cast(x)``: None stays None, an instance is returned as it is,
  a tuple or list is unpacked, a dict is passed by keyword."""

  @classmethod
  def cast(cls, *args, **kwargs):
    if len(args) == 1 and not kwargs:
      elem = args[0]
      if elem is None or isinstance(elem, cls):
        return elem
      if isinstance(elem, (tuple, list)):
        return cls(*elem)
      if isinstance(elem, dict):
        return cls(**elem)
    return cls(*args, **kwargs)
