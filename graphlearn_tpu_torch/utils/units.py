"""Byte-size strings (the port's copy of ``graphlearn_tpu/utils/
units.py``)."""

_UNITS = {
    'b': 1,
    'k': 1024, 'kb': 1024,
    'm': 1024 ** 2, 'mb': 1024 ** 2,
    'g': 1024 ** 3, 'gb': 1024 ** 3,
    't': 1024 ** 4, 'tb': 1024 ** 4,
}


def parse_size(size) -> int:
  """Parse '10GB' / '512M' / 1024 into a byte count."""
  if isinstance(size, (int, float)):
    return int(size)
  s = str(size).strip().lower()
  num_end = len(s)
  for i, ch in enumerate(s):
    if not (ch.isdigit() or ch == '.'):
      num_end = i
      break
  num = float(s[:num_end])
  unit = s[num_end:].strip() or 'b'
  if unit not in _UNITS:
    raise ValueError(f'unknown size unit {unit!r} in {size!r}')
  return int(num * _UNITS[unit])


def format_size(num_bytes: int) -> str:
  for unit in ('B', 'KB', 'MB', 'GB', 'TB'):
    if abs(num_bytes) < 1024 or unit == 'TB':
      return f'{num_bytes:.1f}{unit}' if unit != 'B' else f'{num_bytes}B'
    num_bytes /= 1024
  return f'{num_bytes}B'
