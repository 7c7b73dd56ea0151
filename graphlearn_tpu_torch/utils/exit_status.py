"""Interpreter-exit guard: destructors that talk to processes or
channels must not run during interpreter teardown."""
import atexit

_python_exit_status = False


def _set_python_exit():
  global _python_exit_status
  _python_exit_status = True


atexit.register(_set_python_exit)


def python_exit_status() -> bool:
  return _python_exit_status
