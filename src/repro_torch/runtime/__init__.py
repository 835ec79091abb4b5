from .fault_tolerance import StragglerMonitor  # noqa: F401
