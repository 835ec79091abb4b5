from .fault_tolerance import (FaultTolerantLoop, LoopReport,  # noqa: F401
                              StragglerMonitor)
