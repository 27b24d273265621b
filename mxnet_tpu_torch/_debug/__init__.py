"""Runtime debugging aids (lock-order tracing, fault injection, the flight
recorder; counterpart of mxnet_tpu/_debug/).

Everything here is dormant unless its env gate is set, or, for the flight
recorder, costs one ring append per op: the port routes through these
modules unconditionally, and the modules keep their own disabled fast
paths.
"""
from . import locktrace
from . import faultpoint
from . import flightrec

__all__ = ["locktrace", "faultpoint", "flightrec"]

# watchdog/goodput/memwatch are imported lazily by their weld sites
# (fused_step, io, storage) and by the profiler's bottom import: importing
# them here would cycle through the profiler, which loads this package
# first.
