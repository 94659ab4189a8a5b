"""Resource taxonomy (the port's own copy of the reference's
``common/resources.py``).

Reference: cruise-control/src/main/java/com/linkedin/kafka/cruisecontrol/common/Resource.java:18-26
defines CPU, NW_IN, NW_OUT, DISK. Each resource is also the column index of
the trailing resource axis of every load/capacity tensor.
"""
from __future__ import annotations

import enum


class Resource(enum.IntEnum):
    """A balanceable resource; the value is the tensor column index."""

    CPU = 0
    NW_IN = 1
    NW_OUT = 2
    DISK = 3


# Absolute epsilon per resource (reference Resource.java enum constants:
# CPU 0.001, NW 10 KB, DISK 100 MB — units: CPU %, KB/s, MB).
EPSILON_ABS = {
    Resource.CPU: 0.001,
    Resource.NW_IN: 10.0,
    Resource.NW_OUT: 10.0,
    Resource.DISK: 100.0,
}

RESOURCES = tuple(Resource)
NUM_RESOURCES = len(RESOURCES)
