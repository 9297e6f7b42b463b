"""K7, the backward blend of one image on the stream route: the same work
as K5's, so the same count (portbench/rooflines/k5.py)."""

from portbench.rooflines.k5 import count  # noqa: F401
