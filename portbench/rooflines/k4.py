"""K4, the forward blend of one image on the windowed route (both tiers):
the same work as K3's, so the same count (portbench/rooflines/k3.py)."""

from portbench.rooflines.k3 import count  # noqa: F401
