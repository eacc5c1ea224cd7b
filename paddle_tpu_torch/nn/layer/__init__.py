"""Layers of the port that have no torch counterpart: ``ScanLayers``."""
from .scan import ScanLayers, owner_of  # noqa: F401
