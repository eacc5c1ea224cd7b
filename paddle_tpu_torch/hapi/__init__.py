"""``paddle.hapi`` of the port: ``Model`` and the callbacks."""
from .model import Model  # noqa: F401
from . import callbacks  # noqa: F401
