"""``fleet`` of the port (``paddle_tpu/distributed/fleet`` counterpart):
``utils.recompute``.  The rest of fleet (strategies, meta-parallel
layers, ``LocalFS`` / ``HDFSClient``) waits for ROADMAP Queue A 10 and
A 12."""
from . import utils  # noqa: F401
from .utils import recompute  # noqa: F401
