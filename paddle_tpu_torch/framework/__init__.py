"""``paddle.framework`` of the port: so far its checkpoint I/O
(``io.save`` / ``io.load``); the rest of ``paddle_tpu/framework`` comes
with ROADMAP Queue A 12f."""
from .io import save, load  # noqa: F401
