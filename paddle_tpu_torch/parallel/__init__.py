"""Training steps of the port (``paddle_tpu/parallel`` counterpart)."""
from .train_step import TrainStep  # noqa: F401
