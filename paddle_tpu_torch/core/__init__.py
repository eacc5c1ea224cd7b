"""The Paddle tensor layer of the port — counterpart of
``paddle_tpu/core``: dtypes, flags, places, random state, the ``Tensor``
handle, autograd, the op dispatcher, ``SelectedRows`` and
``RaggedTensor``."""
from . import dtype, device, flags, rng, autograd, dispatch  # noqa: F401
from .tensor import Tensor, Parameter, to_tensor  # noqa: F401
from .autograd import no_grad, enable_grad, grad_enabled  # noqa: F401
