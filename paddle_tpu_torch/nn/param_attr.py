"""ParamAttr — counterpart of ``paddle_tpu/nn/param_attr.py``: the name,
initializer, learning-rate factor, regularizer and trainability a
layer's ``create_parameter`` gives a parameter."""
from __future__ import annotations


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(arg):
        """None, False, a ``ParamAttr``, a name or an initializer as a
        ``ParamAttr`` (None and False pass through)."""
        from . import initializer as I
        if arg is None or arg is False:
            return arg
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if isinstance(arg, I.Initializer):
            return ParamAttr(initializer=arg)
        raise TypeError("cannot interpret %r as ParamAttr" % (arg,))
