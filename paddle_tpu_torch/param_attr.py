"""ParamAttr / WeightNormParamAttr (reference: python/paddle/fluid/param_attr.py)."""
from __future__ import annotations

__all__ = ["ParamAttr", "WeightNormParamAttr"]


class ParamAttr:
    def __init__(
        self,
        name=None,
        initializer=None,
        learning_rate=1.0,
        regularizer=None,
        trainable=True,
        gradient_clip=None,
        do_model_average=None,  # None -> averaged (reference: the model_average/do_model_average kwarg mismatch makes every param average-eligible by default)
    ):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip
        self.do_model_average = do_model_average

    def _set_default_initializer(self, initializer):
        if self.initializer is None:
            self.initializer = initializer

    @staticmethod
    def _to_attr(arg):
        """Normalize user input: None | bool | str | Initializer | ParamAttr |
        list thereof (reference param_attr.py:71)."""
        if arg is None:
            return ParamAttr()
        if isinstance(arg, (list, tuple)):
            return [ParamAttr._to_attr(a) for a in arg]
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if isinstance(arg, bool):
            return ParamAttr._to_attr(None) if arg else False
        from .initializer import Initializer

        if isinstance(arg, Initializer):
            return ParamAttr(initializer=arg)
        raise TypeError("cannot interpret %r as ParamAttr" % (arg,))

    def _to_kwargs(self, with_initializer=False):
        kw = {
            "name": self.name,
            "optimize_attr": {"learning_rate": self.learning_rate},
            "regularizer": self.regularizer,
            "trainable": self.trainable,
            "gradient_clip_attr": self.gradient_clip,
            "do_model_average": self.do_model_average,
        }
        if with_initializer:
            kw["initializer"] = self.initializer
        return kw


class WeightNormParamAttr(ParamAttr):
    def __init__(self, dim=None, **kwargs):
        super().__init__(**kwargs)
        self.dim = dim
