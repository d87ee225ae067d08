"""Activation layers: the port of ``paddle_tpu/nn/layer/activation.py``
(reference: python/paddle/nn/layer/activation.py)."""
from __future__ import annotations

from .. import functional as F
from .layers import Layer


def _wrap(fname, **fixed):
    class _Act(Layer):
        def __init__(self, *args, **kwargs):
            super().__init__()
            self._kwargs = dict(fixed)
            # positional args map onto the functional's signature after x
            import inspect
            fn = getattr(F, fname)
            params = list(inspect.signature(fn).parameters)[1:]
            for name, val in zip(params, args):
                self._kwargs[name] = val
            self._kwargs.update(kwargs)
            self._kwargs.pop("name", None)

        def forward(self, x):
            return getattr(F, fname)(x, **self._kwargs)
    _Act.__name__ = fname
    return _Act


ReLU = _wrap("relu")
ReLU6 = _wrap("relu6")
LeakyReLU = _wrap("leaky_relu")
ELU = _wrap("elu")
SELU = _wrap("selu")
CELU = _wrap("celu")
GELU = _wrap("gelu")
Silu = _wrap("silu")
Swish = _wrap("swish")
Mish = _wrap("mish")
Hardswish = _wrap("hardswish")
Hardsigmoid = _wrap("hardsigmoid")
Hardtanh = _wrap("hardtanh")
Hardshrink = _wrap("hardshrink")
Softshrink = _wrap("softshrink")
Tanhshrink = _wrap("tanhshrink")
Softplus = _wrap("softplus")
Softsign = _wrap("softsign")
Sigmoid = _wrap("sigmoid")
LogSigmoid = _wrap("log_sigmoid")
Tanh = _wrap("tanh")
Softmax = _wrap("softmax")
LogSoftmax = _wrap("log_softmax")
Maxout = _wrap("maxout")
ThresholdedReLU = _wrap("thresholded_relu")
GLU = _wrap("glu")
RReLU = _wrap("rrelu")


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        from .. import initializer as I
        self._data_format = data_format
        self.weight = self.create_parameter(
            (num_parameters,), weight_attr,
            default_initializer=I.Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, self._data_format)
