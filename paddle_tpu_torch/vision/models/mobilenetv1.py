"""MobileNetV1 (reference: python/paddle/vision/models/mobilenetv1.py
API). Depthwise-separable convs: depthwise = grouped Conv2D, which XLA
lowers to a channel-tiled conv on the MXU."""
from paddle_tpu_torch import nn
from . import _pretrained


class _ConvBNRelu(nn.Layer):
    def __init__(self, in_ch, out_ch, k, stride=1, padding=0, groups=1):
        super().__init__()
        self.conv = nn.Conv2D(in_ch, out_ch, k, stride=stride,
                              padding=padding, groups=groups,
                              bias_attr=False)
        self.bn = nn.BatchNorm2D(out_ch)
        self.relu = nn.ReLU()

    def forward(self, x):
        return self.relu(self.bn(self.conv(x)))


class _DepthwiseSep(nn.Layer):
    def __init__(self, in_ch, out_ch, stride):
        super().__init__()
        self.dw = _ConvBNRelu(in_ch, in_ch, 3, stride, 1, groups=in_ch)
        self.pw = _ConvBNRelu(in_ch, out_ch, 1)

    def forward(self, x):
        return self.pw(self.dw(x))


class MobileNetV1(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        s = lambda c: max(8, int(c * scale))  # noqa: E731
        cfg = [(s(32), s(64), 1), (s(64), s(128), 2), (s(128), s(128), 1),
               (s(128), s(256), 2), (s(256), s(256), 1),
               (s(256), s(512), 2)] + \
            [(s(512), s(512), 1)] * 5 + \
            [(s(512), s(1024), 2), (s(1024), s(1024), 1)]
        self.conv1 = _ConvBNRelu(3, s(32), 3, 2, 1)
        self.blocks = nn.Sequential(
            *[_DepthwiseSep(i, o, st) for i, o, st in cfg])
        self.num_classes = num_classes
        self.with_pool = with_pool
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(s(1024), num_classes)

    def forward(self, x):
        x = self.blocks(self.conv1(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(nn.Flatten(1)(x))
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    _pretrained.refuse(pretrained)
    return MobileNetV1(scale=scale, **kwargs)
