"""MobileNetV3 Small/Large (reference:
python/paddle/vision/models/mobilenetv3.py API)."""
from paddle_tpu_torch import nn
from . import _pretrained


def _make_divisible(v, divisor=8):
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class _SE(nn.Layer):
    def __init__(self, ch, squeeze=4):
        super().__init__()
        mid = _make_divisible(ch // squeeze)
        self.pool = nn.AdaptiveAvgPool2D(1)
        self.fc1 = nn.Conv2D(ch, mid, 1)
        self.fc2 = nn.Conv2D(mid, ch, 1)
        self.relu = nn.ReLU()
        self.hsig = nn.Hardsigmoid()

    def forward(self, x):
        s = self.hsig(self.fc2(self.relu(self.fc1(self.pool(x)))))
        return x * s


class _InvertedResidual(nn.Layer):
    def __init__(self, in_ch, mid, out_ch, k, stride, use_se, act):
        super().__init__()
        self.use_res = stride == 1 and in_ch == out_ch
        layers = []
        Act = nn.Hardswish if act == "hardswish" else nn.ReLU
        if mid != in_ch:
            layers += [nn.Conv2D(in_ch, mid, 1, bias_attr=False),
                       nn.BatchNorm2D(mid), Act()]
        layers += [nn.Conv2D(mid, mid, k, stride=stride,
                             padding=k // 2, groups=mid, bias_attr=False),
                   nn.BatchNorm2D(mid), Act()]
        if use_se:
            layers.append(_SE(mid))
        layers += [nn.Conv2D(mid, out_ch, 1, bias_attr=False),
                   nn.BatchNorm2D(out_ch)]
        self.block = nn.Sequential(*layers)

    def forward(self, x):
        out = self.block(x)
        return x + out if self.use_res else out


_LARGE = [
    # k, mid, out, se, act, stride
    (3, 16, 16, False, "relu", 1),
    (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1),
    (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1),
    (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hardswish", 2),
    (3, 200, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1),
    (3, 480, 112, True, "hardswish", 1),
    (3, 672, 112, True, "hardswish", 1),
    (5, 672, 160, True, "hardswish", 2),
    (5, 960, 160, True, "hardswish", 1),
    (5, 960, 160, True, "hardswish", 1),
]
_SMALL = [
    (3, 16, 16, True, "relu", 2),
    (3, 72, 24, False, "relu", 2),
    (3, 88, 24, False, "relu", 1),
    (5, 96, 40, True, "hardswish", 2),
    (5, 240, 40, True, "hardswish", 1),
    (5, 240, 40, True, "hardswish", 1),
    (5, 120, 48, True, "hardswish", 1),
    (5, 144, 48, True, "hardswish", 1),
    (5, 288, 96, True, "hardswish", 2),
    (5, 576, 96, True, "hardswish", 1),
    (5, 576, 96, True, "hardswish", 1),
]


class MobileNetV3(nn.Layer):
    def __init__(self, config, last_ch, scale=1.0, num_classes=1000,
                 with_pool=True):
        super().__init__()
        sc = lambda c: _make_divisible(c * scale)  # noqa: E731
        self.conv0 = nn.Sequential(
            nn.Conv2D(3, sc(16), 3, stride=2, padding=1, bias_attr=False),
            nn.BatchNorm2D(sc(16)), nn.Hardswish())
        blocks = []
        in_ch = sc(16)
        for k, mid, out, se, act, st in config:
            blocks.append(_InvertedResidual(in_ch, sc(mid), sc(out), k, st,
                                            se, act))
            in_ch = sc(out)
        self.blocks = nn.Sequential(*blocks)
        last_conv = sc(config[-1][1])
        self.conv_last = nn.Sequential(
            nn.Conv2D(in_ch, last_conv, 1, bias_attr=False),
            nn.BatchNorm2D(last_conv), nn.Hardswish())
        self.num_classes = num_classes
        self.with_pool = with_pool
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(last_conv, last_ch), nn.Hardswish(),
                nn.Dropout(0.2), nn.Linear(last_ch, num_classes))

    def forward(self, x):
        x = self.conv_last(self.blocks(self.conv0(x)))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(nn.Flatten(1)(x))
        return x


class MobileNetV3Small(MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__(_SMALL, 1024, scale, num_classes, with_pool)


class MobileNetV3Large(MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__(_LARGE, 1280, scale, num_classes, with_pool)


def mobilenet_v3_small(pretrained=False, scale=1.0, **kwargs):
    _pretrained.refuse(pretrained)
    return MobileNetV3Small(scale=scale, **kwargs)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kwargs):
    _pretrained.refuse(pretrained)
    return MobileNetV3Large(scale=scale, **kwargs)
