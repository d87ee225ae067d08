"""DenseNet (reference: python/paddle/vision/models/densenet.py API)."""
import paddle_tpu_torch as paddle
from paddle_tpu_torch import nn
from . import _pretrained


class _DenseLayer(nn.Layer):
    def __init__(self, in_ch, growth_rate, bn_size, dropout):
        super().__init__()
        self.bn1 = nn.BatchNorm2D(in_ch)
        self.conv1 = nn.Conv2D(in_ch, bn_size * growth_rate, 1,
                               bias_attr=False)
        self.bn2 = nn.BatchNorm2D(bn_size * growth_rate)
        self.conv2 = nn.Conv2D(bn_size * growth_rate, growth_rate, 3,
                               padding=1, bias_attr=False)
        self.relu = nn.ReLU()
        self.dropout = nn.Dropout(dropout) if dropout else None

    def forward(self, x):
        out = self.conv1(self.relu(self.bn1(x)))
        out = self.conv2(self.relu(self.bn2(out)))
        if self.dropout is not None:
            out = self.dropout(out)
        return paddle.concat([x, out], axis=1)


class _Transition(nn.Layer):
    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.bn = nn.BatchNorm2D(in_ch)
        self.conv = nn.Conv2D(in_ch, out_ch, 1, bias_attr=False)
        self.relu = nn.ReLU()
        self.pool = nn.AvgPool2D(2, 2)

    def forward(self, x):
        return self.pool(self.conv(self.relu(self.bn(x))))


_CFG = {121: (64, 32, [6, 12, 24, 16]),
        161: (96, 48, [6, 12, 36, 24]),
        169: (64, 32, [6, 12, 32, 32]),
        201: (64, 32, [6, 12, 48, 32]),
        264: (64, 32, [6, 12, 64, 48])}


class DenseNet(nn.Layer):
    def __init__(self, layers=121, bn_size=4, dropout=0.0,
                 num_classes=1000, with_pool=True):
        super().__init__()
        init_ch, growth, blocks = _CFG[layers]
        self.conv0 = nn.Conv2D(3, init_ch, 7, stride=2, padding=3,
                               bias_attr=False)
        self.bn0 = nn.BatchNorm2D(init_ch)
        self.relu = nn.ReLU()
        self.pool0 = nn.MaxPool2D(3, 2, padding=1)
        ch = init_ch
        feats = []
        for i, n in enumerate(blocks):
            for _ in range(n):
                feats.append(_DenseLayer(ch, growth, bn_size, dropout))
                ch += growth
            if i != len(blocks) - 1:
                feats.append(_Transition(ch, ch // 2))
                ch //= 2
        self.features = nn.Sequential(*feats)
        self.bn_final = nn.BatchNorm2D(ch)
        self.num_classes = num_classes
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Linear(ch, num_classes)

    def forward(self, x):
        x = self.pool0(self.relu(self.bn0(self.conv0(x))))
        x = self.relu(self.bn_final(self.features(x)))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(nn.Flatten(1)(x))
        return x


def _make(layers):
    def f(pretrained=False, **kwargs):
        _pretrained.refuse(pretrained)
        return DenseNet(layers=layers, **kwargs)
    f.__name__ = f"densenet{layers}"
    return f


densenet121 = _make(121)
densenet161 = _make(161)
densenet169 = _make(169)
densenet201 = _make(201)
densenet264 = _make(264)
