"""GoogLeNet / InceptionV1 (reference:
python/paddle/vision/models/googlenet.py API — returns (out, aux1, aux2)
in train mode like the reference)."""
import paddle_tpu_torch as paddle
from paddle_tpu_torch import nn
from . import _pretrained


class _Inception(nn.Layer):
    def __init__(self, in_ch, c1, c3r, c3, c5r, c5, proj):
        super().__init__()
        self.b1 = nn.Sequential(nn.Conv2D(in_ch, c1, 1), nn.ReLU())
        self.b2 = nn.Sequential(nn.Conv2D(in_ch, c3r, 1), nn.ReLU(),
                                nn.Conv2D(c3r, c3, 3, padding=1), nn.ReLU())
        self.b3 = nn.Sequential(nn.Conv2D(in_ch, c5r, 1), nn.ReLU(),
                                nn.Conv2D(c5r, c5, 5, padding=2), nn.ReLU())
        self.b4 = nn.Sequential(nn.MaxPool2D(3, 1, padding=1),
                                nn.Conv2D(in_ch, proj, 1), nn.ReLU())

    def forward(self, x):
        return paddle.concat([self.b1(x), self.b2(x), self.b3(x),
                              self.b4(x)], axis=1)


class GoogLeNet(nn.Layer):
    def __init__(self, num_classes=1000, with_pool=True):
        super().__init__()
        self.stem = nn.Sequential(
            nn.Conv2D(3, 64, 7, stride=2, padding=3), nn.ReLU(),
            nn.MaxPool2D(3, 2, padding=1),
            nn.Conv2D(64, 64, 1), nn.ReLU(),
            nn.Conv2D(64, 192, 3, padding=1), nn.ReLU(),
            nn.MaxPool2D(3, 2, padding=1))
        self.i3a = _Inception(192, 64, 96, 128, 16, 32, 32)
        self.i3b = _Inception(256, 128, 128, 192, 32, 96, 64)
        self.pool3 = nn.MaxPool2D(3, 2, padding=1)
        self.i4a = _Inception(480, 192, 96, 208, 16, 48, 64)
        self.i4b = _Inception(512, 160, 112, 224, 24, 64, 64)
        self.i4c = _Inception(512, 128, 128, 256, 24, 64, 64)
        self.i4d = _Inception(512, 112, 144, 288, 32, 64, 64)
        self.i4e = _Inception(528, 256, 160, 320, 32, 128, 128)
        self.pool4 = nn.MaxPool2D(3, 2, padding=1)
        self.i5a = _Inception(832, 256, 160, 320, 32, 128, 128)
        self.i5b = _Inception(832, 384, 192, 384, 48, 128, 128)
        self.num_classes = num_classes
        self.with_pool = with_pool
        if with_pool:
            self.pool5 = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.dropout = nn.Dropout(0.2)
            self.fc = nn.Linear(1024, num_classes)
            # aux heads (reference keeps them)
            self.aux1 = nn.Sequential(
                nn.AdaptiveAvgPool2D(4), nn.Conv2D(512, 128, 1), nn.ReLU(),
                nn.Flatten(1), nn.Linear(128 * 16, 1024), nn.ReLU(),
                nn.Dropout(0.7), nn.Linear(1024, num_classes))
            self.aux2 = nn.Sequential(
                nn.AdaptiveAvgPool2D(4), nn.Conv2D(528, 128, 1), nn.ReLU(),
                nn.Flatten(1), nn.Linear(128 * 16, 1024), nn.ReLU(),
                nn.Dropout(0.7), nn.Linear(1024, num_classes))

    def forward(self, x):
        x = self.stem(x)
        x = self.pool3(self.i3b(self.i3a(x)))
        x = self.i4a(x)
        aux1 = self.aux1(x) if self.num_classes > 0 and self.training \
            else None
        x = self.i4d(self.i4c(self.i4b(x)))
        aux2 = self.aux2(x) if self.num_classes > 0 and self.training \
            else None
        x = self.pool4(self.i4e(x))
        x = self.i5b(self.i5a(x))
        if self.with_pool:
            x = self.pool5(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(nn.Flatten(1)(x)))
        if self.training and self.num_classes > 0:
            return x, aux1, aux2
        return x


def googlenet(pretrained=False, **kwargs):
    _pretrained.refuse(pretrained)
    return GoogLeNet(**kwargs)
