"""ShuffleNetV2 (reference: python/paddle/vision/models/shufflenetv2.py
API)."""
import paddle_tpu_torch as paddle
from paddle_tpu_torch import nn
from . import _pretrained


def _channel_shuffle(x, groups):
    return paddle.nn.functional.channel_shuffle(x, groups)


class _InvertedResidual(nn.Layer):
    def __init__(self, in_ch, out_ch, stride, act="relu"):
        super().__init__()
        self.stride = stride
        Act = nn.Swish if act == "swish" else nn.ReLU
        branch = out_ch // 2
        if stride == 2:
            self.branch1 = nn.Sequential(
                nn.Conv2D(in_ch, in_ch, 3, stride=2, padding=1,
                          groups=in_ch, bias_attr=False),
                nn.BatchNorm2D(in_ch),
                nn.Conv2D(in_ch, branch, 1, bias_attr=False),
                nn.BatchNorm2D(branch), Act())
            b2_in = in_ch
        else:
            self.branch1 = None
            b2_in = in_ch // 2
        self.branch2 = nn.Sequential(
            nn.Conv2D(b2_in, branch, 1, bias_attr=False),
            nn.BatchNorm2D(branch), Act(),
            nn.Conv2D(branch, branch, 3, stride=stride, padding=1,
                      groups=branch, bias_attr=False),
            nn.BatchNorm2D(branch),
            nn.Conv2D(branch, branch, 1, bias_attr=False),
            nn.BatchNorm2D(branch), Act())

    def forward(self, x):
        if self.stride == 1:
            c = x.shape[1] // 2
            x1, x2 = x[:, :c], x[:, c:]
            out = paddle.concat([x1, self.branch2(x2)], axis=1)
        else:
            out = paddle.concat([self.branch1(x), self.branch2(x)], axis=1)
        return _channel_shuffle(out, 2)


_CFGS = {
    "x0_25": ([24, 48, 96, 192], 512),
    "x0_33": ([24, 32, 64, 128], 512),
    "x0_5": ([24, 48, 96, 192], 1024),
    "x1_0": ([24, 116, 232, 464], 1024),
    "x1_5": ([24, 176, 352, 704], 1024),
    "x2_0": ([24, 244, 488, 976], 2048),
}
_REPEATS = [4, 8, 4]


class ShuffleNetV2(nn.Layer):
    def __init__(self, scale=1.0, act="relu", num_classes=1000,
                 with_pool=True):
        super().__init__()
        key = {0.25: "x0_25", 0.33: "x0_33", 0.5: "x0_5", 1.0: "x1_0",
               1.5: "x1_5", 2.0: "x2_0"}[scale]
        chans, last = _CFGS[key]
        self.conv1 = nn.Sequential(
            nn.Conv2D(3, chans[0], 3, stride=2, padding=1,
                      bias_attr=False),
            nn.BatchNorm2D(chans[0]), nn.ReLU())
        self.maxpool = nn.MaxPool2D(3, 2, padding=1)
        blocks = []
        in_ch = chans[0]
        for stage, rep in enumerate(_REPEATS):
            out_ch = chans[stage + 1]
            blocks.append(_InvertedResidual(in_ch, out_ch, 2, act))
            for _ in range(rep - 1):
                blocks.append(_InvertedResidual(out_ch, out_ch, 1, act))
            in_ch = out_ch
        self.blocks = nn.Sequential(*blocks)
        self.conv_last = nn.Sequential(
            nn.Conv2D(in_ch, last, 1, bias_attr=False),
            nn.BatchNorm2D(last), nn.ReLU())
        self.num_classes = num_classes
        self.with_pool = with_pool
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(last, num_classes)

    def forward(self, x):
        x = self.conv_last(self.blocks(self.maxpool(self.conv1(x))))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(nn.Flatten(1)(x))
        return x


def _factory(scale, act="relu"):
    def f(pretrained=False, **kwargs):
        _pretrained.refuse(pretrained)
        return ShuffleNetV2(scale=scale, act=act, **kwargs)
    return f


shufflenet_v2_x0_25 = _factory(0.25)
shufflenet_v2_x0_33 = _factory(0.33)
shufflenet_v2_x0_5 = _factory(0.5)
shufflenet_v2_x1_0 = _factory(1.0)
shufflenet_v2_x1_5 = _factory(1.5)
shufflenet_v2_x2_0 = _factory(2.0)
shufflenet_v2_swish = _factory(1.0, act="swish")
