"""AlexNet (reference: python/paddle/vision/models/alexnet.py API)."""
from paddle_tpu_torch import nn
from . import _pretrained


class AlexNet(nn.Layer):
    def __init__(self, num_classes=1000):
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2D(3, 64, 11, stride=4, padding=2), nn.ReLU(),
            nn.MaxPool2D(3, 2),
            nn.Conv2D(64, 192, 5, padding=2), nn.ReLU(),
            nn.MaxPool2D(3, 2),
            nn.Conv2D(192, 384, 3, padding=1), nn.ReLU(),
            nn.Conv2D(384, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2D(256, 256, 3, padding=1), nn.ReLU(),
            nn.MaxPool2D(3, 2),
        )
        self.num_classes = num_classes
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(0.5), nn.Linear(256 * 6 * 6, 4096), nn.ReLU(),
                nn.Dropout(0.5), nn.Linear(4096, 4096), nn.ReLU(),
                nn.Linear(4096, num_classes),
            )
        self.pool = nn.AdaptiveAvgPool2D((6, 6))

    def forward(self, x):
        x = self.features(x)
        x = self.pool(x)
        x = nn.Flatten(1)(x)
        if self.num_classes > 0:
            x = self.classifier(x)
        return x


def alexnet(pretrained=False, **kwargs):
    _pretrained.refuse(pretrained)
    return AlexNet(**kwargs)
