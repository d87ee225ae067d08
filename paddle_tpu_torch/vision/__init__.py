"""paddle.vision: the port of ``paddle_tpu/vision/__init__.py`` (datasets,
the model zoo, the detection ops of ``ops``, transforms and the image
backend switch)."""
from . import datasets  # noqa: F401
from . import models  # noqa: F401
from . import ops  # noqa: F401
from . import transforms  # noqa: F401

_image_backend = "pil"


def set_image_backend(backend):
    """'pil' | 'cv2' | 'tensor' (reference vision/image.py). Decoding here
    always goes through numpy; the flag controls the return container."""
    global _image_backend
    if backend not in ("pil", "cv2", "tensor"):
        raise ValueError(f"unknown image backend {backend!r}")
    _image_backend = backend


def get_image_backend():
    return _image_backend


def image_load(path, backend=None):
    """Load an image file -> HWC uint8 numpy (or PIL when backend='pil'
    and Pillow is available)."""
    backend = backend or _image_backend
    try:
        from PIL import Image
        img = Image.open(path)
        if backend == "pil":
            return img
        import numpy as np
        arr = np.asarray(img)
        if backend == "tensor":
            from ..core.tensor import Tensor
            return Tensor(arr)
        return arr
    except ImportError:
        import numpy as np
        if path.endswith(".npy"):
            return np.load(path)
        raise RuntimeError(
            "image decoding requires Pillow (not available) — "
            "use .npy inputs")
