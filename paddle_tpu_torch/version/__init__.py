"""paddle.version (reference: generated python/paddle/version/__init__.py).

Port of ``paddle_tpu/version/__init__.py``, whose answers describe the TPU
build (no CUDA). The port answers from torch (a deliberate difference,
ROADMAP): ``cuda()`` is ``torch.version.cuda``, ``cudnn()`` the cuDNN
version torch was built with, ``nccl()`` torch's NCCL version, each
"False" where torch has none."""
import torch

full_version = "0.1.0"
major = "0"
minor = "1"
patch = "0"
rc = "0"
commit = "unknown"
istaged = False
with_pip = False

xpu_version = "False"
tensorrt_version = "None"
cinn_version = "False"      # the compiler is torch.compile (inductor)


def show():
    print(f"paddle-tpu-torch {full_version}")
    print(f"torch {torch.__version__}")
    print("commit:", commit)
    print(f"cuda: {cuda()}; cudnn: {cudnn()}; nccl: {nccl()}")


def cuda():
    return torch.version.cuda or "False"


def cudnn():
    v = torch.backends.cudnn.version() \
        if torch.backends.cudnn.is_available() else None
    return str(v) if v else "False"


def nccl():
    try:
        v = torch.cuda.nccl.version()
    except (AttributeError, RuntimeError):
        return "0"
    return ".".join(str(p) for p in v) if isinstance(v, tuple) else str(v)


def xpu():
    return xpu_version


def xpu_xccl():
    return "False"


def xpu_xhpc():
    return "False"


def cinn():
    return cinn_version


cuda_version = cuda()
cudnn_version = cudnn()
nccl_version = nccl()
