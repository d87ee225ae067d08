"""paddle.tensor: the port of ``paddle_tpu/tensor`` (reference:
python/paddle/tensor), a flat re-export of the op library, so that
``paddle.tensor.math.add`` style imports and the tensor arrays work."""
from ..ops import math, creation, manipulation, logic, search  # noqa: F401
from ..ops import array  # noqa: F401
from ..ops.array import (  # noqa: F401
    array_length, array_read, array_write, create_array,
    StaticTensorArray)
from ..ops import linalg, random, extra, compat  # noqa: F401
from ..ops.math import *  # noqa: F401,F403
from ..ops.creation import *  # noqa: F401,F403
from ..ops.manipulation import *  # noqa: F401,F403
from ..ops.logic import *  # noqa: F401,F403
from ..ops.search import *  # noqa: F401,F403
from ..core.tensor import Tensor  # noqa: F401
