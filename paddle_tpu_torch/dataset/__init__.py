"""paddle.dataset (reference: python/paddle/dataset/) — legacy reader-style
dataset loaders, the port of ``paddle_tpu/dataset``. The reference
downloads archives; there is no network here, so each loader reads a local
copy when present (under ``common.DATA_HOME``) and otherwise falls back to
the reference's small deterministic synthetic sample, item for item the
reference's (``RandomState(seed)``)."""
from . import common  # noqa: F401
from . import mnist  # noqa: F401
from . import cifar  # noqa: F401
from . import uci_housing  # noqa: F401
from . import imdb  # noqa: F401
from . import imikolov  # noqa: F401
from . import movielens  # noqa: F401
from . import conll05  # noqa: F401
from . import flowers  # noqa: F401
from . import voc2012  # noqa: F401
from . import wmt14  # noqa: F401
from . import wmt16  # noqa: F401
from . import image  # noqa: F401

__all__ = []
