"""paddle.text.datasets namespace (reference:
python/paddle/text/datasets/__init__.py re-exports)."""
from . import (  # noqa: F401
    Conll05st, Imdb, Imikolov, Movielens, UCIHousing, WMT14, WMT16,
)
