"""AMP op lists (counterpart of mxnet_tpu/contrib/amp/lists/)."""
from . import symbol  # noqa: F401
