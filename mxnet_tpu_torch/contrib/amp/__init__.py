"""AMP, automatic mixed precision (counterpart of
mxnet_tpu/contrib/amp/; ref: python/mxnet/contrib/amp/__init__.py)."""
from .amp import *  # noqa: F401,F403
from .amp import _reset  # noqa: F401  (testing hook)
from .loss_scaler import LossScaler  # noqa: F401
