"""Weight-update rules (counterpart of mxnet_tpu/optimizer)."""
from .optimizer import *  # noqa: F401,F403
from .optimizer import Optimizer, Updater, create, register, get_updater

opt_registry = Optimizer.opt_registry
