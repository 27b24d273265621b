"""Weight-update rules (counterpart of mxnet_tpu/optimizer)."""
from .optimizer import Optimizer, SGD, Adam, Updater, create, register, \
    get_updater

opt_registry = Optimizer.opt_registry

__all__ = ["Optimizer", "SGD", "Adam", "Updater", "create", "register",
           "get_updater", "opt_registry"]
