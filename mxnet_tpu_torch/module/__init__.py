"""Module API: the symbolic training interface (counterpart of
mxnet_tpu/module/; ref: python/mxnet/module/).

The reference's layers stay: BaseModule -> Module / BucketingModule over
DataParallelExecutorGroup over Executor. The group binds one executor on
one device; several devices arrive with the multi-device slice.
"""
from .base_module import BaseModule
from .module import Module
from .bucketing_module import BucketingModule
from .executor_group import DataParallelExecutorGroup

__all__ = ["BaseModule", "Module", "BucketingModule",
           "DataParallelExecutorGroup"]
