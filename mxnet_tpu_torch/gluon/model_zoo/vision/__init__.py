"""Vision model zoo of the port."""
from .resnet import *  # noqa: F401,F403
