"""Vision model zoo of the port (counterpart of
mxnet_tpu/gluon/model_zoo/vision/__init__.py): ResNet V1 and V2, VGG,
AlexNet, DenseNet, SqueezeNet, Inception V3 and MobileNet V1 and V2, with
the reference's ``get_model`` names. Weights are random; pretrained ones
are not available offline (``convert.load_numpy_params`` carries weights
in)."""
from .alexnet import *  # noqa: F401,F403
from .densenet import *  # noqa: F401,F403
from .inception import *  # noqa: F401,F403
from .mobilenet import *  # noqa: F401,F403
from .resnet import *  # noqa: F401,F403
from .squeezenet import *  # noqa: F401,F403
from .vgg import *  # noqa: F401,F403

from .alexnet import alexnet
from .densenet import densenet121, densenet161, densenet169, densenet201
from .inception import inception_v3
from .mobilenet import (mobilenet1_0, mobilenet0_75, mobilenet0_5,
                        mobilenet0_25, mobilenet_v2_1_0, mobilenet_v2_0_75,
                        mobilenet_v2_0_5, mobilenet_v2_0_25)
from .resnet import (resnet18_v1, resnet34_v1, resnet50_v1, resnet101_v1,
                     resnet152_v1, resnet18_v2, resnet34_v2, resnet50_v2,
                     resnet101_v2, resnet152_v2)
from .squeezenet import squeezenet1_0, squeezenet1_1
from .vgg import (vgg11, vgg13, vgg16, vgg19, vgg11_bn, vgg13_bn, vgg16_bn,
                  vgg19_bn)

_models = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1,
    "resnet18_v2": resnet18_v2, "resnet34_v2": resnet34_v2,
    "resnet50_v2": resnet50_v2, "resnet101_v2": resnet101_v2,
    "resnet152_v2": resnet152_v2,
    "vgg11": vgg11, "vgg13": vgg13, "vgg16": vgg16, "vgg19": vgg19,
    "vgg11_bn": vgg11_bn, "vgg13_bn": vgg13_bn, "vgg16_bn": vgg16_bn,
    "vgg19_bn": vgg19_bn,
    "alexnet": alexnet,
    "densenet121": densenet121, "densenet161": densenet161,
    "densenet169": densenet169, "densenet201": densenet201,
    "squeezenet1.0": squeezenet1_0, "squeezenet1.1": squeezenet1_1,
    "inceptionv3": inception_v3,
    "mobilenet1.0": mobilenet1_0, "mobilenet0.75": mobilenet0_75,
    "mobilenet0.5": mobilenet0_5, "mobilenet0.25": mobilenet0_25,
    "mobilenetv2_1.0": mobilenet_v2_1_0, "mobilenetv2_0.75": mobilenet_v2_0_75,
    "mobilenetv2_0.5": mobilenet_v2_0_5, "mobilenetv2_0.25": mobilenet_v2_0_25,
}


def get_model(name, **kwargs):
    """A model by its reference name; ValueError for an unknown one."""
    name = name.lower()
    if name not in _models:
        raise ValueError("Model %s is not supported. Available: %s"
                         % (name, sorted(_models)))
    return _models[name](**kwargs)
