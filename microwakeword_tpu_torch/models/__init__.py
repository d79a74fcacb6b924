"""Models: the streaming MixedNet and Inception families."""

from microwakeword_tpu_torch.models.inception import Inception, InceptionConfig  # noqa: F401
from microwakeword_tpu_torch.models.mixednet import MixedNet, MixedNetConfig  # noqa: F401
from microwakeword_tpu_torch.models.registry import ModelBundle, build_model  # noqa: F401
