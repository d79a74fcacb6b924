"""Models: the streaming MixedNet (the Inception model waits for its slice)."""

from microwakeword_tpu_torch.models.mixednet import MixedNet, MixedNetConfig  # noqa: F401
from microwakeword_tpu_torch.models.registry import ModelBundle, build_model  # noqa: F401
