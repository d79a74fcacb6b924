"""Training loop, metrics and checkpoint policy."""

from microwakeword_tpu_torch.train.loop import train  # noqa: F401
from microwakeword_tpu_torch.train.metrics import (  # noqa: F401
    confusion_at_cutoffs,
    validation_metrics,
)
