"""Evaluation: cooldown accept counts, false accepts per hour, ROC curves."""

from microwakeword_tpu_torch.evaluate.roc import (  # noqa: F401
    compute_false_accepts_per_hour,
    count_accepts,
    generate_roc_curve,
    moving_average,
)
from microwakeword_tpu_torch.evaluate.streaming_eval import (  # noqa: F401
    ambient_accept_counts,
    model_accuracy,
    streaming_model_roc,
)
