"""Training several models at once on one card (port of parallel/).

Only population training is ported (``population``); the JAX package's
multi-device modules (``mesh``, ``train_step``, ``corpus``, ``eval``) are
ROADMAP queue item 10.
"""

from microwakeword_tpu_torch.parallel.population import (  # noqa: F401
    PopulationTrainStep,
    init_population,
    make_population_eval_fn,
    make_population_train_step,
    member_seed,
    member_variables,
    train_population,
)
