"""Training over several devices and several models at once (port of
parallel/).

``mesh`` joins the ranks of a data-parallel group (one process per device,
torch.distributed) and holds their collectives; ``train_step`` is one rank's
step on its block of the global batch; ``corpus`` replicates or shards the
training corpus over the ranks; ``eval`` scans tracks over them;
``population`` trains N models of one architecture at once on one card, or
split over the ranks.
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
