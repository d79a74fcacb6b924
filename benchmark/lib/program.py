"""What the benchmark takes from the program under test: its model bundle
built from the configuration file.  The program is imported inside the
functions, after the harness has set its environment."""

from __future__ import annotations


def bundle(cell):
    """The program's ``ModelBundle`` of the cell's family and model settings."""
    from microwakeword_tpu_torch.models import build_model
    from microwakeword_tpu_torch.models.registry import FAMILIES

    def frozen(v):
        return tuple(frozen(x) for x in v) if isinstance(v, list) else v

    fields = {k: frozen(v) for k, v in cell.config["model"].items()}
    return build_model(cell.family, FAMILIES[cell.family][0](**fields))
