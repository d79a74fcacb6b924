"""Sweep CLI (port of sweep.py): train a population of model variants at once
on the card and select each member's best checkpoint.

    python -m microwakeword_tpu_torch.sweep --training_config config.yaml \\
        --n_models 8 --learning_rates "0.001,0.0005" --seeds "0,1,2,..." \\
        mixednet --pointwise_filters "64,64,64,64" ...

The flags are the JAX sweep's, plus ``--device`` (default ``cuda``; ``--device
cpu`` runs on the CPU).  The members' weights are stacked and one
member-batched step trains them all (``parallel/population.py``); every eval
interval each member's validation metrics go through the two-step
best-checkpoint rule.  Sweep axes: seeds, learning rates, positive and
negative class weights, each cycled to ``--n_models`` if shorter.  The
architecture is one per run.

Outputs under ``train_dir``: ``member_XX/best_weights.pt`` (the port's weight
format, for ``train.loop.load_weights``), ``leaderboard.json`` (the JAX
sweep's keys) and ``sweep_config.yaml``.  ``main`` parses the flags and the
YAML and writes ``sweep_config.yaml``; ``run`` does the rest and needs no
PyYAML.  ``--mesh D`` splits the ``--n_models`` members over D ranks in
blocks of n_models / D (under ``torchrun`` or self-started, as in
``model_train_eval``); ``auto`` takes the largest count of two or more
visible cards that divides ``--n_models``.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from microwakeword_tpu_torch import model_train_eval as CLI
from microwakeword_tpu_torch.device import resolve_device


def _cycle(values, n):
    values = list(values)
    return [values[i % len(values)] for i in range(n)]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--training_config", type=str, required=True)
    parser.add_argument("--n_models", type=int, default=8)
    parser.add_argument("--seeds", type=str, default="")
    parser.add_argument("--learning_rates", type=str, default="")
    parser.add_argument("--positive_class_weights", type=str, default="")
    parser.add_argument("--negative_class_weights", type=str, default="")
    parser.add_argument("--steps", type=int, default=0,
                        help="override total steps (default: sum of the config's training_steps)")
    parser.add_argument("--mesh", type=str, default="auto",
                        help="'auto' (every visible card that divides n_models, one device "
                             "below two), 'off' (one device), or a rank count N: the members "
                             "split over N ranks (NCCL on cards, gloo with --device cpu)")
    parser.add_argument("--share_batch", type=int, default=1,
                        help="1 (default): every member trains on member 0's batch stream (one "
                             "gather per step serves the population; members are not "
                             "independent draws); 0: every member draws its own batches and "
                             "follows the run it would have alone")
    parser.add_argument("--device", type=str, default="cuda",
                        help="the device to train on: cuda (default) or cpu")
    sub = parser.add_subparsers(dest="model_name", required=True)
    CLI.add_mixednet_flags(sub.add_parser("mixednet"))
    CLI.add_inception_flags(sub.add_parser("inception"))
    return parser


def run(flags, config: dict) -> dict:
    """Trains the population and writes the members' weights and the
    leaderboard.  Returns {"sweep": the values sweep_config.yaml records,
    "history", "selection" (None without validation data), "variables"
    (the final stacked state)}; over a mesh rank 0 writes the files and its
    result is returned."""
    from microwakeword_tpu_torch.data.store import FeatureHandler
    from microwakeword_tpu_torch.models import build_model
    from microwakeword_tpu_torch.parallel import mesh as M
    from microwakeword_tpu_torch.parallel.corpus import broadcast_packed
    from microwakeword_tpu_torch.parallel.population import member_variables, train_population

    size = M.mesh_size(flags.mesh, flags.n_models, flags.device)
    if size and not M.in_process_group():
        return M.launch(run, size, flags.device, flags, config)[0]
    mesh = M.create_mesh(size, flags.device) if size else None
    dev = mesh.device if mesh is not None else resolve_device(flags.device)
    main = mesh is None or mesh.is_main
    n = flags.n_models
    bundle = build_model(flags.model_name, config["model_config"])
    fh = FeatureHandler(config, dev)

    seeds = _cycle(CLI.parse(flags.seeds) or list(range(n)), n)
    lrs = _cycle(CLI.parse(flags.learning_rates) or (config.get("learning_rates") or [0.001]), n)
    pos_w = _cycle(CLI.parse(flags.positive_class_weights)
                   or (config.get("positive_class_weight") or [1.0]), n)
    neg_w = _cycle(CLI.parse(flags.negative_class_weights)
                   or (config.get("negative_class_weight") or [1.0]), n)
    steps = flags.steps or sum(config.get("training_steps") or [20000])
    batch_size = int(config.get("batch_size", 128))
    features_length = int(config["spectrogram_length"])
    if mesh is None:
        packed = fh.pack_training(dev)
    else:  # every rank's members train on rank 0's corpus
        packed = broadcast_packed(fh.pack_training(dev) if main else None, mesh)

    validation, ambient, ambient_hours = None, None, 0.0
    if fh.get_mode_size("validation") > 0:
        val_x, val_y, _ = fh.get_data("validation", batch_size, features_length, "truncate_start")
        validation = (val_x, val_y)
        if fh.get_mode_size("validation_ambient") > 0:
            ambient, _, _ = fh.get_data("validation_ambient", batch_size, features_length, "split")
            ambient_hours = fh.get_mode_duration("validation_ambient") / 3600.0

    sa = {
        "time_mask_max_size": int((config.get("time_mask_max_size") or [5])[0]),
        "time_mask_count": int((config.get("time_mask_count") or [2])[0]),
        "freq_mask_max_size": int((config.get("freq_mask_max_size") or [5])[0]),
        "freq_mask_count": int((config.get("freq_mask_count") or [2])[0]),
    }
    result = train_population(
        bundle, packed, n_models=n, steps=steps, batch_size=batch_size,
        features_length=features_length, seeds=seeds, learning_rates=lrs,
        positive_class_weights=pos_w, negative_class_weights=neg_w, mesh=mesh, spec_augment=sa,
        eval_interval=int(config.get("eval_step_interval", 500)), validation=validation,
        ambient=ambient, ambient_hours=ambient_hours,
        minimization_metric=config.get("minimization_metric"),
        maximization_metric=config.get("maximization_metric", "average_viable_recall"),
        target_minimization=float(config.get("target_minimization", 0.9)),
        steps_per_call=int(config.get("steps_per_call", 1)), share_batch=bool(flags.share_batch),
        device=dev)
    variables, history = result[:2]
    selection = result[2] if validation is not None else None
    sweep = {
        "n_models": n,
        "seeds": [int(s) for s in seeds],
        "learning_rates": [float(v) for v in lrs],
        "positive_class_weights": [float(v) for v in pos_w],
        "negative_class_weights": [float(v) for v in neg_w],
        "steps": steps,
    }
    out = {"sweep": sweep, "history": history, "selection": selection, "variables": variables}
    if not main:
        return out

    train_dir = config["train_dir"]
    os.makedirs(train_dir, exist_ok=True)
    source = selection["best_variables"] if selection is not None else variables
    for i in range(n):
        member_dir = os.path.join(train_dir, f"member_{i:02d}")
        os.makedirs(member_dir, exist_ok=True)
        state = {k: v.detach().to("cpu").clone() for k, v in member_variables(source, i).items()}
        torch.save(state, os.path.join(member_dir, "best_weights.pt"))
    if selection is not None:
        leaderboard = [
            {k: v for k, v in row.items() if k != "metrics"}
            | {"metrics": {k: float(v) for k, v in (row["metrics"] or {}).items()}}
            for row in selection["leaderboard"]
        ]
        with open(os.path.join(train_dir, "leaderboard.json"), "w") as f:
            json.dump(leaderboard, f, indent=2)
        print(f"leaderboard -> {os.path.join(train_dir, 'leaderboard.json')}")
        for row in leaderboard[:5]:
            print(f"  member {row['member']:2d} seed={row['seed']} "
                  f"lr={row['learning_rate']:.4g} best_step={row['best_step']} "
                  f"min={row['minimization']:.3f} max={row['maximization']:.3f}")
    return out


def main(argv=None) -> int:
    import yaml

    from microwakeword_tpu_torch.config import load_config

    flags = build_parser().parse_args(argv)
    config = load_config(flags.training_config, CLI.model_config_from_flags(flags))
    out = run(flags, config)
    if int(os.environ.get("RANK", 0)) == 0:  # torchrun's rank 0, or alone
        with open(os.path.join(config["train_dir"], "sweep_config.yaml"), "w") as f:
            yaml.safe_dump(out["sweep"], f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
