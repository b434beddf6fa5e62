"""The system under test, built as its own entry point builds it.

``experiments/run.py`` turns its flags into an ``ExperimentConfig``, a
``FedAvgConfig`` (``_fedavg_config``), the dataset's task loss, the
CIFAR augmentation (``_augment_fn``) and a ``FedAvgSimulation``
(``_simulation``); the benchmark calls those same functions with the
cell's settings and a ``FedDataset`` of the generated data.  The
simulation's initial variables are the benchmark's (``weights.py``): the
bundle's ``init`` hands them over in place of its own draw."""

from __future__ import annotations

from typing import Callable, Optional


def experiment_config(cfg: dict, traffic: dict, seed: int, device_name: str):
    from fedml_tpu_torch.experiments.run import ExperimentConfig

    opt = cfg["optimizer"]
    return ExperimentConfig(
        algorithm=traffic["algorithm"], dataset=traffic["dataset"],
        client_num_in_total=traffic["clients"], client_num_per_round=traffic["clients"],
        batch_size=traffic["batch_size"], epochs=traffic["epochs"],
        client_optimizer=opt["name"], lr=opt["lr"], momentum=opt["momentum"],
        wd=opt["weight_decay"], comm_round=1, seed=int(seed),
        compute_dtype=cfg["compute_dtype"], data_augmentation=int(bool(traffic.get("augment"))),
        device=device_name)


def build_simulation(family, cfg: dict, traffic: dict, data, variables, seed: int, device,
                     loss_wrap: Optional[Callable] = None):
    """The ``FedAvgSimulation`` of one run.  ``loss_wrap`` (tests and the
    planted faults only) wraps the task loss the local update is given."""
    from fedml_tpu_torch.core.metrics import MetricsLogger
    from fedml_tpu_torch.core.types import FedDataset
    from fedml_tpu_torch.experiments.registry import task_loss_for_dataset
    from fedml_tpu_torch.experiments.run import _augment_fn, _simulation

    ecfg = experiment_config(cfg, traffic, seed, device.type if device.type == "cpu" else "")
    ds = FedDataset(data.train_x, data.train_y, None, None, data.train_client_idx, None,
                    data.num_classes, traffic["dataset"])
    bundle = family.program_bundle(cfg, traffic, device)
    _check_names(bundle, variables)
    bundle.init = lambda key: variables
    loss_fn = task_loss_for_dataset(ecfg.dataset)
    if loss_wrap is not None:
        loss_fn = loss_wrap(loss_fn)
    return _simulation(ecfg, ds, bundle, loss_fn=loss_fn, metrics=MetricsLogger(),
                       device=device, augment_fn=_augment_fn(ecfg, ds))


def _check_names(bundle, variables) -> None:
    """The benchmark's variables are the model's, name for name and shape for shape."""
    want = {"params": {n: tuple(p.shape) for n, p in bundle.module.named_parameters()}}
    stats = {n: tuple(b.shape) for n, b in bundle.module.named_buffers()}
    if stats:
        want["batch_stats"] = stats
    have = {g: {n: tuple(t.shape) for n, t in leaves.items()} for g, leaves in variables.items()}
    flat = lambda t: {(g, n, s) for g, leaves in t.items() for n, s in leaves.items()}  # noqa: E731
    diff = sorted(flat(want) ^ flat(have))
    if diff:
        raise ValueError(f"the benchmark's variables differ from the program's model: {diff[:4]}")
