"""Model + dataset registries for the experiment entry points (port of
``fedml_tpu/experiments/registry.py``).

Every model name of the JAX registry is routed: ``lr``, ``rnn``,
``cnn``, ``resnet18_gn``, the CIFAR ResNets (``resnet20/32/44/56/110``),
``mobilenet``, ``mobilenet_v3``, ``efficientnet`` and ``vgg11`` …
``vgg19_bn``.  So is every dataset: ``mnist``, ``cifar10``,
``cifar100``, ``cinic10``, ``femnist``, ``fed_cifar100``,
``shakespeare``, ``fed_shakespeare``, ``stackoverflow_lr``,
``stackoverflow_nwp``, ``ILSVRC2012``/``imagenet`` and
``gld23k``/``gld160k`` (at 224 px) and ``synthetic``.
"""

from __future__ import annotations

from typing import Optional

from fedml_tpu_torch.core.types import FedDataset
from fedml_tpu_torch.models.base import ModelBundle
from fedml_tpu_torch.utils.device import DeviceLike


def load_data(
    dataset: str,
    data_dir: str = "",
    num_clients: int = 10,
    partition_method: str = "hetero",
    partition_alpha: float = 0.5,
    seed: int = 0,
) -> FedDataset:
    if dataset == "mnist":
        from fedml_tpu_torch.data.mnist import load_mnist

        return load_mnist(data_dir or "./data/mnist", num_clients,
                          partition="power_law", seed=seed)
    if dataset in ("cifar10", "cifar100", "cinic10"):
        from fedml_tpu_torch.data import cifar

        fn = {"cifar10": cifar.load_cifar10, "cifar100": cifar.load_cifar100,
              "cinic10": cifar.load_cinic10}[dataset]
        return fn(data_dir or f"./data/{dataset}", num_clients,
                  partition=partition_method, partition_alpha=partition_alpha,
                  seed=seed)
    if dataset == "femnist":
        from fedml_tpu_torch.data.emnist import load_femnist

        return load_femnist(data_dir or "./data/FederatedEMNIST/datasets",
                            num_clients, seed=seed)
    if dataset == "fed_cifar100":
        from fedml_tpu_torch.data.emnist import load_fed_cifar100

        return load_fed_cifar100(data_dir or "./data/fed_cifar100/datasets",
                                 seed=seed)
    if dataset == "shakespeare":
        from fedml_tpu_torch.data.shakespeare import load_shakespeare

        return load_shakespeare(data_dir or "./data/shakespeare",
                                num_clients, seed=seed)
    if dataset == "fed_shakespeare":
        from fedml_tpu_torch.data.shakespeare import load_fed_shakespeare

        return load_fed_shakespeare(data_dir or "./data/fed_shakespeare/datasets",
                                    num_clients, seed=seed)
    if dataset == "stackoverflow_lr":
        from fedml_tpu_torch.data.stackoverflow import load_stackoverflow_lr

        return load_stackoverflow_lr(data_dir or "./data/stackoverflow_lr",
                                     num_clients, seed=seed)
    if dataset == "stackoverflow_nwp":
        from fedml_tpu_torch.data.stackoverflow import load_stackoverflow_nwp

        return load_stackoverflow_nwp(data_dir or "./data/stackoverflow",
                                      num_clients, seed=seed)
    if dataset in ("ILSVRC2012", "imagenet"):
        from fedml_tpu_torch.data.imagenet import load_imagenet

        return load_imagenet(data_dir or "./data/ImageNet", num_clients, seed=seed)
    if dataset in ("gld23k", "gld160k"):
        from fedml_tpu_torch.data.imagenet import load_landmarks

        return load_landmarks(data_dir or "./data/gld", variant=dataset, seed=seed)
    if dataset == "synthetic":
        from fedml_tpu_torch.data.synthetic import synthetic_classification

        return synthetic_classification(
            num_clients=num_clients, partition=partition_method,
            partition_alpha=partition_alpha, seed=seed,
        )
    raise ValueError(f"unknown dataset: {dataset}")


def task_loss_for_dataset(dataset: str):
    """Per-dataset task loss: the multi-label BCE (exact match, precision,
    recall) for ``stackoverflow_lr``'s tag prediction, masked softmax
    cross-entropy for every other dataset."""
    from fedml_tpu_torch.core import losses

    if dataset == "stackoverflow_lr":
        return losses.masked_multilabel_bce
    return losses.masked_softmax_ce


def shrink_dataset(
    ds: FedDataset,
    max_samples_per_client: int = 0,
    max_test_samples: int = 0,
) -> FedDataset:
    """Deterministically cap per-client shard sizes and the test set
    (prefix of each client's shard; strided selection of the test set,
    since folder-tree loaders emit test arrays grouped by class)."""
    import dataclasses as _dc

    if not (max_samples_per_client or max_test_samples):
        return ds
    train_idx = ds.train_client_idx
    if max_samples_per_client:
        train_idx = {
            c: idx[:max_samples_per_client] for c, idx in train_idx.items()
        }
    test_x, test_y = ds.test_x, ds.test_y
    test_idx = ds.test_client_idx
    if max_test_samples and test_y is not None and \
            len(test_y) > max_test_samples:
        import numpy as _np

        keep = _np.linspace(0, len(test_y) - 1, max_test_samples,
                            dtype=_np.int64)
        test_x = test_x[keep]
        test_y = test_y[keep]
        if test_idx is not None:
            # remap kept global positions to their new compacted index
            pos = {int(g): i for i, g in enumerate(keep)}
            test_idx = {
                c: _np.asarray([pos[int(g)] for g in idx if int(g) in pos],
                               dtype=_np.int64)
                for c, idx in test_idx.items()
            }
    return _dc.replace(
        ds, train_client_idx=train_idx, test_x=test_x, test_y=test_y,
        test_client_idx=test_idx,
    )


def create_model(
    model: str, dataset: str, num_classes: int,
    image_size: Optional[int] = None,
    input_shape: Optional[tuple] = None,
    device: DeviceLike = None,
) -> ModelBundle:
    """The reference's (model, dataset) switch, in the JAX registry's
    order; the CIFAR ResNets are the library-conv baselines, as the JAX
    registry's XLA-conv ones."""
    img = image_size or (
        input_shape[0] if input_shape and len(input_shape) >= 2
        else (28 if dataset in ("mnist", "femnist") else 32)
    )
    if model == "lr" and dataset == "mnist":
        from fedml_tpu_torch.models.linear import logistic_regression

        return logistic_regression(28 * 28, num_classes, device=device)
    if model == "lr" and dataset == "stackoverflow_lr":
        from fedml_tpu_torch.models.linear import logistic_regression

        return logistic_regression(10000, num_classes, device=device)
    if model == "rnn" and dataset in ("shakespeare", "fed_shakespeare"):
        from fedml_tpu_torch.models.rnn import rnn_shakespeare

        return rnn_shakespeare(seq_output=(dataset == "fed_shakespeare"),
                               device=device)
    if model == "rnn" and dataset == "stackoverflow_nwp":
        from fedml_tpu_torch.models.rnn import rnn_stackoverflow

        return rnn_stackoverflow(device=device)
    if model == "cnn":
        from fedml_tpu_torch.models.cnn import cnn_dropout

        return cnn_dropout(only_digits=False, side=img, device=device)
    if model == "resnet18_gn":
        from fedml_tpu_torch.models.resnet_gn import resnet18_gn

        return resnet18_gn(num_classes=num_classes, image_size=img, device=device)
    if model in ("resnet56", "resnet110", "resnet20", "resnet32", "resnet44"):
        from fedml_tpu_torch.models import resnet

        return getattr(resnet, model)(num_classes=num_classes, image_size=img,
                                      device=device)
    if model == "mobilenet":
        from fedml_tpu_torch.models.mobilenet import mobilenet

        return mobilenet(num_classes=num_classes, image_size=img, device=device)
    if model == "mobilenet_v3":
        from fedml_tpu_torch.models.mobilenet_v3 import mobilenet_v3

        return mobilenet_v3(num_classes=num_classes, model_mode="LARGE",
                            image_size=img, device=device)
    if model == "efficientnet":
        from fedml_tpu_torch.models.efficientnet import efficientnet

        return efficientnet("efficientnet-b0", num_classes=num_classes,
                            image_size=img, device=device)
    if model.startswith("vgg"):
        from fedml_tpu_torch.models import vgg

        return getattr(vgg, model)(num_classes=num_classes, image_size=img,
                                   device=device)
    if model == "lr":
        # generic: LR flattens any input shape
        import numpy as np

        from fedml_tpu_torch.models.linear import logistic_regression

        dim = int(np.prod(input_shape)) if input_shape else 784
        return logistic_regression(dim, num_classes, device=device)
    raise ValueError(f"unknown model: {model} (dataset {dataset})")
