"""Toy-sized cells for the CPU: the cells of ``BENCHMARK.json`` with their
sizes cut so that a run takes seconds; every path a run takes is kept."""

import pytest

from benchmark import spec

TOY_SEED = 2 ** 31 + 77


def toy_cell(name: str, dtype: str = "fp32"):
    cell = spec.load_cell(name)
    cell.cfg["compute_dtype"] = dtype
    if cell.cfg["family"] == "resnet_cifar":
        # the whole depth at CIFAR's image size; few images
        cell.traffic.update(samples=96, clients=3, batch_size=16)
        cell.traffic["partition"]["min_size"] = 2
    else:
        cell.cfg.update(n_embd=64, n_head=4, n_layer=2, vocab_size=97, n_positions=32)
        cell.traffic.update(clients=3, sequences_per_client=4, seq_len=16, batch_size=2)
    return cell


@pytest.fixture
def toy():
    return toy_cell
