"""The port's runtime hooks (``fedml_tpu_torch/obs/torch_hooks.py``), the
counterpart of ``fedml_tpu/obs/jax_hooks.py``: new-signature tracking
(``calls.new_signature``, what ``jax.compiles`` counts, without a
compile), the device memory gauges (nothing on the CPU) and
``trace_rounds``; and their wiring into ``FedAvgSimulation``."""

import os

import numpy as np
import pytest
import torch

from fedml_tpu_torch.algorithms.fedavg import FedAvgConfig, FedAvgSimulation
from fedml_tpu_torch.core.metrics import MetricsLogger
from fedml_tpu_torch.data.synthetic import synthetic_classification
from fedml_tpu_torch.models.base import ModelBundle
from fedml_tpu_torch.models.resnet import Bottleneck, CifarResNet
from fedml_tpu_torch.obs.telemetry import Telemetry
from fedml_tpu_torch.obs.torch_hooks import (
    abstract_signature,
    instrument_signatures,
    record_device_memory,
    trace_rounds,
)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes at once, and the tiny tensors here gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_signature_keys_shapes_and_scalar_types_not_values():
    a = abstract_signature((torch.zeros(2, 3), 5, {"k": np.zeros(4)}))
    assert a == abstract_signature((torch.ones(2, 3), 9, {"k": np.ones(4)}))
    assert a != abstract_signature((torch.zeros(2, 4), 5, {"k": np.zeros(4)}))
    assert a != abstract_signature((torch.zeros(2, 3, dtype=torch.float64), 5,
                                    {"k": np.zeros(4)}))
    assert a != abstract_signature((torch.zeros(2, 3), 5.0, {"k": np.zeros(4)}))
    assert abstract_signature(([1, 2], {})) is not None
    assert abstract_signature((object.__new__(type("U", (), {"__hash__": None})),)) is None


def test_instrument_counts_each_new_signature_once():
    t = Telemetry()
    calls = []
    f = instrument_signatures(lambda x, r: calls.append(r) or x.sum(), "fn", telemetry=t)
    for r in range(3):
        f(torch.zeros(4), r)          # one signature: the int is a type
    f(torch.zeros(5), 0)              # a new shape
    assert calls == [0, 1, 2, 0]
    assert t.counters["calls.new_signature{fn=fn}"] == 2
    events = [e for e in t.drain_events() if e["kind"] == "new_signature"]
    assert [e["n_signatures"] for e in events] == [1, 2]


def test_device_memory_records_nothing_without_a_card():
    t = Telemetry()
    if torch.cuda.is_available():
        assert record_device_memory(t)
    else:
        assert record_device_memory(t) == {} and t.gauges == {}


def test_trace_rounds_writes_a_trace(tmp_path):
    t = Telemetry()
    state, times = trace_rounds(lambda s, x: (s + 1, {"m": x.sum()}), 0,
                                (torch.ones(3),), rounds=2, log_dir=str(tmp_path),
                                telemetry=t)
    assert state == 2 and len(times) == 2
    assert os.path.exists(tmp_path / "trace.json")
    assert [e["kind"] for e in t.drain_events()] == ["trace_rounds"]


def test_simulation_tracks_round_signatures():
    ds = synthetic_classification(num_train=48, num_test=16, input_shape=(8, 8, 3),
                                  num_clients=4, seed=0)
    bundle = ModelBundle(CifarResNet(Bottleneck, (1, 1, 1), 10), (8, 8, 3),
                         torch.device("cpu"))
    logger = MetricsLogger(telemetry=Telemetry())
    cfg = FedAvgConfig(num_clients=4, clients_per_round=2, comm_rounds=3,
                       batch_size=8, frequency_of_the_test=2)
    FedAvgSimulation(bundle, ds, cfg, device="cpu", metrics=logger).run()
    counters = logger.telemetry.counters
    # every sampled cohort packs to one geometry: one signature, three rounds
    assert counters["calls.new_signature{fn=round_fn}"] == 1
    assert counters["calls.new_signature{fn=evaluator}"] == 1
