"""The port's spans (``fedml_tpu_torch/core/metrics.py``): host and device
clocks and counts per span in the round rows, the spans opened inside a
round (``core/client.py``, ``make_round_fn``, the attention backward), the
profiler capture's idle time by span, and the benchmark's readers of the
spans.  Imports no JAX; the CUDA case needs a card and skips without one:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_spans.py
"""

import json
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fedml_tpu_torch.algorithms.fedavg import FedAvgConfig, FedAvgSimulation
from fedml_tpu_torch.core import metrics as metricslib
from fedml_tpu_torch.core import rng as rnglib
from fedml_tpu_torch.core.client import make_client_optimizer, make_local_update
from fedml_tpu_torch.core.metrics import OUTSIDE, MetricsLogger, reduce_capture, span
from fedml_tpu_torch.data.augment import make_image_augment
from fedml_tpu_torch.data.synthetic import synthetic_classification
from fedml_tpu_torch.models.base import ModelBundle
from fedml_tpu_torch.models.resnet import Bottleneck, CifarResNet
from fedml_tpu_torch.models.transformer import transformer_lm
from fedml_tpu_torch.obs.telemetry import Telemetry

ROUND_SPANS = ("client", "shuffle", "augment", "step", "forward", "backward", "optimizer",
               "fold", "server_update", "readback", "round", "sample", "pack")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sim(device="cpu", clients=2, epochs=2, logger=None):
    """A ResNet-shaped FedAvg simulation, augmented, every client a round."""
    ds = synthetic_classification(num_train=40, num_test=8, input_shape=(8, 8, 3),
                                  num_clients=clients, partition="homo", seed=0)
    bundle = ModelBundle(CifarResNet(Bottleneck, (1, 1, 1), 10), (8, 8, 3),
                         torch.device(device))
    cfg = FedAvgConfig(num_clients=clients, clients_per_round=clients, comm_rounds=1,
                       epochs=epochs, batch_size=8, momentum=0.9, frequency_of_the_test=10)
    return FedAvgSimulation(bundle, ds, cfg, device=device,
                            metrics=logger or MetricsLogger(telemetry=Telemetry()),
                            augment_fn=make_image_augment(pad=2, flip=True, cutout=4))


def test_nested_spans_count_host_seconds_and_feed_histograms_outermost_only():
    lg = MetricsLogger(telemetry=Telemetry())
    for _ in range(2):
        with lg.span("outer"):
            with lg.activate(), span("inner", device=True):
                sum(range(1000))
    with span("inactive"):  # no active logger: nothing recorded
        pass
    out = lg.pop_spans()
    assert set(out) == {"time_outer", "time_inner", "calls_outer", "calls_inner"}
    assert out["time_outer"] >= out["time_inner"] > 0
    assert out["calls_outer"] == out["calls_inner"] == 2
    assert not any(k.startswith("device_") for k in out)  # the CPU has no device clock
    assert set(lg.telemetry.hists) == {"span.outer_s"}
    assert lg.telemetry.hists["span.outer_s"].count == 2
    assert lg.pop_spans() == {}


def test_spans_closed_from_other_threads_are_all_counted():
    """Autograd runs a CUDA backward on a thread of its own: the active
    logger is process-wide and its accumulators take a lock."""
    lg = MetricsLogger(telemetry=Telemetry())
    n_threads, per = 8, 500

    def work():
        for _ in range(per):
            with span("worker"):
                pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with lg.activate(), lg.span("main"):
            threads = [threading.Thread(target=work) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    out = lg.pop_spans()
    assert out["calls_worker"] == n_threads * per and out["calls_main"] == 1
    assert lg._open == [] and metricslib._ACTIVE is None


def test_round_row_carries_every_span_of_the_round():
    clients, epochs = 2, 2
    sim = _sim(clients=clients, epochs=epochs)
    row = sim.run(rounds=1)[-1]
    steps = sim.steps_per_epoch
    for name in ROUND_SPANS:
        assert row[f"time_{name}"] >= 0 and row[f"calls_{name}"] >= 1, name
    assert row["calls_step"] == row["calls_forward"] == row["calls_backward"] \
        == row["calls_optimizer"] == clients * steps * epochs
    assert row["calls_shuffle"] == row["calls_augment"] == clients * epochs
    assert row["calls_client"] == row["calls_fold"] == clients
    assert row["calls_server_update"] == row["calls_readback"] == row["calls_round"] == 1
    assert row["time_round"] >= row["time_client"] >= row["time_step"] \
        >= row["time_forward"] + row["time_backward"] + row["time_optimizer"]
    assert "calls_attn_bwd" not in row and not any(k.startswith("device_") for k in row)
    assert {k for k in sim.metrics.telemetry.hists if k.startswith("span.")} == {
        "span.sample_s", "span.pack_s", "span.round_s", "span.eval_s"}


def test_round_state_is_bit_identical_with_and_without_an_active_logger():
    sim = _sim(clients=2, epochs=1)
    x, y, mask, n = sim._cohort_block(np.arange(2), 0)
    args = (x, y, mask, n, torch.ones(2), np.arange(2))
    plain, _ = sim.round_fn(sim.state, *args)
    with sim.metrics.activate():
        spanned, _ = sim.round_fn(sim.state, *args)
    assert sim.metrics.pop_spans()["calls_step"] == 2 * sim.steps_per_epoch
    for group, leaves in plain.variables.items():
        for k, v in leaves.items():
            assert torch.equal(v, spanned.variables[group][k]), (group, k)


def test_transformer_backward_opens_one_attn_bwd_span_a_layer_a_step():
    layers, steps, B, L = 2, 3, 2, 16
    bundle = transformer_lm(vocab_size=32, embed_dim=16, num_heads=2, num_layers=layers,
                            seq_len=L, device="cpu")
    update = make_local_update(bundle, make_client_optimizer("sgd", 0.1), epochs=1)
    g = torch.Generator().manual_seed(0)
    x = torch.randint(0, 32, (steps, B, L), generator=g, dtype=torch.int32)
    y = torch.randint(0, 32, (steps, B, L), generator=g)
    lg = MetricsLogger(telemetry=Telemetry())
    with lg.activate():
        update(bundle.init(rnglib.PRNGKey(0)), x, y, torch.ones(steps, B), rnglib.PRNGKey(1))
    out = lg.pop_spans()
    assert out["calls_attn_bwd"] == layers * steps and out["calls_step"] == steps
    assert out["time_backward"] >= out["time_attn_bwd"] > 0


def test_capture_names_each_idle_gap_by_the_innermost_span():
    # ns: window 0-100; the device busy 10-20, 15-30 and 60-70
    device = [(10, 20), (15, 30), (60, 70), (95, 120)]
    spans = [(5, 90, "step"), (12, 50, "forward"), (55, 80, "backward"),
             (56, 58, "attn_bwd")]
    out = reduce_capture(device, spans, (0, 100), {"forward": "step", "backward": "step",
                                                  "attn_bwd": "backward", "step": None})
    assert out["window_s"] == pytest.approx(100e-9)
    assert out["busy_s"] == pytest.approx(35e-9)  # 10-30, 60-70 and 95-100
    idle = out["idle_by_span"]
    # gaps 0-10 (mid 5: step), 30-60 (mid 45: forward), 70-95 (mid 82: step)
    assert idle == pytest.approx({"step": 35e-9, "forward": 30e-9})
    assert sum(idle.values()) == pytest.approx(out["window_s"] - out["busy_s"])
    reduced = reduce_capture([], [(0, 10, "backward"), (2, 4, "attn_bwd")], (0, 20))
    assert reduced["idle_by_span"] == pytest.approx({"backward": 20e-9})
    assert reduce_capture([], [(0, 10, "step")], (0, 40))["idle_by_span"] == \
        pytest.approx({OUTSIDE: 40e-9})
    s = out["spans"]
    assert s["step"]["parent"] is None and s["attn_bwd"]["parent"] == "backward"
    assert s["step"]["self_s"] == pytest.approx((85 - 38 - 25) * 1e-9)
    assert s["backward"]["self_s"] == pytest.approx(23e-9)
    assert s["forward"]["calls"] == 1 and s["forward"]["total_s"] == pytest.approx(38e-9)


def test_profile_round_writes_a_trace_record(tmp_path):
    sim = _sim(clients=2, epochs=1, logger=MetricsLogger(str(tmp_path), telemetry=Telemetry()))
    sim.profile_round = 0
    with sim.metrics:
        sim.run(rounds=1)
    records = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    (rec,) = [r for r in records if r.get("kind") == "trace"]
    assert (tmp_path / "trace" / "trace.json").exists()
    assert rec["window_s"] > 0 and rec["busy_s"] == 0  # no device on the CPU
    assert sum(rec["idle_by_span"].values()) == pytest.approx(rec["window_s"])
    spans = rec["spans"]
    assert spans["step"]["calls"] == 2 * sim.steps_per_epoch
    assert spans["step"]["parent"] == "client" and spans["client"]["parent"] == "round"
    assert spans["forward"]["parent"] == "step" and spans["readback"]["parent"] == "round"
    row = [r for r in records if r.get("round") == 0 and "kind" not in r][0]
    assert row["calls_step"] == spans["step"]["calls"]
    assert rec["host_ops"] == "user_scopes"


def test_capture_falls_back_to_every_host_operator(tmp_path, monkeypatch):
    """Where this torch's profiler internals take other arguments, the
    capture records every host operator through ``torch.profiler`` and
    says so."""
    def drifted(*args, **kwargs):
        raise TypeError("incompatible constructor arguments")

    monkeypatch.setattr(torch._C._profiler, "ProfilerConfig", drifted)
    lg = MetricsLogger(str(tmp_path), telemetry=Telemetry())
    with metricslib.trace(logger=lg) as cap, lg.activate(), span("step"):
        with span("forward"):
            torch.randn(32, 32) @ torch.randn(32, 32)
    lg.close()
    assert cap.summary["host_ops"] == "all" and (tmp_path / "trace" / "trace.json").exists()
    assert cap.summary["spans"]["forward"]["parent"] == "step"
    assert sum(cap.summary["idle_by_span"].values()) == pytest.approx(cap.summary["window_s"])


def test_run_main_profile_round_logs_the_capture(tmp_path):
    from fedml_tpu_torch.experiments import run

    argv = ["--algorithm", "fedavg", "--dataset", "mnist", "--model", "lr", "--ci", "1",
            "--device", "cpu", "--comm_round", "2", "--run_dir", str(tmp_path)]
    run.main([*argv, "--profile_round", "1"])
    records = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    (rec,) = [r for r in records if r.get("kind") == "trace"]
    assert rec["trace_path"] == str(tmp_path / "trace" / "trace.json")
    assert rec["spans"]["round"]["calls"] == 1 and "step" in rec["spans"]
    rows = [r for r in records if "kind" not in r]
    assert [r["round"] for r in rows] == [0, 1] and rows[1]["calls_step"] >= 1
    with pytest.raises(ValueError, match="profile_round"):
        run.main(["--algorithm", "fedgkt", "--profile_round", "0", "--device", "cpu",
                  "--run_dir", str(tmp_path / "gkt")])


def test_trace_summary_cli_prints_device_clock_calls_and_idle_by_span(tmp_path):
    import subprocess

    rows = [{"round": r, "time_round": 2.0, "time_step": 1.5, "device_step": 1.25,
             "calls_step": 80} for r in range(2)]
    capture = {"kind": "trace", "trace_path": "t/trace.json", "window_s": 2.0,
               "busy_s": 1.5, "idle_by_span": {"step": 0.25, "readback": 0.25},
               "spans": {"step": {"parent": "client", "calls": 80, "total_s": 1.5,
                                  "self_s": 0.5}}}
    with open(tmp_path / "metrics.jsonl", "w") as fh:
        for rec in rows + [capture]:
            fh.write(json.dumps(rec) + "\n")
    cmd = [sys.executable, "-m", "fedml_tpu_torch.obs.trace_summary"]
    out = subprocess.run([*cmd, str(tmp_path)], capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    line = [ln for ln in out.stdout.splitlines() if ln.split()[:1] == ["step"]][0]
    assert line.split()[1:] == ["1.50s", "1.25s", "80"]  # host, device, calls
    line = [ln for ln in out.stdout.splitlines() if ln.split()[:1] == ["round"]][0]
    assert line.split()[1:] == ["2.00s", "-", "-"]
    assert "idle by span (t/trace.json): window 2.00s" in out.stdout
    assert "readback" in out.stdout and "12.5%" in out.stdout
    out = subprocess.run([*cmd, "--json", str(tmp_path)], capture_output=True, text=True,
                         timeout=60)
    s = json.loads(out.stdout)[str(tmp_path)]
    assert s["spans"]["step"] == {"host_s": 1.5, "device_s": 1.25, "calls": 80}
    assert s["traces"][0]["idle_by_span"]["step"] == 0.25
    missing = subprocess.run([*cmd, str(tmp_path / "none")], capture_output=True, text=True,
                             timeout=60)
    assert missing.returncode == 1


def _ctx(spans, steps_per_round):
    return SimpleNamespace(spans=spans, steps_per_round=steps_per_round)


@pytest.mark.parametrize("metric,key", [
    ("host_ms_per_step.resnet56", "time_step"), ("forward_host_ms.resnet56", "time_forward"),
    ("optimizer_host_ms.resnet56", "time_optimizer"), ("attn_bwd_ms.gpt2", "device_attn_bwd"),
    ("optimizer_device_ms.gpt2", "device_optimizer")])
def test_benchmark_span_readers(metric, key):
    from benchmark import spec

    read = spec.reader(metric)
    rounds = [{key: 0.8, "calls_step": 800, "time_round": 9.0},
              {key: 1.2, "calls_step": 800, "time_round": 9.0}]
    assert read(_ctx(rounds, 800)) == pytest.approx(1e3 * 2.0 / 1600)
    assert read(_ctx(rounds, 16)) is None  # the spans counted other steps
    assert read(_ctx([{"time_round": 9.0}], 800)) is None  # a program without the spans
    assert read(_ctx([], 800)) is None


@pytest.mark.gpu
def test_device_clock_spans_nest_inside_the_round():
    """On a card the optimizer's and the attention backward's spans carry
    the device clock, every other span the host clock alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the device clock is the card's")
    sim = _sim(device="cuda", clients=2, epochs=1)
    row = sim.run(rounds=1)[-1]
    assert {k for k in row if k.startswith("device_")} == {"device_optimizer"}
    assert 0 < row["device_optimizer"] <= row["time_round"]
    assert row["calls_optimizer"] == 2 * sim.steps_per_epoch
    layers, steps, B, L = 2, 3, 2, 16
    bundle = transformer_lm(vocab_size=32, embed_dim=16, num_heads=2, num_layers=layers,
                            seq_len=L, device="cuda")
    update = make_local_update(bundle, make_client_optimizer("sgd", 0.1), epochs=1)
    x = torch.randint(0, 32, (steps, B, L), dtype=torch.int32, device="cuda")
    y = torch.randint(0, 32, (steps, B, L), device="cuda")
    lg = MetricsLogger(telemetry=Telemetry())
    lg.use_device("cuda")
    with lg.activate(), lg.span("update"):
        update(bundle.init(rnglib.PRNGKey(0)), x, y, torch.ones(steps, B, device="cuda"),
               rnglib.PRNGKey(1))
        torch.cuda.synchronize()
    out = lg.pop_spans()
    assert {k for k in out if k.startswith("device_")} == {"device_attn_bwd",
                                                          "device_optimizer"}
    assert out["calls_attn_bwd"] == layers * steps
    assert 0 < out["device_attn_bwd"] + out["device_optimizer"] <= out["time_update"]
