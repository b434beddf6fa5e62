"""Checkpoint/resume of the port (``fedml_tpu_torch/core/checkpoint.py``,
``FedAvgSimulation.attach_checkpointing/resume``, ``experiments/run.py``'s
``--checkpoint_every/--resume/--crash_at_round``), held to the JAX
package's semantics: atomic ``ckpt_<step>.npz`` writes, ``max_to_keep``
garbage collection, an unreadable latest checkpoint skipped, a template
of another structure or shape refused, and crash + resume equal to the
uninterrupted run bit for bit.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fedml_tpu_torch.algorithms.fedavg import (
    FedAvgConfig,
    FedAvgSimulation,
    InjectedCrash,
    ServerState,
)
from fedml_tpu_torch.core.checkpoint import CheckpointManager
from fedml_tpu_torch.core.rng import PRNGKey
from fedml_tpu_torch.data.augment import make_image_augment
from fedml_tpu_torch.data.synthetic import synthetic_classification
from fedml_tpu_torch.experiments import run
from fedml_tpu_torch.models.base import ModelBundle
from fedml_tpu_torch.models.resnet import Bottleneck, CifarResNet


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes at once, and the tiny tensors here gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HW = 8


def _state(seed=0, width=3):
    g = torch.Generator().manual_seed(seed)
    variables = {"params": {"a.kernel": torch.randn(2, width, generator=g),
                            "b.bias": torch.randn(width, generator=g)},
                 "batch_stats": {"c.mean": torch.randn(width, generator=g)}}
    opt = {"mu": torch.randn(width, generator=g).to(torch.bfloat16), "count": 3}
    return ServerState(variables, opt, 7, PRNGKey(seed))


def _assert_same(a, b):
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    else:
        assert a == b


def test_save_restore_round_trip(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert mgr.latest_step() is None
    state = _state(1)
    mgr.save(7, state)
    assert os.listdir(tmp_path / "ck") == ["ckpt_7.npz"]
    assert mgr.latest_step() == 7
    _assert_same(mgr.restore(like=_state(2)), state)   # bf16 leaf, key, ints


def test_max_to_keep_collects_old_steps(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in (1, 2, 3, 4):
        mgr.save(step, _state(step))
    assert sorted(os.listdir(tmp_path)) == ["ckpt_3.npz", "ckpt_4.npz"]
    _assert_same(mgr.restore(like=_state(0), step=3), _state(3))


def test_leftover_tmp_and_stray_files_are_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, _state(2))
    (tmp_path / "ckpt_5.npz.tmp").write_bytes(b"half a save")   # crash mid-save
    (tmp_path / "ckpt_old.npz").write_bytes(b"backup")
    assert mgr.latest_step() == 2
    _assert_same(mgr.restore(like=_state(0)), _state(2))


def test_corrupt_latest_checkpoint_is_skipped(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state(1))
    (tmp_path / "ckpt_2.npz").write_bytes(b"\x00garbage")
    _assert_same(mgr.restore(like=_state(0)), _state(1))
    with pytest.raises(Exception):
        mgr.restore(like=_state(0), step=2)   # an explicit step raises
    (tmp_path / "ckpt_1.npz").write_bytes(b"also garbage")
    with pytest.raises(FileNotFoundError, match="no readable checkpoint"):
        mgr.restore(like=_state(0))


def test_template_mismatch_is_refused(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state(1, width=3))
    with pytest.raises(ValueError, match="leaf shapes"):
        mgr.restore(like=_state(0, width=4))
    other = _state(0)._replace(opt_state=())
    with pytest.raises(ValueError, match="tree structure"):
        mgr.restore(like=other)


def _sim(cfg):
    ds = synthetic_classification(num_train=120, num_test=24, input_shape=(HW, HW, 3),
                                  num_clients=6, seed=4)
    bundle = ModelBundle(CifarResNet(Bottleneck, (1, 1, 1), 10), (HW, HW, 3),
                         torch.device("cpu"))
    return FedAvgSimulation(bundle, ds, cfg, device="cpu",
                            augment_fn=make_image_augment(pad=2, cutout=4))


def test_crash_then_resume_equals_the_uninterrupted_run(tmp_path):
    """Sampled cohorts (3 of 6), dropout 0.3, augmentation, momentum:
    checkpoint every round, crash right before round 2, resume a fresh
    simulation and finish.  Variables, key and history rows after the
    crash equal the uninterrupted run's bit for bit."""
    cfg = FedAvgConfig(num_clients=6, clients_per_round=3, comm_rounds=4,
                       batch_size=8, lr=0.05, momentum=0.9, weight_decay=1e-3,
                       frequency_of_the_test=2, seed=5, drop_prob=0.3)
    ref = _sim(cfg)
    ref.run()

    crashed = _sim(cfg)
    crashed.attach_checkpointing(CheckpointManager(str(tmp_path)), every=1)
    crashed.crash_at_round = 2
    with pytest.raises(InjectedCrash) as info:
        crashed.run()
    assert info.value.code == 137 and info.value.round_idx == 2
    assert sorted(os.listdir(tmp_path)) == ["ckpt_1.npz", "ckpt_2.npz"]

    resumed = _sim(cfg)
    resumed.attach_checkpointing(CheckpointManager(str(tmp_path)), every=1)
    assert resumed.resume() == 2
    rows = resumed.run(cfg.comm_rounds - 2)
    for coll in ref.state.variables:
        for k, v in ref.state.variables[coll].items():
            assert torch.equal(v, resumed.state.variables[coll][k]), k
    assert resumed.state.key.tobytes() == ref.state.key.tobytes()
    assert resumed.state.round_idx == ref.state.round_idx == 4
    for a, b in zip(ref.history[2:], rows):
        for k in ("round", "loss_sum", "correct", "participants", "test_acc"):
            assert a.get(k) == b.get(k), k
    assert sorted(os.listdir(tmp_path))[-1] == "ckpt_4.npz"


def _run_argv(ckdir, *extra):
    return ["--algorithm", "fedavg", "--dataset", "cifar10", "--ci", "1",
            "--comm_round", "2", "--client_num_in_total", "3", "--device", "cpu",
            "--checkpoint_dir", str(ckdir), *extra]


def test_run_py_crash_then_resume_reproduces_the_uninterrupted_run(tmp_path):
    """Through ``experiments/run.py`` with augmentation on (its default):
    checkpoint every round, crash before round 1, resume; the last
    checkpoint equals the uninterrupted run's byte for byte."""
    full = run.main(_run_argv(tmp_path / "full", "--checkpoint_every", "1",
                              "--run_dir", str(tmp_path / "r0")))
    with pytest.raises(InjectedCrash):
        run.main(_run_argv(tmp_path / "crash", "--checkpoint_every", "1",
                           "--crash_at_round", "1", "--run_dir", str(tmp_path / "r1")))
    assert sorted(os.listdir(tmp_path / "crash")) == ["ckpt_1.npz"]
    resumed = run.main(_run_argv(tmp_path / "crash", "--checkpoint_every", "1",
                                 "--resume", "1", "--run_dir", str(tmp_path / "r2")))
    assert resumed["resumed_rounds"] == 1 and len(resumed["history"]) == 1
    assert resumed["final"]["test_acc"] == full["final"]["test_acc"]
    za, zb = (np.load(tmp_path / d / "ckpt_2.npz") for d in ("full", "crash"))
    assert sorted(za.files) == sorted(zb.files)
    for k in za.files:
        assert za[k].tobytes() == zb[k].tobytes(), k


def test_run_py_crash_exits_137(tmp_path):
    """The injected crash ends the process with 137, as a SIGKILL would.
    The process runs on one torch thread, as this file's tests do: on a
    machine whose cores other test workers keep busy, a pool of a thread
    per core can take minutes where one thread takes seconds."""
    proc = subprocess.run(
        [sys.executable, "-m", "fedml_tpu_torch.experiments.run",
         *_run_argv(tmp_path / "ck", "--checkpoint_every", "1", "--crash_at_round", "1",
                    "--run_dir", str(tmp_path / "r"))],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 137, proc.stderr[-2000:]
    assert os.listdir(tmp_path / "ck") == ["ckpt_1.npz"]


@pytest.mark.parametrize("extra,match", [
    (["--resume", "1"], "no readable checkpoint"),
    (["--algorithm", "fedllm", "--dataset", "fed_shakespeare", "--resume", "1"],
     "no checkpoint wiring"),
], ids=["nothing_to_resume", "fedllm"])
def test_run_py_resume_refusals(tmp_path, extra, match):
    """An explicit resume that restores nothing fails instead of training
    from round 0; a driver without checkpoint wiring refuses before any
    work."""
    with pytest.raises(SystemExit, match=match):
        run.main(_run_argv(tmp_path / "empty", "--run_dir", str(tmp_path / "r"), *extra))
    assert not (tmp_path / "empty").exists() or not os.listdir(tmp_path / "empty")


def test_run_py_default_checkpoint_dir_is_stable_and_per_experiment(tmp_path, monkeypatch):
    """Without --checkpoint_dir: one directory under runs/ckpt/, the same for
    a run and its resume with more rounds, another for another lr."""
    monkeypatch.chdir(tmp_path)
    argv = ["--algorithm", "fedavg", "--dataset", "cifar10", "--ci", "1",
            "--client_num_in_total", "2", "--device", "cpu", "--checkpoint_every", "1"]
    run.main([*argv, "--comm_round", "1", "--run_dir", "r0"])
    dirs = os.listdir(tmp_path / "runs" / "ckpt")
    assert len(dirs) == 1 and dirs[0].startswith("fedavg-cifar10-seed0-")
    out = run.main([*argv, "--comm_round", "2", "--resume", "1", "--run_dir", "r1"])
    assert out["resumed_rounds"] == 1
    assert os.listdir(tmp_path / "runs" / "ckpt") == dirs
    run.main([*argv, "--comm_round", "1", "--lr", "0.01", "--run_dir", "r2"])
    assert len(os.listdir(tmp_path / "runs" / "ckpt")) == 2
