"""The port's base-framework template (``fedml_tpu_torch/algorithms/
base_framework.py``, its message form over the in-process bus) held
against the JAX package's: ``run_base_framework`` equals JAX's exactly
for several worker counts and rounds (and the plain-Python series of
``tests/test_base_framework.py``), a custom local compute too; the
central worker collects and resets; the managers run over the bus by
hand; ``run.main --algorithm base_framework --device cpu`` runs, as does
the entry shim; the compiled form runs on a 1-rank mesh."""

import pytest

import fedml_tpu.algorithms.base_framework as jbf
from fedml_tpu_torch.algorithms import base_framework as bf
from fedml_tpu_torch.comm.inproc import InprocBus
from fedml_tpu_torch.experiments import run


def _series(num_workers, comm_rounds):
    g, out = 0.0, []
    for _ in range(comm_rounds):
        g = sum(0.5 * g / (i + 1) + (i + 1) * 0.01 for i in range(num_workers))
        out.append(g)
    return out


@pytest.mark.parametrize("workers,rounds", [(1, 1), (2, 3), (5, 4), (8, 4), (13, 7)])
def test_run_base_framework_is_jaxs_exactly(workers, rounds):
    got = bf.run_base_framework(workers, rounds)
    assert got == jbf.run_base_framework(workers, rounds) == _series(workers, rounds)


def test_custom_local_compute_is_jaxs():
    def compute(cid, r, g):
        return (cid + 1) * 0.1 + r - 0.25 * g

    assert bf.run_base_framework(4, 5, compute) == jbf.run_base_framework(4, 5, compute)


def test_run_base_framework_refuses_no_rounds():
    for mod in (bf, jbf):
        with pytest.raises(ValueError, match="comm_rounds"):
            mod.run_base_framework(3, 0)


def test_central_worker_collects_and_resets():
    w = bf.BaseCentralWorker(3)
    for i in range(3):
        assert not w.check_whether_all_receive()
        w.add_client_local_result(i, float(i))
    assert w.check_whether_all_receive()
    assert w.aggregate() == 3.0
    assert not w.check_whether_all_receive()
    assert bf.BaseClientWorker(2).compute(0, 1.0) == bf.default_local_compute(2, 0, 1.0)


def test_managers_over_the_bus_stop_every_node():
    bus = InprocBus()
    central = bf.BaseCentralManager(bus.register(bf.SERVER), bf.BaseCentralWorker(3), 2)
    clients = [bf.BaseClientManager(bus.register(i + 1), bf.BaseClientWorker(i))
               for i in range(3)]
    central.start()
    delivered = bus.drain()
    # 3 INITs, 2 rounds x 3 uploads, 3 broadcasts, 3 FINISHes
    assert delivered == 3 + 6 + 3 + 3
    assert central.history == _series(3, 2) and central.round_idx == 2
    assert all(bus.stopped[n] for n in range(4)) and len(clients) == 3


def test_compiled_form_waits_for_the_parallel_engines():
    """The compiled form runs (on 8 ranks against JAX's:
    test_torch_spmd_gossip.py); here on a 1-rank mesh in process, against
    JAX's compiled form on one device and the message form."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from fedml_tpu_torch.parallel.compat import single_rank_group
    from fedml_tpu_torch.parallel.spmd import make_1d_mesh

    with single_rank_group("cpu"):
        got = bf.make_compiled_round(make_1d_mesh(axis="clients", device="cpu"))(5, 4)
    want = jbf.make_compiled_round(Mesh(np.array(jax.devices()[:1]), ("clients",)))(5, 4)
    assert got.dtype == np.float32 and got.shape == (4,)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, bf.run_base_framework(5, 4), rtol=1e-6)


@pytest.mark.parametrize("argv,workers,rounds", [
    ([], 10, 10), (["--client_num_in_total", "5", "--comm_round", "4"], 5, 4),
    (["--ci", "1"], 3, 2)], ids=["defaults", "5x4", "ci"])
def test_run_main_base_framework_on_the_cpu(tmp_path, argv, workers, rounds):
    out = run.main(["--algorithm", "base_framework", *argv, "--device", "cpu",
                    "--run_dir", str(tmp_path)])
    assert out["history"] == _series(workers, rounds) and out["final"] == out["history"][-1]
    assert (tmp_path / "metrics.jsonl").exists()


def test_entry_shim_runs(tmp_path):
    import json
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, "-m", "fedml_tpu_torch.experiments.main_base_framework",
         "--device", "cpu", "--client_num_in_total", "2", "--comm_round", "2",
         "--run_dir", str(tmp_path)], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    final = json.loads(out.stdout.splitlines()[-1])["final"]
    assert final == _series(2, 2)[-1]


def test_run_main_base_framework_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run.main(["--algorithm", "base_framework", "--run_dir", str(tmp_path)])


def test_chip_smokes_series_is_the_templates():
    import chip_smoke

    assert chip_smoke._base_framework_series(5, 4) == _series(5, 4)
