"""The port's bench workloads and CLI (``fedml_tpu_torch/bench.py``) at tiny
cuts on the CPU: ``build_north_star`` for both conv variants (the kernel
variant runs each conv's plain version on the CPU) and resnet_tpu's s2d and
padding variants, the metric line with the JAX bench's names, and the
refusals of the XLA loop-unroll knobs.  The JAX bench's data draws are the
port's."""

import json

import numpy as np
import pytest
import torch

from fedml_tpu_torch import bench


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs in several worker
    processes at once, and the tiny tensors here gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY = dict(clients=2, batch=2, steps=1, rounds_per_call=2, device="cpu")


@pytest.mark.parametrize("variant", ["kernel", "baseline"])
def test_build_north_star_runs_on_cpu(variant):
    round_fn, state, args, samples = bench.build_north_star(conv_variant=variant, **TINY)
    assert samples == 2 * 1 * 2 * 2
    x, y, mask, ns, part, ids = args
    assert x.shape == (2, 1, 2, 32, 32, 3) and y.dtype == torch.int32
    # the JAX bench's draws (numpy RandomState(0): images, then labels)
    rng = np.random.RandomState(0)
    assert np.array_equal(x.numpy(), rng.rand(2, 1, 2, 32, 32, 3).astype(np.float32))
    assert np.array_equal(y.numpy(), rng.randint(0, 10, (2, 1, 2)))
    assert ns.tolist() == [2.0, 2.0] and part.tolist() == [1.0, 1.0]
    before = {k: v.clone() for k, v in state.variables["params"].items()}
    state, m = round_fn(state, *args)
    assert state.round_idx == 2 and m["loss_sum"].shape == (2,)
    assert torch.isfinite(m["loss_sum"]).all()
    assert any(not torch.equal(v, state.variables["params"][k]) for k, v in before.items())


def test_north_star_variants_share_the_model():
    """Same seed, same variables and the same first round up to conv
    arithmetic (bf16 compute)."""
    (rk, sk, ak, _), (rb, sb, ab, _) = (
        bench.build_north_star(conv_variant=v, **{**TINY, "rounds_per_call": 1})
        for v in ("kernel", "baseline"))
    for k, v in sk.variables["params"].items():
        assert torch.equal(v, sb.variables["params"][k])
    _, mk = rk(sk, *ak)
    _, mb = rb(sb, *ab)
    assert torch.allclose(mk["loss_sum"], mb["loss_sum"], rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("variant", ["s2d1", "pad32"])
def test_tpu_variants_match_the_baseline_round(variant):
    """resnet_tpu's space-to-depth and lane-padding variants: the same
    variables, and one round within the kernel-against-baseline tolerance
    of the library baseline's (bf16 compute)."""
    (rv, sv, av, _), (rb, sb, ab, _) = (
        bench.build_north_star(conv_variant=v, **{**TINY, "rounds_per_call": 1})
        for v in (variant, "baseline"))
    for k, v in sv.variables["params"].items():
        assert torch.equal(v, sb.variables["params"][k])
    sv, mv = rv(sv, *av)
    _, mb = rb(sb, *ab)
    assert torch.isfinite(mv["loss_sum"]).all()
    assert torch.allclose(mv["loss_sum"], mb["loss_sum"], rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("variant,exc", [("pallas", ValueError)])
def test_build_north_star_refuses_other_variants(variant, exc):
    with pytest.raises(exc):
        bench.build_north_star(conv_variant=variant, **TINY)


def test_cli_north_star_prints_the_metric_line(capsys):
    out = bench.main(["--workload", "north_star", "--clients", "1", "--batch", "2",
                      "--steps", "1", "--rounds-per-call", "1", "--rounds", "1",
                      "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out
    assert line["metric"] == "fedavg_resnet56_cifar10_local_train_throughput"
    assert line["unit"] == "samples/sec" and line["value"] > 0
    assert line["vs_baseline"] == pytest.approx(line["value"] / 1500.0)
    assert line["device"] == "cpu"


def test_cli_fedllm_prints_the_metric_line(capsys):
    out = bench.main(["--workload", "fedllm", "--clients", "1", "--batch", "1",
                      "--steps", "1", "--rounds-per-call", "1", "--rounds", "1",
                      "--seq-len", "16", "--embed-dim", "16", "--num-layers", "1",
                      "--num-heads", "2", "--vocab", "32", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "fedllm_transformer_local_train_mfu"
    assert line["unit"] == "percent_of_h100_bf16_peak"
    assert line["detail"]["tokens_per_s"] > 0 and out["detail"]["config"]["vocab"] == 32


def test_cli_north_star_runs_an_s2d_variant(capsys):
    bench.main(["--workload", "north_star", "--conv-variant", "s2d1", "--clients", "1",
                "--batch", "2", "--steps", "1", "--rounds-per-call", "1", "--rounds", "1",
                "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "fedavg_resnet56_cifar10_local_train_throughput"
    assert line["value"] > 0 and line["device"] == "cpu"


@pytest.mark.parametrize("argv", [["--unroll", "4"], ["--client-unroll", "2"]],
                         ids=["unroll", "client_unroll"])
def test_cli_refuses_knobs_with_no_eager_counterpart(argv):
    with pytest.raises(NotImplementedError, match="XLA's while loop.*ROADMAP"):
        bench.main([*argv, "--clients", "1", "--batch", "2", "--steps", "1",
                    "--rounds-per-call", "1", "--rounds", "1", "--device", "cpu"])


def test_cli_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main(["--clients", "1", "--batch", "2", "--steps", "1",
                    "--rounds-per-call", "1", "--rounds", "1"])
