"""The port's masked losses (``fedml_tpu_torch/core/losses.py``) held
against the JAX package's on the same numpy inputs, within 1e-6 (relative
to each value's size): the BCE family, the multi-label BCE with its
exact-match / precision / recall sums, the distillation KL and the MSE,
each also under an all-pad mask.  ``eval_summary`` reports the
multi-label task's precision and recall as the JAX package does."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu.core.client as jclient
import fedml_tpu.core.losses as jlosses
from fedml_tpu_torch.core import losses
from fedml_tpu_torch.core.client import eval_summary

TOL = {"rtol": 1e-6, "atol": 1e-6}


def _inputs(kind: str, all_pad: bool, seed: int = 0):
    rng = np.random.RandomState(seed)
    B, C = 6, 9
    logits = (3 * rng.standard_normal((B, C))).astype(np.float32)
    logits[0, :3] = 0.0                               # exactly on the z > 0 edge
    if kind == "multilabel":
        y = (rng.rand(B, C) > 0.7).astype(np.float32)
        y[1] = (logits[1] > 0)                        # one exact match
        y[2] = 0.0                                    # no tags: recall's 1e-13
    elif kind == "bce":
        logits = logits[:, 0]
        y = (rng.rand(B) > 0.5).astype(np.float32)
    elif kind == "mse":                               # one regression target each
        logits = logits[:, :1]
        y = rng.standard_normal(B).astype(np.float32)
    else:                                             # kd: y is the teacher's logits
        y = (2 * rng.standard_normal((B, C))).astype(np.float32)
    mask = np.ones(B, np.float32)
    mask[-2:] = 0.0
    if all_pad:
        mask[:] = 0.0
    return logits, y, mask


def _close(got, want, name):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               err_msg=name, rtol=TOL["rtol"],
                               atol=TOL["atol"] * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("all_pad", [False, True], ids=["mask", "all_pad"])
@pytest.mark.parametrize("name,kind", [
    ("masked_bce_logits", "bce"),
    ("masked_multilabel_bce", "multilabel"),
    ("masked_mse", "mse"),
])
def test_loss_and_metrics_are_jaxs(name, kind, all_pad):
    logits, y, mask = _inputs(kind, all_pad)
    jloss, jaux = getattr(jlosses, name)(jnp.asarray(logits), jnp.asarray(y), jnp.asarray(mask))
    tloss, taux = getattr(losses, name)(torch.from_numpy(logits), torch.from_numpy(y),
                                        torch.from_numpy(mask))
    _close(tloss.item(), np.asarray(jloss), name)
    assert sorted(taux) == sorted(jaux)
    for k in jaux:
        _close(taux[k].item(), np.asarray(jaux[k]), f"{name}.{k}")
    if all_pad:
        assert tloss.item() == 0.0 and taux["count"].item() == 0.0


@pytest.mark.parametrize("all_pad", [False, True], ids=["mask", "all_pad"])
@pytest.mark.parametrize("temperature", [1.0, 3.0])
def test_kd_kl_is_jaxs(temperature, all_pad):
    s, t, mask = _inputs("kd", all_pad, seed=1)
    want = jlosses.masked_kd_kl(jnp.asarray(s), jnp.asarray(t), jnp.asarray(mask), temperature)
    got = losses.masked_kd_kl(torch.from_numpy(s), torch.from_numpy(t), torch.from_numpy(mask),
                              temperature)
    _close(got.item(), np.asarray(want), "masked_kd_kl")


def test_bce_elements_are_stable_and_jaxs():
    z = np.array([-200.0, -30.0, -1.0, 0.0, 1e-8, 2.5, 90.0], np.float32)
    for yv in (0.0, 1.0):
        y = np.full_like(z, yv)
        want = np.asarray(jlosses._bce_elements(jnp.asarray(z), jnp.asarray(y)))
        got = losses._bce_elements(torch.from_numpy(z), torch.from_numpy(y)).numpy()
        assert np.all(np.isfinite(got))
        _close(got, want, f"bce y={yv}")


def test_multilabel_gradient_is_jaxs():
    """Including JAX's gradient at the planted zero logits."""
    import jax

    logits, y, mask = _inputs("multilabel", False, seed=3)
    jg = jax.grad(lambda z: jlosses.masked_multilabel_bce(z, jnp.asarray(y),
                                                          jnp.asarray(mask))[0])(
        jnp.asarray(logits))
    z = torch.from_numpy(logits).requires_grad_(True)
    losses.masked_multilabel_bce(z, torch.from_numpy(y), torch.from_numpy(mask))[0].backward()
    _close(z.grad.numpy(), np.asarray(jg), "grad")
    assert np.all(z.grad.numpy()[-2:] == 0.0)          # padded samples get none


def test_eval_summary_reports_precision_and_recall():
    logits, y, mask = _inputs("multilabel", False, seed=2)
    _, jaux = jlosses.masked_multilabel_bce(jnp.asarray(logits), jnp.asarray(y),
                                            jnp.asarray(mask))
    _, taux = losses.masked_multilabel_bce(torch.from_numpy(logits), torch.from_numpy(y),
                                           torch.from_numpy(mask))
    want = jclient.eval_summary({k: np.asarray(v) for k, v in jaux.items()})
    got = eval_summary(taux)
    assert sorted(got) == sorted(want) == sorted(
        ["test_acc", "test_loss", "test_count", "test_precision", "test_recall"])
    for k in want:
        _close(got[k], want[k], k)
    # a single-label task's record has no precision/recall
    _, ce = losses.masked_softmax_ce(torch.from_numpy(logits), torch.zeros(6, dtype=torch.int64),
                                     torch.from_numpy(mask))
    assert "test_precision" not in eval_summary(ce)
