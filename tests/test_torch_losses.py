"""The port's metric-learning losses against gloc3d_tpu/models/losses.py on
seeded inputs, values and gradients; rtol 1e-6 (the same fp32 formulas)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gloc3d_tpu.models import losses as jl
from gloc3d_tpu_torch.models import losses as tl
from test_torch_threads import _two_threads  # noqa: F401


B, P, N, D = 4, 3, 5, 16


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*s).astype(np.float32) * 0.3 for k, s in (
        ("q", (B, D)), ("pos", (B, D)), ("pos_set", (B, P, D)),
        ("negs", (B, N, D)), ("other", (B, D)))}


def _check(jax_fn, torch_fn, arrays, rtol=1e-6):
    """Value and gradient w.r.t. every array input."""
    want, want_grads = jax.value_and_grad(
        lambda xs: jax_fn(*xs))([jnp.asarray(a) for a in arrays])
    xs = [torch.from_numpy(a).requires_grad_() for a in arrays]
    got = torch_fn(*xs)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=rtol,
                               atol=1e-7)
    for x, g in zip(xs, want_grads):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), rtol=1e-5,
                                   atol=1e-6)


def test_triplet_margin_loss():
    a = _inputs()
    _check(lambda q, p, n: jl.triplet_margin_loss(q, p, n, 0.3),
           lambda q, p, n: tl.triplet_margin_loss(q, p, n, 0.3),
           [a["q"], a["pos"], a["negs"][:, 0]])


@pytest.mark.parametrize("mask_kind", ["mixed", "all_masked", "all_real"])
def test_training_triplet_loss(mask_kind):
    a = _inputs(1)
    mask = {"mixed": (np.random.RandomState(2).rand(B, N) > 0.4),
            "all_masked": np.zeros((B, N), bool),
            "all_real": np.ones((B, N), bool)}[mask_kind].astype(np.float32)
    m = float(np.sqrt(0.1))
    _check(lambda q, p, n: jl.training_triplet_loss(q, p, n,
                                                    jnp.asarray(mask), m),
           lambda q, p, n: tl.training_triplet_loss(q, p, n,
                                                    torch.from_numpy(mask), m),
           [a["q"], a["pos"], a["negs"]])
    if mask_kind == "all_masked":  # no real negative: zero, not NaN
        got = tl.training_triplet_loss(*(torch.from_numpy(a[k]) for k in (
            "q", "pos", "negs")), torch.from_numpy(mask), m)
        assert float(got) == 0.0


def test_best_pos_distance():
    a = _inputs(3)
    want = jl.best_pos_distance(jnp.asarray(a["q"]), jnp.asarray(a["pos_set"]))
    got = tl.best_pos_distance(torch.from_numpy(a["q"]),
                               torch.from_numpy(a["pos_set"]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


@pytest.mark.parametrize("use_min,lazy,ignore_zero", [
    (False, False, False), (True, False, False), (False, True, False),
    (False, False, True), (True, True, True)])
def test_batched_triplet_loss(use_min, lazy, ignore_zero):
    a = _inputs(4)
    kw = dict(use_min=use_min, lazy=lazy, ignore_zero_loss=ignore_zero)
    _check(lambda q, p, n: jl.batched_triplet_loss(q, p, n, 0.5, **kw),
           lambda q, p, n: tl.batched_triplet_loss(q, p, n, 0.5, **kw),
           [a["q"], a["pos_set"], a["negs"]])


@pytest.mark.parametrize("use_min,lazy,ignore_zero", [
    (False, False, False), (True, True, False), (False, False, True)])
def test_batched_quadruplet_loss(use_min, lazy, ignore_zero):
    a = _inputs(5)
    kw = dict(use_min=use_min, lazy=lazy, ignore_zero_loss=ignore_zero)
    _check(lambda q, p, n, o: jl.batched_quadruplet_loss(q, p, n, o, 0.5,
                                                         0.2, **kw),
           lambda q, p, n, o: tl.batched_quadruplet_loss(q, p, n, o, 0.5,
                                                         0.2, **kw),
           [a["q"], a["pos_set"], a["negs"], a["other"]])
