"""Gradients through the kernels' autograd Functions.

K1 (``segment_sum_sorted_grad``): value and gradient against ``jax.grad``
of the JAX custom VJP (Pallas in interpret mode on the CPU), the cases of
tests/test_train_hoststats.py; rtol 1e-5 (fp32 sums in another order; the
gradient itself is a row gather, exact). K2 (``scatter_mean_to_grid`` on
``pillar_bin_sums_grad``): gradient against ``jax.grad`` of the JAX XLA
scatter mean, with pillar 0 holding the padding rows. On a card: each
kernel's gradient against autograd through its plain version, and the
PointNet's gradient after a train step on each path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gloc3d_tpu.ops.pallas_scatter import segment_sum_sorted_grad as jax_ssg
from gloc3d_tpu.ops.voxelize import scatter_mean_to_grid as jax_mean
from gloc3d_tpu_torch.kernels import bin_sums as bs
from gloc3d_tpu_torch.kernels import segment_sum as ss
from gloc3d_tpu_torch.ops.voxelize import scatter_mean_to_grid

TOL = dict(rtol=1e-5, atol=1e-5)


def _sorted_ids(rng, b, n, v, p0_rows=0):
    ids = np.stack([np.sort(np.concatenate([
        np.zeros(p0_rows, np.int64), rng.randint(0, v, n - p0_rows)]))
        for _ in range(b)]).astype(np.int32)
    starts = np.stack([np.searchsorted(i, np.arange(v + 1), "left")
                       for i in ids]).astype(np.int32)
    return ids, starts


@pytest.mark.parametrize("batched,b,n,v,p0", [
    (False, 1, 512, 16, 0),     # test_segment_sum_grad_matches_xla
    (True, 3, 256, 8, 0),       # test_segment_sum_grad_vmapped
    (True, 2, 512, 24, 300),    # pillar 0 holding most rows (padding)
])
def test_k1_function_matches_jax_grad(batched, b, n, v, p0):
    rng = np.random.RandomState(n + v)
    ids, starts = _sorted_ids(rng, b, n, v, p0)
    vals = rng.randn(b, n, 64).astype(np.float32)
    w = rng.randn(b, v, 64).astype(np.float32)  # non-trivial cotangent
    if not batched:
        ids, starts, vals, w = ids[0], starts[0], vals[0], w[0]
        fn = jax_ssg
    else:
        fn = jax.vmap(jax_ssg)
    want, want_grad = jax.value_and_grad(
        lambda x: (fn(x, jnp.asarray(starts), jnp.asarray(ids)) * w).sum()
    )(jnp.asarray(vals))

    x = torch.from_numpy(vals).requires_grad_()
    out = ss.segment_sum_sorted_grad(x, torch.from_numpy(starts),
                                     torch.from_numpy(ids))
    assert out.grad_fn is not None
    calls = ss.segment_sum_sorted_grad.backward_calls
    loss = (out * torch.from_numpy(w)).sum()
    loss.backward()
    assert ss.segment_sum_sorted_grad.backward_calls == calls + 1
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), **TOL)
    # the backward is the exact row gather g[ids]
    np.testing.assert_array_equal(
        x.grad.numpy(), np.take_along_axis(w, ids[..., None], axis=-2))


@pytest.mark.parametrize("given_counts", [True, False])
def test_k2_mean_grad_matches_jax(given_counts):
    rng = np.random.RandomState(7)
    b, n, v, c = 2, 400, 30, 64
    ids = rng.randint(1, v, (b, n)).astype(np.int32)
    ids[:, -120:] = 0  # padding and out-of-grid rows alias to pillar 0
    ids[:, 5] = 0
    vals = rng.randn(b, n, c).astype(np.float32)
    w = rng.randn(b, v, c).astype(np.float32)
    counts = np.stack([np.bincount(i, minlength=v) for i in ids]
                      ).astype(np.float32) if given_counts else None
    want, want_grad = jax.value_and_grad(lambda x: (jax_mean(
        x, jnp.asarray(ids), v,
        counts=None if counts is None else jnp.asarray(counts)) * w).sum()
    )(jnp.asarray(vals))

    x = torch.from_numpy(vals).requires_grad_()
    out = scatter_mean_to_grid(
        x, torch.from_numpy(ids), v,
        counts=None if counts is None else torch.from_numpy(counts))
    assert out.grad_fn is not None
    calls = bs.pillar_bin_sums_grad.backward_calls
    loss = (out * torch.from_numpy(w)).sum()
    loss.backward()
    assert bs.pillar_bin_sums_grad.backward_calls == calls + 1
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), **TOL)


def test_k2_counts_carry_no_gradient():
    x = torch.randn(1, 6, 8, requires_grad=True)
    ids = torch.tensor([[0, 1, 1, 2, 0, 3]], dtype=torch.int32)
    sums, counts = bs.pillar_bin_sums_grad(x, ids, 4)
    assert sums.grad_fn is not None and not counts.requires_grad
    assert counts.tolist() == [[2.0, 2.0, 1.0, 1.0]]


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels, no CPU mode)")


@pytest.mark.cuda
def test_cuda_kernel_gradients_match_plain():
    _needs_card()
    dev = torch.device("cuda")
    rng = np.random.RandomState(3)
    b, n, v, c = 2, 40000, 2000, 64
    ids, starts = _sorted_ids(rng, b, n, v, p0_rows=20000)
    ids_d, starts_d = torch.from_numpy(ids).to(dev), torch.from_numpy(
        starts).to(dev)
    x = torch.randn((b, n, c), device=dev, requires_grad=True)
    w = torch.randn((b, v, c), device=dev)

    before = ss.segment_sum_sorted.launches
    out = ss.segment_sum_sorted_grad(x, starts_d, ids_d)
    assert ss.segment_sum_sorted.launches == before + 1
    assert out.grad_fn is not None
    (out * w).sum().backward()
    x2 = x.detach().clone().requires_grad_()
    (ss.segment_sum_sorted_plain(x2, starts_d) * w).sum().backward()
    torch.testing.assert_close(x.grad, x2.grad, rtol=0, atol=0)

    x.grad = None
    before = bs.pillar_bin_sums.launches
    perm = torch.randperm(n, device=dev)
    un_ids = ids_d[:, perm].contiguous()  # unsorted, as on the device path
    mean = scatter_mean_to_grid(x, un_ids, v)
    assert bs.pillar_bin_sums.launches == before + 1
    assert mean.grad_fn is not None
    (mean * w).sum().backward()
    x2 = x.detach().clone().requires_grad_()
    sums, cnt = bs.pillar_bin_sums_plain(x2, un_ids, v)
    ((sums / cnt.clamp_min(1.0)[..., None]) * w).sum().backward()
    torch.testing.assert_close(x.grad, x2.grad, rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("host_stats", [False, True])
def test_cuda_train_step_reaches_the_pointnet(tmp_path, host_stats):
    """One train step on the card: every encoder parameter, the PointNet's
    included, gets a nonzero gradient (a ctypes kernel without its autograd
    Function would stop the gradient at the pillar mean)."""
    _needs_card()
    from test_torch_train import CFG, port_trainer, step_batch

    cfg = CFG.replace(train=CFG.train.replace(host_stats=host_stats))
    tr = port_trainer(cfg, str(tmp_path), device="cuda")
    args = step_batch(cfg)
    if host_stats:
        tr.train_step_hs(*tr._host_sorted(args["cat_in"], args["cat_mk"]),
                         args["neg_valid"], args["q_valid"])
    else:
        tr.train_step(*args["device"], args["neg_valid"], args["q_valid"])
    for name, p in tr.model.named_parameters():
        if name.startswith("encoder."):
            assert p.grad is not None and float(p.grad.abs().max()) > 0, name
