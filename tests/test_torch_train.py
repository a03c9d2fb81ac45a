"""The port's triplet trainer against the JAX Trainer, at fp32 on the CPU.

One step on each train path (all-device: K2's plain version here, the XLA
scatter in JAX; host-stats: K1's plain version here, the Pallas cumsum in
interpret mode in JAX) from the same weights, batch, triplets and yaw:
the loss within rtol 1e-4 and the BatchNorm running statistics within rtol
1e-4 (the bounds tests/test_train_hoststats.py holds between the two JAX
paths), and per tensor the update Δ = new − old (not the parameters, whose
rounding would hide the step) within 1e-2 of ‖Δ_jax‖ and elementwise within
rtol 5e-3 + atol 2·floor·max|Δ_jax|. The floor is the reference's own:
the JAX package's two paths run the same step on the same batch, and
differ only in how they sum (XLA scatters against the Pallas
cumsum-difference segment sums), so ``jax_path_floor`` measures, in the
run, the worst tensor's largest elementwise difference of their updates
relative to that tensor's largest element (0.0548, on
encoder.block3.layers.6.weight, on one CPU; scaling the port's positives
by 1 + 1e-7 moves its update by 1.1e-2 of the largest element). The
elementwise bound is twice that floor, as chip_smoke.py holds the card to
twice the CPU's mkldnn-on-vs-off floor. The port's two paths both lie
within 2e-2 of JAX's all-device update there: the JAX host-stats update
is the one that stands off. Rounding decides some ReLUs near 0, and each
grid position's term is large against a weight gradient that BatchNorm's
mean subtraction has cancelled. A missing term, a wrong rate or a lost
gradient is an O(1) error. One more step with context gating holds its BatchNorm
over the batch of 10 descriptors to Flax's biased running variance.
"""

import functools
import tempfile

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gloc3d_tpu.models import build_model as jax_build_model
from gloc3d_tpu.train import Trainer as JaxTrainer
from gloc3d_tpu.train.cluster import init_vlad_from_data as jax_init_vlad
from gloc3d_tpu.train.trainer import draw_aug_yaw as jax_draw_yaw
from gloc3d_tpu.train.trainer import rotate_clouds_z as jax_rotate
from gloc3d_tpu_torch.convert import flax_to_state_dict
from gloc3d_tpu_torch.models.batchnorm import BatchNorm
from gloc3d_tpu_torch.models.descriptor import build_model
from gloc3d_tpu_torch.train import Trainer, init_vlad_from_data
from gloc3d_tpu_torch.train.trainer import draw_aug_yaw, rotate_clouds_z
from test_train import CFG as JAX_TRAIN_CFG
from test_train import _make_dataset
from test_torch_mining import _jax_seed_draws

CFG = JAX_TRAIN_CFG.replace(train=JAX_TRAIN_CFG.train.replace(
    augment_yaw=True))


def dataset(**kw):
    """test_train's clustered world with a padded tail on every scan (the
    unmasked PointNet BN must see the same rows on both paths)."""
    ds = _make_dataset(**kw)
    for a in (ds.db_masks, ds.q_masks, ds.db_inputs, ds.q_inputs):
        a[:, -32:] = 0.0
    return ds


@functools.lru_cache(maxsize=None)
def jax_seeded(model_cfg):
    model = jax_build_model(model_cfg, CFG.voxel)
    ds = dataset()
    return model, jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.asarray(ds.db_inputs[:1]),
        jnp.asarray(ds.db_masks[:1]))


@functools.lru_cache(maxsize=None)
def jax_variables(model_cfg):
    """The JAX model's seeded init with NetVLAD initialised from data: the
    seeded centroids make every descriptor nearly the same, and the
    triplet gradient, the direction of a ~1e-3 difference of two such
    descriptors, would then be rounding noise."""
    model, variables = jax_seeded(model_cfg)
    ds = dataset()
    variables, _, _ = jax_init_vlad(
        CFG.replace(model=model_cfg), model, variables, ds.db_inputs,
        ds.db_masks, jax.random.PRNGKey(3), num_images=8, per_image=50)
    return model, variables


def port_trainer(cfg, workdir, device="cpu", ds=None, **kw):
    """A port Trainer whose model holds the JAX model's initial weights."""
    _, variables = jax_variables(cfg.model)
    model = build_model(cfg.model, cfg.voxel)
    model.load_state_dict(flax_to_state_dict(variables))
    return Trainer(cfg, model, ds or dataset(), workdir, device=device, **kw)


def step_batch(cfg):
    """One fixed mined batch: queries, positives, negatives, a padded
    negative slot, and JAX's yaw draw (numpy) with its key."""
    b, n_neg = cfg.train.batch_size, cfg.train.n_neg
    ds = dataset()
    q_in, q_mk = ds.q_inputs[:b], ds.q_masks[:b]
    p_in, p_mk = ds.db_inputs[:b], ds.db_masks[:b]
    n_in = ds.db_inputs[b:b + b * n_neg]
    n_mk = ds.db_masks[b:b + b * n_neg]
    neg_valid = np.ones((b, n_neg), np.float32)
    neg_valid[1, -1] = 0.0
    key = jax.random.PRNGKey(7)
    yaw = np.asarray(jax_draw_yaw(key, b))
    return {
        "device": (q_in, q_mk, p_in, p_mk, n_in, n_mk), "key": key,
        "yaw": yaw, "neg_valid": neg_valid, "q_valid": np.ones(b, np.float32),
        # the host path rotates before the stats pass: one rotated input
        # for both frameworks, so both bin the same floats
        "cat_in": np.concatenate([jax_rotate(q_in, yaw, np), p_in, n_in]),
        "cat_mk": np.concatenate([q_mk, p_mk, n_mk]),
    }


@functools.lru_cache(maxsize=None)
def _jax_step(cfg):
    """One JAX step of ``cfg`` → (loss, the new state as a state_dict)."""
    model, variables = jax_variables(cfg.model)
    a = step_batch(cfg)
    nv, qv = jnp.asarray(a["neg_valid"]), jnp.asarray(a["q_valid"])
    with tempfile.TemporaryDirectory() as workdir:
        tr = JaxTrainer(cfg, model, dataset(), workdir)
        state = tr.init_state(variables["params"], variables["batch_stats"])
        if cfg.train.host_stats:
            p, vl, vs = tr._host_sorted(a["cat_in"], a["cat_mk"])
            new, loss = tr._train_step_hs(state, p, vl, vs, nv, qv)
        else:
            new, loss = tr._train_step(state, *map(jnp.asarray,
                                                   a["device"]),
                                       nv, qv, a["key"])
    return float(loss), flax_to_state_dict(
        {"params": new.params, "batch_stats": new.batch_stats})


def _step_cfg(host_stats, gating):
    # lr 0.1: a step well above the fp32 spacing of the parameters, so Δ
    # measures the update and not the rounding of new and old
    return CFG.replace(model=CFG.model.replace(gating=gating),
                       train=CFG.train.replace(host_stats=host_stats, lr=0.1))


@functools.lru_cache(maxsize=None)
def jax_path_floor():
    """The reference's own fp32 floor of the elementwise update check: the
    largest |Δ_host-stats − Δ_all-device| of the JAX package's two paths
    on one batch, relative to each tensor's largest |Δ_all-device|, worst
    tensor."""
    _, old = jax_variables(CFG.model)
    old = flax_to_state_dict(old)
    _, dev = _jax_step(_step_cfg(False, False))
    _, hs = _jax_step(_step_cfg(True, False))
    return max(float((hs[k] - dev[k]).abs().max()
                     / (dev[k] - old[k]).abs().max())
               for k in dev if "running" not in k and "num_b" not in k)


def _port_step(cfg, tr):
    a = step_batch(cfg)
    if cfg.train.host_stats:
        return float(tr.train_step_hs(
            *tr._host_sorted(a["cat_in"], a["cat_mk"]), a["neg_valid"],
            a["q_valid"]))
    return float(tr.train_step(*a["device"], a["neg_valid"], a["q_valid"],
                               yaw=a["yaw"]))


@pytest.mark.parametrize("host_stats,gating", [
    (False, False), (True, False), (False, True)])
def test_train_step_matches_jax(tmp_path, host_stats, gating):
    cfg = _step_cfg(host_stats, gating)
    want_loss, want = _jax_step(cfg)
    atol = 2.0 * jax_path_floor()  # of each tensor's largest |Δ_jax|
    tr = port_trainer(cfg, str(tmp_path / "port"))
    old = {k: v.clone() for k, v in tr.model.state_dict().items()}
    loss = _port_step(cfg, tr)
    new = tr.model.state_dict()

    np.testing.assert_allclose(loss, want_loss, rtol=1e-4)
    assert tr.step == 1
    params = dict(tr.model.named_parameters())
    assert set(params) | {k for k in new if "running" in k or "num_b" in k
                          } == set(want)
    for k in params:
        d_jax = (want[k] - old[k]).numpy()
        d_port = (new[k] - old[k]).numpy()
        assert np.abs(d_jax).max() > 0, k
        assert (np.linalg.norm(d_port - d_jax)
                <= 1e-2 * np.linalg.norm(d_jax)), k
        np.testing.assert_allclose(d_port, d_jax, rtol=5e-3,
                                   atol=atol * np.abs(d_jax).max(), err_msg=k)
    stats = [k for k in new if "running" in k]
    assert len(stats) == 2 * (14 + gating)  # 14 encoder BNs (+ gating)
    for k in stats:
        np.testing.assert_allclose(new[k].numpy(), want[k].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_batchnorm_keeps_flax_biased_running_variance():
    """Over a batch of 24 rows Flax's running variance and nn.BatchNorm1d's
    differ by 24/23; the port's BatchNorm keeps Flax's."""
    x = np.random.RandomState(0).randn(24, 16).astype(np.float32) * 3 + 1
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9)
    v = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    y, upd = bn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    port = BatchNorm(16).train()
    torch_bn = torch.nn.BatchNorm1d(16).train()
    got = port(torch.from_numpy(x))
    torch_bn(torch.from_numpy(x))
    want_var = np.asarray(upd["batch_stats"]["var"])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y),
                               atol=1e-5)
    np.testing.assert_allclose(port.running_var.numpy(), want_var, rtol=1e-5)
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-7)
    ratio = (torch_bn.running_var - 0.9) / (port.running_var - 0.9)
    np.testing.assert_allclose(ratio.numpy(), 24 / 23, rtol=1e-4)


def test_lr_follows_optax_schedule_over_optimizer_steps(tmp_path):
    """optax's staircase exponential_decay counts optimizer steps: a batch
    skipped by mining does not advance it (not a per-epoch StepLR)."""
    cfg = CFG.replace(train=CFG.train.replace(
        lr_step=1, lr_gamma=0.5, margin=100.0, augment_yaw=False))
    ds = dataset(n_db=16, n_q=4)
    ds.utm_q[2:] += 1000.0  # queries 2 and 3 have no positive
    tr = port_trainer(cfg, str(tmp_path), ds=ds)
    assert tr.transition_steps == 2  # lr_step × (4 queries // batch 2)
    sched = optax.exponential_decay(cfg.train.lr, 2, 0.5, staircase=True)
    cache_db = tr.compute_cache(ds.db_inputs, ds.db_masks)
    cache_q = tr.compute_cache(ds.q_inputs, ds.q_masks)
    used = []
    for batch in ([0, 1], [2, 3], [1, 0], [2, 3], [0, 1]):
        out = tr._train_batch(np.array(batch), cache_db, cache_q)
        assert (out is None) == (batch == [2, 3])
        if out is not None:
            used.append(tr.optimizer.param_groups[0]["lr"])
    assert tr.step == 3
    np.testing.assert_allclose(used, [float(sched(k)) for k in range(3)],
                               rtol=1e-6)
    np.testing.assert_allclose(tr.learning_rate(), float(sched(3)),
                               rtol=1e-6)
    assert used == [1e-3, 1e-3, 5e-4]  # a counted skip would give 5e-4 at 2


def test_fit_two_epochs_decreases_loss_and_checkpoints(tmp_path):
    cfg = CFG.replace(train=CFG.train.replace(epochs=2, augment_yaw=False))
    tr = port_trainer(cfg, str(tmp_path))
    tr.fit(log=lambda s: None)
    losses = [e["loss"] for e in tr.history]
    assert len(losses) == 2 and all(np.isfinite(losses)), losses
    assert losses[1] < losses[0], losses
    assert 0.0 <= tr.history[-1]["recall"][5] <= 1.0
    for name in ("ckpt_latest.pt", "ckpt_best.pt", "config.json",
                 "history.json"):
        assert (tmp_path / name).exists(), name


def test_checkpoint_roundtrip(tmp_path):
    tr = port_trainer(CFG, str(tmp_path))
    _port_step(CFG, tr)
    tr.save_checkpoint("latest")
    saved = {k: v.clone() for k, v in tr.model.state_dict().items()}
    momentum = {k: v["momentum_buffer"].clone()
                for k, v in tr.optimizer.state_dict()["state"].items()}
    _port_step(CFG, tr)
    tr.load_checkpoint("latest")
    assert tr.step == 1
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, saved[k]), k
    for k, v in tr.optimizer.state_dict()["state"].items():
        assert torch.equal(v["momentum_buffer"], momentum[k]), k


def test_adam_option_is_plain_adam(tmp_path):
    cfg = CFG.replace(train=CFG.train.replace(optimizer="adam", lr_step=1))
    tr = port_trainer(cfg, str(tmp_path))
    assert isinstance(tr.optimizer, torch.optim.Adam)
    assert tr.optimizer.param_groups[0]["weight_decay"] == 0
    assert np.isfinite(_port_step(cfg, tr))
    _port_step(cfg, tr)
    assert tr.learning_rate() == cfg.train.lr  # no schedule


def test_trainable_mask_freezes_parameters(tmp_path):
    frozen = "encoder.pn.pointnet.0.weight"
    tr = port_trainer(CFG, str(tmp_path), trainable_mask={frozen: False})
    old = {k: v.clone() for k, v in tr.model.state_dict().items()}
    _port_step(CFG, tr)
    new = tr.model.state_dict()
    assert torch.equal(new[frozen], old[frozen])
    assert not torch.equal(new["encoder.pn.pointnet.1.weight"],
                           old["encoder.pn.pointnet.1.weight"])


def test_mesh_and_folded_model_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="item 16"):
        port_trainer(CFG, str(tmp_path), mesh=object())
    cfg = CFG.replace(model=CFG.model.replace(fold_bn=True))
    with pytest.raises(ValueError, match="fold_bn=False"):
        Trainer(cfg, build_model(cfg.model, cfg.voxel), dataset(),
                str(tmp_path), device="cpu")


def test_host_sorted_requires_prefix_masks(tmp_path):
    cfg = CFG.replace(train=CFG.train.replace(host_stats=True))
    tr = port_trainer(cfg, str(tmp_path))
    ds = dataset()
    mk = ds.db_masks[:2].copy()
    mk[0, 3] = 0.0
    with pytest.raises(AssertionError, match="prefix-contiguous"):
        tr._host_sorted(ds.db_inputs[:2], mk)


def test_yaw_draw_and_rotation_match_jax():
    rng = np.random.RandomState(3)
    q = rng.randn(4, 64, 4).astype(np.float32)
    yaw = np.array(jax_draw_yaw(jax.random.PRNGKey(11), 4))
    got = rotate_clouds_z(torch.from_numpy(q), torch.from_numpy(yaw))
    np.testing.assert_allclose(got.numpy(), jax_rotate(q, yaw, np),
                               rtol=1e-6, atol=1e-6)
    draws = draw_aug_yaw(torch.Generator().manual_seed(0), 1000)
    assert draws.shape == (1000,) and float(draws.abs().max()) < np.pi
    assert float(draws.min()) < -3.0 and float(draws.max()) > 3.0


def test_init_vlad_from_data_matches_jax_with_replayed_draws():
    """Cluster mode + NetVLAD init: JAX's scan permutation, position and
    k-means++ draws replayed into the port; the sampled encoder
    descriptors, the 64 centroids and NetVLAD's parameters agree (fp32
    encoders in two frameworks: atol 1e-4 / rtol 1e-4)."""
    model, variables = jax_seeded(CFG.model)
    ds = dataset()
    key = jax.random.PRNGKey(3)
    num, per = 8, 50
    want_vars, want_c, want_d = jax_init_vlad(
        CFG, model, variables, ds.db_inputs, ds.db_masks, key,
        num_images=num, per_image=per)
    k, k_sel = jax.random.split(key)
    sel = np.asarray(jax.random.permutation(k_sel, ds.num_db))[:num]
    k, k_pos = jax.random.split(k)  # one batch of 8 scans
    gx, gy = CFG.voxel.grid_size[:2]
    positions = np.asarray(jax.random.randint(k_pos, (num, per), 0, gx * gy))
    seed_draws = _jax_seed_draws(jax.random.fold_in(key, 1), num * per,
                                 CFG.model.num_clusters)

    port = build_model(CFG.model, CFG.voxel)
    port.load_state_dict(flax_to_state_dict(variables))
    cents, descs = init_vlad_from_data(
        CFG, port, ds.db_inputs, ds.db_masks, num_images=num, per_image=per,
        draws=(sel, positions), seed_draws=seed_draws)
    np.testing.assert_allclose(descs.numpy(), want_d, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(cents.numpy(), want_c, rtol=1e-4, atol=1e-4)
    want = flax_to_state_dict(want_vars)
    for name in ("pool.centroids", "pool.conv.weight"):
        np.testing.assert_allclose(port.state_dict()[name].numpy(),
                                   want[name].numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=name)
