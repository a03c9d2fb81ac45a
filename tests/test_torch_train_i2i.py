"""The port's triplet trainer on BEV images against the JAX Trainer, at fp32
on the CPU, under the reference's pretrained freeze rules.

One train step from the same weights (JAX's seeded init with NetVLAD
initialised from images, carried across by ``flax_to_state_dict``) on
the same injected batch and triplets, with each framework's freeze mask:
VGG16 + NetVLAD-FC, then AlexNet, MobileNetV2 and ResNet18, all at the
``margin=10`` of JAX's zoo test. The loss within rtol 1e-4; every frozen
parameter bit-unchanged in both frameworks; per trainable tensor the
update Δ = new − old within max(1e-2, 2·floor) of ‖Δ_jax‖ and
elementwise within rtol 5e-3 + atol 2·floor_elem·max|Δ_jax| (the form of
tests/test_torch_train.py); the BatchNorm running statistics, the frozen
layers' included (train mode moves them in both), within rtol 1e-4 +
atol max(1e-4, 2·floor)·max|stat|.

Each floor is that tensor's own: JAX's change of it when it reruns the
same step in a way that changes only roundings (jax_floors): three draws
of one float32 step on every weight and input pixel, the queries and
negatives in reverse order (every batch sum in another order), and Flax's
BatchNorm with its two-pass variance in place of E[x²] − E[x]². The
last is what the port computes: Flax's default cancels in fp32 over
ResNet18's 2×2 layer4 maps, and the two-pass rerun moves JAX's layer3
and layer4 updates about as far as the port lies from JAX's. A
tensor whose floor reads 0.1 or more is left out by name (LEFT_OUT)
with its readings printed; every other bound stays under 0.2 of ‖Δ‖,
which a zero, sign-flipped or unchanged tensor fails. The masks equal
JAX's carried through the converter's names. Then the port of JAX's
epoch-and-eval test, and ``host_stats`` / ``augment_yaw`` ignored for
images, as in JAX. 64² images, the size of JAX's own i2i tests.
"""

import contextlib
import functools
import tempfile

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gloc3d_tpu.data.dataset import TripletDataset as JaxTripletDataset
from gloc3d_tpu.models import build_model as jax_build_model
from gloc3d_tpu.models.encoders import ENCODER_DIMS
from gloc3d_tpu.models.encoders import (
    encoder_trainable_mask as jax_encoder_mask,
)
from gloc3d_tpu.models.vgg import trainable_mask as jax_vgg_mask
from gloc3d_tpu.train import Trainer as JaxTrainer
from gloc3d_tpu.train.cluster import init_vlad_from_data as jax_init_vlad
from gloc3d_tpu_torch.config import PipelineConfig
from gloc3d_tpu_torch.convert import flax_to_state_dict
from gloc3d_tpu_torch.data.dataset import TripletDataset
from gloc3d_tpu_torch.models.descriptor import build_model
from gloc3d_tpu_torch.models.encoders import train_mask
from gloc3d_tpu_torch.models.vgg import trainable_mask
from gloc3d_tpu_torch.train import Trainer
from test_train_i2i import CFG as JAX_CFG
from test_train_i2i import _make_images
from test_torch_threads import _two_threads  # noqa: F401

ENCODERS = ("vgg16", "alexnet", "mobilenet", "resnet18")
N_DB, N_Q = 8, 4


def jax_cfg(encoder):
    dim = ENCODER_DIMS[encoder]
    # lr 0.1: Δ well above the fp32 spacing of the parameters; margin 10,
    # JAX's zoo test's: every negative violates (at JAX_CFG's 0.1 the VGG16
    # step's loss is 0 and only the weight decay moves the weights)
    train = JAX_CFG.train.replace(lr=0.1, margin=10.0)
    return JAX_CFG.replace(
        model=JAX_CFG.model.replace(encoder=encoder, encoder_dim=dim),
        index=JAX_CFG.index.replace(dim=dim), train=train)


def port_cfg(encoder, **train):
    c = PipelineConfig.from_json(jax_cfg(encoder).to_json())
    return c.replace(train=c.train.replace(**train)) if train else c


@functools.lru_cache(maxsize=None)
def images():
    return _make_images(N_DB, 2), _make_images(N_Q, 3)


def utm():
    db = np.array([((i % 4) * 60.0, (i // 4) * 60.0) for i in range(N_DB)])
    q = np.array([((i % 4) * 60.0 + 2, (i // 4) * 60.0 - 1)
                  for i in range(N_Q)])
    return db, q


def dataset(cls=TripletDataset):
    (db, q), (udb, uq) = images(), utm()
    return cls(db_inputs=db, q_inputs=q, utm_db=udb, utm_q=uq)


@functools.lru_cache(maxsize=None)
def jax_variables(encoder):
    """JAX's seeded init with NetVLAD initialised from images of the same
    sites with other pixel noise, and JAX's freeze mask over the whole
    tree, as cmd_train builds it. (Initialised from the batch's own
    images, k-means leaves singleton clusters whose centroid is a batch
    feature: the residual is then rounding noise that the intra
    normalisation blows up to unit length, and JAX's own loss moves by 2 %
    when the images are scaled by 1 + 1e-7.)"""
    cfg = jax_cfg(encoder)
    model = jax_build_model(cfg.model)
    db, _ = images()
    variables = jax.jit(model.init)(jax.random.PRNGKey(0),
                                    jnp.asarray(db[:1]))
    variables, _, _ = jax_init_vlad(cfg, model, variables,
                                    _make_images(N_DB, 9), None,
                                    jax.random.PRNGKey(1), num_images=8,
                                    per_image=16)
    mask = jax.tree.map(lambda _: True, dict(variables["params"]))
    mask["encoder"] = jax_encoder_mask(encoder,
                                       variables["params"]["encoder"])
    return model, variables, mask


def step_batch(cfg):
    """Queries 0-1, positives db 0-1, negatives db 2-5, one padded
    negative slot."""
    b, n_neg = cfg.train.batch_size, cfg.train.n_neg
    db, q = images()
    nv = np.ones((b, n_neg), np.float32)
    nv[1, -1] = 0.0
    return (q[:b], db[:b], db[b:b + b * n_neg], nv,
            np.ones(b, np.float32))


def one_ulp(a, seed):
    """``a`` with every element moved one float32 step up or down at
    random: one rounding's worth of change."""
    up = np.random.RandomState(seed).rand(*a.shape) < 0.5
    return np.where(up, np.nextafter(a, np.float32(np.inf)),
                    np.nextafter(a, np.float32(-np.inf))).astype(np.float32)


@contextlib.contextmanager
def two_pass_batchnorm():
    """Flax's BatchNorm with its two-pass variance (``use_fast_variance=
    False``) in place of E[x²] − E[x]²: the same statistic, summed another
    way, in every module traced inside the block."""
    real = fnn.BatchNorm

    class BatchNorm(real):
        use_fast_variance: bool = False

    fnn.BatchNorm = BatchNorm
    try:
        yield
    finally:
        fnn.BatchNorm = real


@functools.lru_cache(maxsize=None)
def jax_trainer(encoder, two_pass=False):
    """JAX's Trainer under its mask (its jitted step writes no file); with
    ``two_pass``, one whose step is traced under two_pass_batchnorm."""
    model, _, mask = jax_variables(encoder)
    with tempfile.TemporaryDirectory() as workdir:
        return JaxTrainer(jax_cfg(encoder), model,
                          dataset(JaxTripletDataset), workdir,
                          trainable_mask=mask)


def jax_step(encoder, perturb_seed=None, two_pass=False, reversed_=False):
    """One JAX step → (loss, old and new state as port state_dicts); with
    ``perturb_seed``, every weight and every input pixel moved by one
    float32 step first (one_ulp); with ``two_pass``, BatchNorm's variance
    summed in two passes; with ``reversed_``, the queries and each query's
    negatives in reverse order (the same loss, summed in another order)."""
    _, variables, _ = jax_variables(encoder)
    params = variables["params"]
    q, p, n, nv, qv = step_batch(jax_cfg(encoder))
    if reversed_:
        n = n.reshape(nv.shape + n.shape[1:])[::-1, ::-1].reshape(n.shape)
        q, p, nv, qv = q[::-1], p[::-1], nv[::-1, ::-1], qv[::-1]
        q, p, n, nv, qv = map(np.ascontiguousarray, (q, p, n, nv, qv))
    if perturb_seed is not None:
        leaves, tree = jax.tree.flatten(params)
        params = jax.tree.unflatten(tree, [
            one_ulp(np.asarray(a), 1000 * perturb_seed + i)
            for i, a in enumerate(leaves)])
        q, p, n = (one_ulp(a, 1000 * perturb_seed + 999 - i)
                   for i, a in enumerate((q, p, n)))
    stats = variables.get("batch_stats", {})
    tr = jax_trainer(encoder, two_pass)
    with two_pass_batchnorm() if two_pass else contextlib.nullcontext():
        new, loss = tr._train_step(
            tr.init_state(params, stats), jnp.asarray(q), None,
            jnp.asarray(p), None, jnp.asarray(n), None, jnp.asarray(nv),
            jnp.asarray(qv), jax.random.PRNGKey(7))
    return float(loss), *(flax_to_state_dict(
        {"params": a, "batch_stats": b}, encoder)
        for a, b in ((params, stats), (new.params, new.batch_stats)))


@functools.lru_cache(maxsize=None)
def jax_reference_step(encoder):
    """jax_step(encoder), kept for the module's tests."""
    return jax_step(encoder)


def _rel(a, b):
    return float(a.norm() / b.norm()), float(a.abs().max() / b.abs().max())


@functools.lru_cache(maxsize=None)
def jax_floors(encoder):
    """JAX's own fp32 floor of each tensor's checks: over its reruns of the
    step, the largest change of the tensor's update relative to ‖Δ‖
    (norm) and to max|Δ| (elementwise), and of each running statistic
    relative to its largest element. The reruns: three draws of one_ulp
    on every weight and input, the batch in reverse order, and, where the
    encoder has BatchNorm, the two-pass variance. → ({trainable name:
    (norm, elem)}, {statistic name: floor})."""
    _, old, want = jax_reference_step(encoder)
    cfg = port_cfg(encoder)
    mask = train_mask(build_model(cfg.model, cfg.voxel), encoder)
    stats = [k for k in want if "running" in k]
    reruns = [{"perturb_seed": seed} for seed in (1, 2, 3)]
    reruns.append({"reversed_": True})
    if stats:
        reruns.append({"two_pass": True})
    upd = {k: (0.0, 0.0) for k, t in mask.items() if t}
    stat = {k: 0.0 for k in stats}
    for kw in reruns:
        _, r_old, r_new = jax_step(encoder, **kw)
        for k, (nf, ef) in upd.items():
            d = want[k] - old[k]
            n, e = _rel(r_new[k] - r_old[k] - d, d)
            upd[k] = (max(nf, n), max(ef, e))
        for k in stats:
            stat[k] = max(stat[k], _rel(r_new[k] - want[k], want[k])[1])
    return upd, stat


def port_trainer(encoder, workdir, **train):
    cfg = port_cfg(encoder, **train)
    _, variables, _ = jax_variables(encoder)
    model = build_model(cfg.model, cfg.voxel)
    model.load_state_dict(flax_to_state_dict(variables, encoder))
    return Trainer(cfg, model, dataset(), workdir, device="cpu",
                   trainable_mask=train_mask(model, encoder))


def _is_stat(k):
    return "running" in k or "num_batches" in k


# The tensors whose own JAX floor reads 0.1 or more: JAX does not reproduce
# them itself, so they are left out by name, their readings printed.
# MobileNetV2's block16 projection BatchNorm bias feeds block17's expand
# conv and its train-mode BatchNorm, which removes any constant shift: its
# gradient is 0 up to rounding, and so is its update. The expand
# BatchNorms of blocks 2-17 take the batch mean of a projection output
# whose BatchNorm bias is 0, so their running means are rounding noise
# about 0.
LEFT_OUT = {"mobilenet": frozenset(
    ["encoder.16.conv.3.bias"]
    + [f"encoder.{i}.conv.0.1.running_mean" for i in range(2, 18)])}


@pytest.mark.parametrize("encoder", ENCODERS)
def test_i2i_train_step_matches_jax(tmp_path, encoder):
    want_loss, _, want = jax_reference_step(encoder)
    upd_floor, stat_floor = jax_floors(encoder)
    left_out = LEFT_OUT.get(encoder, frozenset())
    assert left_out <= set(upd_floor) | set(stat_floor)
    tr = port_trainer(encoder, str(tmp_path))
    old = {k: v.clone() for k, v in tr.model.state_dict().items()}
    mask = train_mask(tr.model, encoder)
    q, p, n, nv, qv = step_batch(port_cfg(encoder))
    loss = float(tr.train_step(q, None, p, None, n, None, nv, qv))
    new = tr.model.state_dict()
    np.testing.assert_allclose(loss, want_loss, rtol=1e-4)
    assert set(new) == set(want)
    frozen = [k for k, t in mask.items() if not t]
    assert frozen and all(torch.equal(new[k], old[k]) for k in frozen)
    assert all(torch.equal(want[k], old[k]) for k in frozen)
    assert set(upd_floor) == {k for k, t in mask.items() if t}
    for k, (norm_floor, elem_floor) in upd_floor.items():
        d_jax = want[k] - old[k]
        diff = new[k] - old[k] - d_jax
        assert d_jax.abs().max() > 0, k
        if k in left_out:
            print(f"{k} left out: JAX's own floor {norm_floor:.2e} of ‖Δ‖, "
                  f"the port {_rel(diff, d_jax)[0]:.2e}")
            continue
        assert norm_floor < 0.1, (k, norm_floor)
        assert (diff.norm() <= max(1e-2, 2 * norm_floor) * d_jax.norm()), k
        np.testing.assert_allclose(
            (new[k] - old[k]).numpy(), d_jax.numpy(), rtol=5e-3,
            atol=2 * elem_floor * float(d_jax.abs().max()), err_msg=k)
    assert bool(stat_floor) == (encoder in ("mobilenet", "resnet18"))
    for k, floor in stat_floor.items():
        assert not torch.equal(new[k], old[k]), k
        w = want[k]
        if k in left_out:
            print(f"{k} left out: JAX's own floor {floor:.2e} of max|stat|, "
                  f"the port {_rel(new[k] - w, w)[1]:.2e}")
            continue
        assert floor < 0.1, (k, floor)
        np.testing.assert_allclose(new[k].numpy(), w.numpy(), rtol=1e-4,
                                   atol=max(1e-4, 2 * floor)
                                   * float(w.abs().max()), err_msg=k)


def _carried(encoder, jax_tree):
    """A JAX boolean tree over params → {port name: bool}, through
    flax_to_state_dict (each leaf's flag as the value of its tensor)."""
    _, variables, _ = jax_variables(encoder)
    flags = {"params": jax.tree.map(
        lambda m, p: np.full(np.shape(p), float(m), np.float32),
        jax_tree, dict(variables["params"])),
        "batch_stats": variables.get("batch_stats", {})}
    sd = flax_to_state_dict(flags, encoder)
    return {k: bool(v.min() == 1.0) for k, v in sd.items() if not _is_stat(k)
            and v.numel() and bool((v == v.flatten()[0]).all())}


@pytest.mark.parametrize("encoder", ENCODERS)
def test_masks_equal_jax(encoder):
    _, variables, jax_mask = jax_variables(encoder)
    cfg = port_cfg(encoder)
    model = build_model(cfg.model, cfg.voxel)
    got = train_mask(model, encoder)
    want = _carried(encoder, jax_mask)
    assert set(got) == set(want) == {k for k, _ in model.named_parameters()}
    assert got == want
    n_train = sum(got.values())
    assert 0 < n_train < len(got)
    if encoder == "vgg16":  # models/vgg.py's rule over the whole tree
        whole = _carried(encoder, jax_vgg_mask(dict(variables["params"])))
        assert trainable_mask(model) == whole
        assert not any(v for k, v in whole.items() if k.startswith("pool."))
    assert train_mask(model, encoder, fromscratch=True) is None


def test_i2i_train_epoch_and_eval(tmp_path):
    """The port of JAX's test_i2i_train_epoch_and_eval (VGG16, 16 db and
    6 query images on a 4 × 4 grid of sites)."""
    n_db, n_q = 16, 6
    ds = TripletDataset(
        db_inputs=_make_images(n_db, 0), q_inputs=_make_images(n_q, 1),
        utm_db=np.array([((i % 4) * 60.0, (i // 4) * 60.0)
                         for i in range(n_db)]),
        utm_q=np.array([((i % 4) * 60.0 + 2, (i // 4) * 60.0 - 1)
                        for i in range(n_q)]))
    cfg = port_cfg("vgg16", lr=1e-3, host_stats=True, augment_yaw=True)
    _, variables, _ = jax_variables("vgg16")
    model = build_model(cfg.model, cfg.voxel)
    model.load_state_dict(flax_to_state_dict(variables, "vgg16"))
    tr = Trainer(cfg, model, ds, str(tmp_path), device="cpu",
                 trainable_mask=train_mask(model, "vgg16"))
    assert not tr.host_stats  # ignored for images, as in JAX
    loss = tr.train_epoch(1)
    assert np.isfinite(loss) and tr.step >= 1
    rec = tr.evaluate()
    assert 0.0 <= rec[1] <= 1.0


def test_host_stats_and_yaw_are_ignored_for_images(tmp_path):
    """An image step with a yaw given and host_stats set equals the plain
    step: the yaw and the host pass apply to clouds only."""
    losses = []
    for i, (kw, yaw) in enumerate((({}, None),
                                   ({"host_stats": True,
                                     "augment_yaw": True}, [0.5, -1.0]))):
        tr = port_trainer("alexnet", str(tmp_path / str(i)), **kw)
        q, p, n, nv, qv = step_batch(port_cfg("alexnet"))
        losses.append(float(tr.train_step(q, None, p, None, n, None, nv, qv,
                                          yaw=yaw)))
        assert not tr.host_stats
    assert losses[0] == losses[1]
