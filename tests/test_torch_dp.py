"""The port's data parallelism (``Trainer(mesh=...)``,
``GlobalLocalizer.shard_extraction``, ``build-index --dp-devices``, the
multi-rank dry run) over a gloo group of two ranks on the CPU, against the
JAX package's on a 2-device mesh of the conftest's virtual CPU devices and
against the port's own one-process calls.

One group (two fresh processes running ``tests/_torch_dp_worker.py``,
which import neither JAX nor this conftest) runs the training and
extraction cases once for the whole file, while this process computes
JAX's side; each rank writes what it got, and the port's one-process calls
on the same weights and batches, half on each rank.

Bounds. An s2s train step is held as tests/test_torch_train.py holds the
one-process step: the loss within rtol 1e-4, the BatchNorm running
statistics within rtol 1e-4, and per tensor the update Δ = new − old
within 1e-2 of ‖Δ_jax‖ and elementwise within rtol 5e-3 + 2·floor·max|Δ|,
the floor being JAX's own (``s2s_floor``). The i2i step is held in the
form of tests/test_torch_train_i2i.py, with each tensor's own JAX floors
(``i2i_floors``). Each step is held both to JAX's step on the mesh and to
the port's one-process step, and the parameters after it are bit-equal on
the two ranks. Extraction: descriptors within atol / rtol 1e-5 of JAX's
sharded call, BEV images equal.
"""

import contextlib
import functools
import os
import socket
import subprocess
import sys
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import test_torch_train_i2i as ti
from gloc3d_tpu.cli import main as jax_main
from gloc3d_tpu.data.dataset import TripletDataset as JaxTripletDataset
from gloc3d_tpu.pipeline import GlobalLocalizer as JaxLocalizer
from gloc3d_tpu.train import Trainer as JaxTrainer
from gloc3d_tpu_torch.config import GroundConfig, PipelineConfig
from gloc3d_tpu_torch.convert import flax_to_state_dict
from gloc3d_tpu_torch.models.batchnorm import BatchNorm
from gloc3d_tpu_torch.parallel.dryrun import dryrun_multichip
from test_pipeline_ground import tilted_scan
from test_torch_cli import ckpt, port, run as run_cli  # noqa: F401
from test_torch_threads import _two_threads  # noqa: F401
from test_torch_train import CFG as TRAIN_CFG
from test_torch_train import _jax_step as _jax_train_step
from test_torch_train import (
    _step_cfg, dataset, jax_variables, step_batch,
)
from test_cli import N_PTS as CLI_PTS
from test_cli import kitti_root  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_dp_worker.py")
WORLD = 2
SEED = 3
STEPS = ("device", "hoststats", "trap", "i2i")
EPOCHS = ("epoch", "epoch_hs")  # all-device, host stats
ENCODER = "resnet18"   # the i2i case: an encoder of the zoo with BatchNorm
LIFT_M = 5.0           # the trap: rank 1's clouds lifted in z


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def step_cfg(key):
    cfg = _step_cfg(key == "hoststats", False)
    return cfg.replace(train=cfg.train.replace(seed=SEED))


def epoch_cfg(key):
    """The epoch's: test_torch_train's at a rate of 1e-5, on the
    all-device path or (``epoch_hs``) the host-stats one. A step's update
    is chaotic in fp32 at ~1e-2 of its largest element
    (test_torch_train.py; JAX's own computations of one step differ by
    5 %), so at its rate of 1e-3 the later steps' losses of two equal
    epochs already differ by ~1e-4; at 1e-5 by ~1e-6, and a wrong
    normaliser or BatchNorm still moves the first step's loss by 1e-2 or
    more (the trap case)."""
    return TRAIN_CFG.replace(train=TRAIN_CFG.train.replace(
        seed=SEED, lr=1e-5, host_stats=key == "epoch_hs"))


def trap_batch(a):
    """test_torch_train's batch with the halves made unlike: rank 1's query,
    positive and negatives (query 1's) lifted LIFT_M in z on their valid
    rows, and two of query 1's three negatives padding, so the ranks hold 3
    and 1 real negatives."""
    q, qm, p, pm, n, nm = (x.copy() for x in a["device"])
    n_neg = len(n) // len(q)
    for x, m, rows in ((q, qm, [1]), (p, pm, [1]),
                       (n, nm, range(n_neg, 2 * n_neg))):
        x[rows, :, 2] += LIFT_M * m[rows]
    nv = np.ones_like(a["neg_valid"])
    nv[1, 1:] = 0.0
    return (q, qm, p, pm, n, nm), nv


def step_inputs():
    """Each step case's batch: all-device, host stats (the queries rotated
    by JAX's yaw ahead, so that both frameworks bin the same floats, and
    no yaw: the port's train_step bins each rank's rows on the host, JAX
    bins the whole batch), the trap, and the i2i images."""
    out = {}
    a = step_batch(step_cfg("device"))
    names = ("q", "qm", "p", "pm", "n", "nm")
    out.update({f"device_{k}": v for k, v in zip(names, a["device"])})
    out.update(device_nv=a["neg_valid"], device_qv=a["q_valid"],
               device_yaw=a["yaw"])
    b = len(a["neg_valid"])
    for k, x in (("q", "cat_in"), ("qm", "cat_mk")):
        out[f"hoststats_{k}"] = a[x][:b]
    for k, x in zip(names[2:], a["device"][2:]):
        out[f"hoststats_{k}"] = x
    out.update(hoststats_cat=a["cat_in"], hoststats_catm=a["cat_mk"],
               hoststats_nv=a["neg_valid"], hoststats_qv=a["q_valid"])
    arrays, nv = trap_batch(a)
    out.update({f"trap_{k}": v for k, v in zip(names, arrays)})
    out.update(trap_nv=nv, trap_qv=a["q_valid"], trap_yaw=a["yaw"])
    q, p, n, nv, qv = ti.step_batch(ti.jax_cfg(ENCODER))
    out.update(i2i_q=q, i2i_p=p, i2i_n=n, i2i_nv=nv, i2i_qv=qv)
    return out, a["key"]


def extract_inputs():
    """Four training scans (a batch of 3 does not divide), four i2i
    images with origins, and four tilted walled scans for the aligned
    path at a small RANSAC."""
    ds = dataset()
    out = {"x_pts": ds.db_inputs[:4], "x_mask": ds.db_masks[:4],
           "xi_images": ti.images()[0][:4],
           "xi_origins": np.arange(8, dtype=np.float32).reshape(4, 2)}
    scans = [tilted_scan(x, y, yaw, roll, pitch, n=1024, seed=i)
             for i, (x, y, yaw, roll, pitch) in enumerate(
                 ((0, 0, 0.0, 0.02, -0.01), (5, 2, 0.4, -0.015, 0.02),
                  (-7, 3, -1.0, 0.01, 0.015), (12, -4, 2.0, -0.02, 0.0)))]
    out["xa_pts"] = np.stack([s[0] for s in scans])
    out["xa_mask"] = np.stack([s[1] for s in scans])
    return out


def aligned_cfg():
    cfg = PipelineConfig.from_json(step_cfg("device").to_json())
    return cfg.replace(
        bev=cfg.bev.replace(max_points=1024),
        voxel=cfg.voxel.replace(max_points=1024),
        ground=GroundConfig(num_candidates=512, ransac_iters=64))


def _inputs():
    """Everything the ranks read: configs, datasets, batches, and the
    weights (JAX's, bridged) as .pt files beside the inputs."""
    inp, key = step_inputs()
    for k in STEPS:
        inp[f"{k}_cfg"] = np.array(
            ti.port_cfg(ENCODER).to_json() if k == "i2i"
            else step_cfg(k).to_json())
    for k in EPOCHS:
        inp[f"{k}_cfg"] = np.array(epoch_cfg(k).to_json())
    ds, ids = dataset(), ti.dataset()
    for prefix, d in (("s2s", ds), ("i2i", ids)):
        for name in ("db_inputs", "q_inputs", "utm_db", "utm_q", "db_masks",
                     "q_masks"):
            if getattr(d, name, None) is not None:
                inp[f"{prefix}_{name}"] = getattr(d, name)
    inp["seed"] = np.array(SEED)
    inp.update(extract_inputs())
    inp["x_cfg"] = np.array(step_cfg("device").to_json())
    inp["xi_cfg"] = inp["i2i_cfg"]
    inp["xa_cfg"] = np.array(aligned_cfg().to_json())
    return inp, key


@functools.lru_cache(maxsize=None)
def weights():
    """The s2s and i2i models' JAX variables as port state dicts."""
    _, s2s = jax_variables(step_cfg("device").model)
    _, i2i, _ = ti.jax_variables(ENCODER)
    return flax_to_state_dict(s2s), flax_to_state_dict(i2i, ENCODER)


@functools.lru_cache(maxsize=None)
def jax_trainer(key, mesh):
    """JAX's Trainer on ``mesh`` for a case (the trap's is the all-device
    one: one jit for both), its model, variables and freeze mask."""
    if key == "i2i":
        model, variables, mask = ti.jax_variables(ENCODER)
        cfg, ds = ti.jax_cfg(ENCODER), ti.dataset(JaxTripletDataset)
    else:
        cfg = step_cfg(key)
        model, variables = jax_variables(cfg.model)
        mask, ds = None, dataset()
    with tempfile.TemporaryDirectory() as workdir:
        tr = JaxTrainer(cfg, model, ds, workdir, mesh=mesh,
                        trainable_mask=mask)
    return tr, variables


def _jax_step(key, inp, mesh, aug_key):
    """JAX's Trainer(mesh=...) step on the case's batch → (loss, the new
    state as a state dict). The i2i step is traced with Flax's two-pass
    BatchNorm variance (``use_fast_variance=False``), the statistic the
    port computes: Flax's default E[x²] − E[x]² cancels in fp32 over
    ResNet18's small maps and moves JAX's own update by 2-3 %
    (tests/test_torch_train_i2i.py)."""
    tr, variables = jax_trainer("device" if key == "trap" else key, mesh)
    nv, qv = (jnp.asarray(inp[f"{key}_{k}"]) for k in ("nv", "qv"))
    state = tr.init_state(variables["params"],
                          variables.get("batch_stats", {}))
    if key == "hoststats":
        p, vl, vs = tr._host_sorted(inp["hoststats_cat"],
                                    inp["hoststats_catm"])
        new, loss = tr._train_step_hs(state, p, vl, vs, nv, qv)
    else:
        arrays = [inp.get(f"{key}_{k}") for k in ("q", "qm", "p", "pm", "n",
                                                  "nm")]
        with (ti.two_pass_batchnorm() if key == "i2i"
              else contextlib.nullcontext()):
            new, loss = tr._train_step(
                state, *(None if a is None else jnp.asarray(a)
                         for a in arrays), nv, qv, aug_key)
    return float(loss), flax_to_state_dict(
        {"params": new.params, "batch_stats": new.batch_stats},
        ENCODER if key == "i2i" else "pointpillar")


def _jax_extract(inp, mesh):
    """JAX's sharded extraction of the same inputs on both s2s paths, and
    its image extraction (which it does not shard: the global result)."""
    want = {}
    model, variables = jax_variables(step_cfg("device").model)
    cfg = step_cfg("device")
    for key, host_stats in (("x_device", False), ("x_hoststats", True)):
        loc = JaxLocalizer(cfg, model, variables, host_stats=host_stats)
        loc.shard_extraction(mesh)
        d, bev, _ = loc.extract(inp["x_pts"], inp["x_mask"])
        want[key] = (np.asarray(d), np.asarray(bev.image),
                     np.asarray(bev.origin_xy))
    model, variables, _ = ti.jax_variables(ENCODER)
    loc = JaxLocalizer(ti.jax_cfg(ENCODER), model, variables)
    loc.shard_extraction(mesh)
    d, bev, _ = loc.extract(inp["xi_images"], origins=inp["xi_origins"])
    want["x_i2i"] = (np.asarray(d), np.asarray(bev.image),
                     np.asarray(bev.origin_xy))
    return want


@pytest.fixture(scope="module")
def run(tmp_path_factory, devices):
    """Start the two ranks, compute JAX's side meanwhile, and return (both
    ranks' results, JAX's, the inputs, the run's directory)."""
    out = tmp_path_factory.mktemp("dp")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    port_no = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(WORLD), str(port_no), str(out)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]
    try:
        # the ranks import torch and join their group meanwhile
        inp, aug_key = _inputs()
        s2s, i2i = weights()
        for name, state in (("s2s", s2s), ("i2i", i2i), ("x", s2s)):
            torch.save(state, out / f"{name}.pt")
        np.savez(out / "inputs.tmp.npz", **inp)
        os.replace(out / "inputs.tmp.npz", out / "inputs.npz")
        mesh = Mesh(np.array(devices[:WORLD]), ("data",))
        want = {key: _jax_step(key, inp, mesh, aug_key) for key in STEPS}
        want["s2s_floor"] = s2s_floor(want)
        want["i2i_floors"] = i2i_floors(want)
        want.update(_jax_extract(inp, mesh))
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    got = [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]
    return got, want, inp, out


def _ranks(run, key):
    """``key`` from both ranks, which must agree bit for bit."""
    got = run[0]
    np.testing.assert_array_equal(got[0][key], got[1][key], err_msg=key)
    return got[0][key]


def _state(run, prefix, rank=None):
    """A state dict the ranks wrote under ``prefix``: both ranks' (equal),
    or one rank's."""
    got = run[0][0 if rank is None else rank]
    names = [k[len(prefix) + 1:] for k in got if k.startswith(prefix + "/")]
    return {k: torch.from_numpy(got[f"{prefix}/{k}"] if rank is not None
                                else _ranks(run, f"{prefix}/{k}"))
            for k in names}


def _one_process_rank(run, key):
    """The rank that ran the port's one-process call of ``key``."""
    return next(r for r, g in enumerate(run[0]) if f"one_{key}_loss" in g)


def _rel(a, b):
    """‖a‖ / ‖b‖ and max|a| / max|b|."""
    return float(a.norm() / b.norm()), float(a.abs().max() / b.abs().max())


def s2s_floor(want):
    """JAX's own floor of the s2s elementwise update check: the largest
    difference of two of its computations of the step here, relative to
    the tensor's largest update, worst tensor: its host-stats path against
    its all-device path on the mesh (test_torch_train.py's
    ``jax_path_floor`` takes them unsharded), and its all-device step on
    the mesh against the same step unsharded (``_jax_step``). On one CPU
    they read 0.025 and 0.055: the mesh moves JAX's own update as far as
    the other path does on other batches."""
    s2s, _ = weights()
    dev, hs = want["device"][1], want["hoststats"][1]
    unsharded = _jax_train_step(_step_cfg(False, False))[1]
    return max(_rel(a[k] - b[k], b[k] - s2s[k])[1]
               for a, b in ((hs, dev), (unsharded, dev)) for k in s2s
               if "running" not in k and "num_b" not in k)


def i2i_floors(want):
    """JAX's own floors of the i2i checks, per tensor, in the form of
    tests/test_torch_train_i2i.py's: JAX's rerun of the step, unsharded,
    with the two-pass variance and the batch in reverse order, against its
    step on the mesh: the difference of the updates relative to ‖Δ‖ and
    to max|Δ|, and of each running statistic relative to its largest
    element. Of test_torch_train_i2i.py's reruns this one sets every
    tensor's floor here: with the step itself and three draws of one
    float32 step on every weight and input pixel added, no floor that the
    port's step needs moved (checked on one CPU)."""
    meshed = want["i2i"][1]
    _, old, rerun = ti.jax_step(ENCODER, two_pass=True, reversed_=True)
    upd, stat = {}, {}
    for k, v in meshed.items():
        if "running" in k:
            stat[k] = _rel(rerun[k] - v, v)[1]
        elif "num_b" not in k and not torch.equal(v, old[k]):
            d = v - old[k]
            upd[k] = _rel(rerun[k] - old[k] - d, d)
    return upd, stat


def hold_update(new, want, old, floors, what):
    """Per tensor k with floors (norm, elem): Δ within max(1e-2, 2·norm) of
    ‖Δ_want‖ and elementwise within rtol 5e-3 + 2·elem·max|Δ_want|."""
    for k, (norm, elem) in floors.items():
        d_want = (want[k] - old[k]).numpy()
        d_got = (new[k] - old[k]).numpy()
        assert np.abs(d_want).max() > 0, (what, k)
        assert (np.linalg.norm(d_got - d_want)
                <= max(1e-2, 2 * norm) * np.linalg.norm(d_want)), (what, k)
        np.testing.assert_allclose(
            d_got, d_want, rtol=5e-3,
            atol=2 * elem * np.abs(d_want).max(), err_msg=f"{what} {k}")


def hold_stats(new, want, floors, what):
    """Running statistics within rtol 1e-4 + atol: 1e-6 (s2s, ``floors``
    None) or max(1e-4, 2·floor)·max|stat| (i2i)."""
    stats = [k for k in want if "running" in k]
    assert stats, what
    for k in stats:
        w = want[k].numpy()
        atol = (1e-6 if floors is None else
                max(1e-4, 2 * floors[k]) * np.abs(w).max())
        np.testing.assert_allclose(new[k].numpy(), w, rtol=1e-4, atol=atol,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("key", STEPS)
def test_dp_step_matches_jax_mesh_and_one_process(run, key):
    """One data-parallel step on each path (all-device: K2's plain version;
    host stats: K1's; i2i: ResNet18 under its freeze mask) from the same
    weights, batch, triplets and yaw: the ranks start from rank 0's weights
    and end bit-equal; against JAX's Trainer on the 2-device mesh and
    against the port's one-process step, the loss, the running statistics
    and every trainable tensor's update hold the bounds above (frozen
    tensors bit-unchanged).

    The trap case: rank 1's clouds lie LIFT_M above rank 0's, and the
    ranks hold 3 and 1 real negatives. Per-rank BatchNorm or per-rank loss
    means fail it: checked on a copy of the port whose Trainer left the
    BatchNorm group unset (each rank normalising its own rows), and on one
    whose ranks divided by their own count of real negatives and averaged
    the gradients (DDP's rule). Against JAX's mesh step, per-rank BatchNorm
    moved the loss by 10.5 % and rank 0's running statistics by 0.69 of
    their largest element (the bounds: 1e-4), and per-rank loss means moved
    the loss by 2.0 %; with either, every one of the 45 tensors' updates
    lay beyond the 1e-2 norm bound (worst 1.57 and 0.73 of ‖Δ_jax‖)."""
    got_loss = float(_ranks(run, f"{key}_loss"))
    new, old = _state(run, key), _state(run, f"{key}_old")
    want_loss, want = run[1][key]
    rank = _one_process_rank(run, key)
    one_loss = float(run[0][rank][f"one_{key}_loss"])
    one = _state(run, f"one_{key}", rank=rank)
    s2s, i2i = weights()
    start = i2i if key == "i2i" else s2s
    assert all(torch.equal(old[k], start[k]) for k in start)
    assert set(new) == set(want) == set(one)
    if key == "i2i":
        # the parameters the ranks' Trainer froze (train_mask) and trained
        frozen, trained = (list(_ranks(run, f"i2i_{k}"))
                           for k in ("frozen", "trained"))
        assert frozen and all(torch.equal(new[k], old[k]) for k in frozen)
        floors, stat_floors = run[1]["i2i_floors"]
        assert set(floors) == set(trained)
    else:
        f = run[1]["s2s_floor"]
        floors = {k: (0.0, f) for k in new if "running" not in k
                  and "num_batches" not in k}
        stat_floors = None
    for ref_loss, ref, what in ((want_loss, want, "JAX mesh"),
                                (one_loss, one, "one process")):
        np.testing.assert_allclose(got_loss, ref_loss, rtol=1e-4,
                                   err_msg=what)
        hold_update(new, ref, old, floors, what)
        hold_stats(new, ref, stat_floors, what)


@pytest.mark.parametrize("key", EPOCHS)
def test_dp_epoch_matches_one_process_and_writes_once(run, key):
    """One train_epoch over the two ranks against the port's one-process
    epoch with the same seed, on the all-device path and on the host-stats
    path (each rank's _train_batch bins its own rows on the host): the
    same mined triplets (the positives and negatives of every batch are
    the ranks' own and equal, and the negative cache equals the
    one-process run's), each step's loss and the mean within rtol 1e-4,
    the same number of steps; rank 0 alone wrote the checkpoint, which
    holds the state both ranks end with."""
    rank = _one_process_rank(run, key)
    one = run[0][rank]
    loss, losses = float(one[f"one_{key}_loss"]), one[f"one_{key}_losses"]
    neg_cache = one[f"one_{key}_neg_cache"]
    steps = int(one[f"one_{key}_steps"])
    state = _state(run, f"one_{key}", rank=rank)
    got = run[0]
    mined = _ranks(run, f"{key}_mined")
    assert mined.shape[0] == steps == int(_ranks(run, f"{key}_steps"))
    np.testing.assert_array_equal(_ranks(run, f"{key}_neg_cache"),
                                  neg_cache)
    np.testing.assert_array_equal(mined, one[f"one_{key}_mined"])
    np.testing.assert_allclose(float(_ranks(run, f"{key}_loss")), loss,
                               rtol=1e-4)
    np.testing.assert_allclose(_ranks(run, f"{key}_losses"), losses,
                               rtol=1e-4)
    assert [int(g[f"{key}_writes"]) for g in got] == [1, 0]
    ckpt_file = run[3] / key / "ckpt_latest.pt"
    saved = torch.load(ckpt_file, weights_only=True)
    assert saved["step"] == steps
    ranks = _state(run, key)
    assert set(saved["model"]) == set(ranks) == set(state)
    for k, v in saved["model"].items():
        assert torch.equal(v, ranks[k]), k


@pytest.mark.parametrize("key", ["x_device", "x_hoststats", "x_i2i"])
def test_shard_extraction_matches_jax(run, key):
    """Descriptors within 1e-5 of JAX's sharded extraction, BEV images and
    origins equal, the same on both ranks."""
    want_d, want_img, want_org = run[1][key]
    np.testing.assert_allclose(_ranks(run, f"{key}_desc"), want_d,
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(_ranks(run, f"{key}_image"), want_img)
    np.testing.assert_array_equal(_ranks(run, f"{key}_origin_xy"), want_org)
    assert len(want_d) == 4


@pytest.mark.parametrize("key", ["x_device", "x_hoststats"])
def test_shard_extraction_falls_back_on_an_odd_batch(run, key):
    """A batch of 3 over 2 ranks runs unsharded on every rank, as in JAX:
    each rank's result is bit-equal to a one-process localizer's."""
    for k in ("desc", "image", "origin_xy", "num_occupied"):
        np.testing.assert_array_equal(_ranks(run, f"{key}_odd_{k}"),
                                      _ranks(run, f"{key}_plain_{k}"),
                                      err_msg=k)


def test_aligned_shard_extraction_matches_the_unsharded_call(run):
    """The aligned path draws every scan's ground samples ahead: ground
    transforms and BEV images bit-equal to the unsharded call with the
    same seed, descriptors within 1e-5, and the localizer's generator in
    the same state on both ranks and after the unsharded call."""
    for k in ("ground_q", "ground_t", "ground_valid", "image", "origin_xy",
              "gen"):
        np.testing.assert_array_equal(_ranks(run, f"x_aligned_{k}"),
                                      _ranks(run, f"x_aligned_plain_{k}"),
                                      err_msg=k)
    assert _ranks(run, "x_aligned_ground_valid").all()
    np.testing.assert_allclose(_ranks(run, "x_aligned_desc"),
                               _ranks(run, "x_aligned_plain_desc"),
                               atol=1e-5, rtol=1e-5)


def test_ranks_load_no_jax(run):
    assert not any(bool(g["jax_loaded"]) for g in run[0])


# ------------------------------------------------------ build-index, dry run

@pytest.fixture(scope="module")
def small_config(tmp_path_factory):
    """test_cli.py's config on under a quarter of its pillar grid (64 × 40
    of 140 × 80), for the three index builds here and the checkpoint
    (test_torch_cli.py's ``ckpt``) they restore: the default grid's
    convolutions set their time, and the padding, trimming and rank-0
    write need no more."""
    from gloc3d_tpu.config import (
        BEVConfig, IndexConfig, MatchConfig, ModelConfig, VoxelConfig,
    )
    from gloc3d_tpu.config import PipelineConfig as JaxConfig

    cfg = JaxConfig(
        bev=BEVConfig(image_size=128, max_points=CLI_PTS),
        voxel=VoxelConfig(max_points=CLI_PTS, xbound=(-16.0, 16.0, 0.5),
                          ybound=(-10.0, 10.0, 0.5)),
        model=ModelConfig(encoder="pointpillar", encoder_dim=128,
                          compute_dtype="float32"),
        index=IndexConfig(dim=128, top_k=3, capacity=16),
        match=MatchConfig(image_size=128, min_score=0.1,
                          min_overlap_pixels=16))
    path = tmp_path_factory.mktemp("cfg") / "config.json"
    path.write_text(cfg.to_json())
    return str(path)


@pytest.fixture(scope="module")
def dp_indexes(kitti_root, small_config, ckpt, tmp_path_factory):  # noqa: F811
    """The val split's db scans indexed by JAX's build-index --dp-devices 2
    and by the port's at --dp-devices 2 and 1 (--device cpu), batch 3: the
    two-rank runs round it to 4 and pad the last of 7 scans' chunks."""
    d = tmp_path_factory.mktemp("build")
    split = str(d / "split.npz")
    port("gen-split", "--root", kitti_root, "--which", "val",
         "--skip-frames", "1", "--query-fraction", "0.42", "--out", split)
    common = ("--split", split, "--config", small_config, "--batch", "3",
              "--checkpoint", ckpt)
    out = {}
    for name, main, extra in (
            ("jax", jax_main, ("--dp-devices", "2")),
            ("port2", None, ("--dp-devices", "2", "--device", "cpu")),
            ("port1", None, ("--dp-devices", "1", "--device", "cpu"))):
        idx = str(d / name)
        if main is None:
            port("build-index", "--out", idx, *common, *extra)
        else:
            run_cli(main, "build-index", "--out", idx, *common, *extra)
        out[name] = {f: dict(np.load(os.path.join(idx, f)))
                     for f in ("bank.npz", "keyframes.npz")}
    return out


@pytest.mark.parametrize("ref", ["jax", "port1"])
def test_build_index_dp_devices_matches(dp_indexes, ref):
    got, want = dp_indexes["port2"], dp_indexes[ref]
    n = len(got["keyframes.npz"]["images"])
    assert n == len(want["keyframes.npz"]["images"]) == 7
    np.testing.assert_allclose(got["bank.npz"]["bank"][:n],
                               want["bank.npz"]["bank"][:n], atol=1e-5,
                               rtol=1e-5)
    for k in ("images", "origins"):
        np.testing.assert_array_equal(got["keyframes.npz"][k],
                                      want["keyframes.npz"][k], err_msg=k)


def test_dryrun_multichip_two_cpu_ranks():
    """The dry run over two spawned gloo ranks: one full all-device train
    step with a finite loss, a sharded_topk query, and data-parallel
    extraction into a sharded bank whose locate_batch equals the
    one-process pipeline's (plain, host stats and aligned); no rank loaded
    JAX."""
    summary = dryrun_multichip(2, device="cpu")
    assert np.isfinite(summary["loss"])
    assert summary["located"] >= 1 and summary["aligned_located"] >= 1
    assert summary["ranks_loaded_jax"] == [False, False]


def test_batchnorm_group_of_one_rank_matches_the_local_batch():
    """A group of one: the group path's output, input gradient and running
    statistics equal the no-group path's (fp64 moments against
    F.batch_norm's) within 1e-5."""
    import torch.distributed as dist

    x = torch.from_numpy(np.random.RandomState(0).randn(4, 6, 5, 5)
                         .astype(np.float32) * 3 + 1)
    init = f"file://{tempfile.mkdtemp()}/store"
    dist.init_process_group("gloo", init_method=init, world_size=1, rank=0)
    try:
        outs = []
        for group in (None, dist.group.WORLD):
            bn = BatchNorm(6).train()
            bn.weight.data.uniform_(0.5, 1.5, generator=torch.Generator()
                                    .manual_seed(1))
            bn.group = group
            xi = x.clone().requires_grad_(True)
            y = bn(xi)
            (y * torch.arange(y.numel()).reshape(y.shape).sin()).sum(
                ).backward()
            outs.append((y.detach(), xi.grad, bn.weight.grad, bn.bias.grad,
                         bn.running_mean, bn.running_var))
    finally:
        dist.destroy_process_group()
    for a, b in zip(*outs):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-5,
                                   rtol=1e-5)
