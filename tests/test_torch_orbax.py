"""``tools/orbax_to_npz.py``: the JAX trainer's orbax checkpoints into the
path-encoded ``.npz`` that the port reads.

The JAX ``Trainer.save_checkpoint`` writes a ``ckpt_latest`` directory
(params, batch_stats, the SGD state and the step) from tests/test_torch_
cli.py's shared weights; the script turns it into an ``.npz``. The JAX
CLI's ``--checkpoint`` restores an orbax directory of the model variables
alone (its restore target is the variables tree), so the same variables are
also saved in that layout for it. Held: the script's arrays equal the
variables bit for bit, from either layout; the port's ``cli query`` with
the ``.npz`` equals the JAX ``cli query`` with the orbax directory, on an
index the JAX CLI built from the same weights (test_torch_cli.py's
``same_result``); the port's CLI refuses the orbax directory and names the
script."""

import importlib.util
import os

import jax
import numpy as np
import orbax.checkpoint as ocp
import pytest

from gloc3d_tpu.cli import main as jax_main
from gloc3d_tpu.config import PipelineConfig as JaxConfig
from gloc3d_tpu.models import build_model as jax_build_model
from gloc3d_tpu.models.pointpillar import load_pointpillar_npz
from gloc3d_tpu.train.trainer import Trainer as JaxTrainer
from test_cli import N_PTS, kitti_root, small_config  # noqa: F401
from test_torch_cli import ckpt, last_json, port, run, same_result  # noqa: F401
from test_torch_threads import _two_threads  # noqa: F401
from test_train import _make_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "tools", "orbax_to_npz.py")


def _script():
    spec = importlib.util.spec_from_file_location("orbax_to_npz", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def checkpoints(small_config, ckpt, tmp_path_factory):  # noqa: F811
    """The shared weights as the JAX trainer's ckpt_latest and as an orbax
    variables directory, each converted by the script."""
    d = tmp_path_factory.mktemp("orbax")
    cfg = JaxConfig.from_json(open(small_config).read())
    model = jax_build_model(cfg.model, cfg.voxel)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            np.zeros((1, N_PTS, 4), np.float32),
                            np.zeros((1, N_PTS), np.float32))
    variables = load_pointpillar_npz(jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), shapes), ckpt)
    trainer = JaxTrainer(cfg, model, _make_dataset(), str(d / "run"))
    trainer.save_checkpoint(trainer.init_state(
        variables["params"], variables["batch_stats"]), "latest")
    var_dir = str(d / "variables")
    saver = ocp.StandardCheckpointer()
    saver.save(var_dir, variables, force=True)
    saver.wait_until_finished()
    script = _script()
    out = {"trainer_dir": str(d / "run" / "ckpt_latest"),
           "variables_dir": var_dir, "variables": variables}
    for name in ("trainer", "variables"):
        out[f"{name}_npz"] = str(d / f"{name}.npz")
        assert script.main([out[f"{name}_dir"], out[f"{name}_npz"]]) == 0
    return out


@pytest.mark.parametrize("layout", ["trainer", "variables"])
def test_script_writes_the_variables(checkpoints, ckpt, layout):  # noqa: F811
    """Every params / batch_stats array, bit for bit, under its tree path:
    the keys and values of the path-encoded checkpoint both CLIs read."""
    got = np.load(checkpoints[f"{layout}_npz"])
    want = np.load(ckpt)
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def jax_index(kitti_root, small_config, ckpt, tmp_path_factory):  # noqa: F811
    d = tmp_path_factory.mktemp("orbax_index")
    split = str(d / "split.npz")
    run(jax_main, "gen-split", "--root", kitti_root, "--which", "val",
        "--skip-frames", "1", "--query-fraction", "0.34", "--out", split)
    idx = str(d / "index")
    run(jax_main, "build-index", "--split", split, "--out", idx,
        "--config", small_config, "--batch", "4", "--checkpoint", ckpt)
    from gloc3d_tpu_torch.data.kitti import SplitIndex

    return idx, SplitIndex.load(split)


def test_port_query_with_converted_checkpoint_matches_jax(
        checkpoints, jax_index, small_config):  # noqa: F811
    """The port's query with the trainer checkpoint converted = the JAX
    query with the orbax directory, for a db scan and a query scan."""
    idx, split = jax_index
    for scan in (split.db_files[0], split.q_files[0]):
        want = last_json(run(jax_main, "query", "--index", idx, "--scan",
                             scan, "--config", small_config, "--checkpoint",
                             checkpoints["variables_dir"]))
        got = last_json(port("query", "--index", idx, "--scan", scan,
                             "--config", small_config, "--checkpoint",
                             checkpoints["trainer_npz"], "--device", "cpu"))
        same_result(got, want, split.utm_db)
    assert want["success"]


def test_port_cli_refuses_orbax_directories(checkpoints, jax_index,
                                            small_config):  # noqa: F811
    idx, split = jax_index
    with pytest.raises(SystemExit, match="tools/orbax_to_npz.py"):
        port("query", "--index", idx, "--scan", split.q_files[0],
             "--config", small_config, "--checkpoint",
             checkpoints["trainer_dir"], "--device", "cpu")
