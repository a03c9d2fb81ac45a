"""The port's model export (``gloc3d_tpu_torch/export.py``) and the custom
ops that carry kernels K1 and K2 (``kernels/ops.py``).

Counterparts of tests/test_export_handoff.py and test_packed_export.py: the
s2s descriptor model exported with ``torch.export`` on the CPU carries
``gloc3d::pillar_bin_sums`` and no plain-binning node (the plain forward
bins on the device, so K1's op does not appear there: an export of K1's
wrapper holds it); a fresh process that blocks jax, flax and the JAX
package, imports ``gloc3d_tpu_torch.kernels.ops`` and nothing of the
port's models, pipeline or config reloads the blob and reproduces the
descriptors bit for bit; the program matches the live port model (rtol
1e-5, atol 1e-6, JAX's bound for its own blob) and JAX's exported blob
on shared weights (atol 2e-4, rtol 2e-3: the descriptor bound of
tests/test_torch_pointpillar.py, fp32 sums in another order).

The custom ops on CPU tensors equal the plain versions bit for bit, pass
``torch.library.opcheck``, and their fake implementations give the
shapes the arguments fix.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gloc3d_tpu.config import ModelConfig as JaxModelConfig
from gloc3d_tpu.config import VoxelConfig as JaxVoxelConfig
from gloc3d_tpu.export import export_descriptor_model as jax_export
from gloc3d_tpu.export import load_exported as jax_load_exported
from gloc3d_tpu.models import build_model as jax_build_model
from gloc3d_tpu_torch.config import ModelConfig, VoxelConfig
from gloc3d_tpu_torch.convert import flax_to_state_dict
from gloc3d_tpu_torch.export import (
    ExportedDescriptorModel, export_descriptor_model, export_fn,
    export_program, load_exported, load_program,
)
from gloc3d_tpu_torch.kernels import bin_sums as bs
from gloc3d_tpu_torch.kernels import segment_sum as ss
from gloc3d_tpu_torch.models.descriptor import build_model, init_params
from test_torch_threads import _two_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PTS = 512
XB, YB = (-10.0, 10.0, 0.5), (-6.0, 6.0, 0.5)
LIVE_TOL = dict(rtol=1e-5, atol=1e-6)
JAX_TOL = dict(rtol=2e-3, atol=2e-4)


def _scan(n=N_PTS, seed=0):
    rng = np.random.RandomState(seed)
    pts = np.zeros((1, n, 4), np.float32)
    pts[..., 0] = rng.uniform(-9, 9, (1, n))
    pts[..., 1] = rng.uniform(-5, 5, (1, n))
    pts[..., 2] = rng.uniform(0, 3, (1, n))
    pts[..., 3] = rng.uniform(0, 1, (1, n))
    return pts, np.ones((1, n), np.float32)


@pytest.fixture(scope="module")
def shared():
    """JAX's model and weights (PRNGKey(0)), the port model on the same
    weights, an input scan, and both packages' exported blobs."""
    jmc = JaxModelConfig(encoder="pointpillar", encoder_dim=128,
                         compute_dtype="float32")
    jvc = JaxVoxelConfig(max_points=N_PTS, xbound=XB, ybound=YB)
    jmodel = jax_build_model(jmc, jvc)
    pts, mask = _scan()
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(pts),
                                  jnp.asarray(mask))
    model = build_model(
        ModelConfig(encoder="pointpillar", encoder_dim=128,
                    compute_dtype="float32"),
        VoxelConfig(max_points=N_PTS, xbound=XB, ybound=YB))
    model.load_state_dict(flax_to_state_dict(params))
    model.eval()
    p, m = torch.from_numpy(pts), torch.from_numpy(mask)
    return {"model": model, "pts": pts, "mask": mask,
            "blob": export_descriptor_model(model, p, m),
            "jax": np.asarray(jax_load_exported(jax_export(
                jmodel, params, jnp.asarray(pts), jnp.asarray(mask)))(
                    pts, mask))}


def _targets(program):
    return [str(n.target) for n in program.graph.nodes
            if n.op == "call_function"]


def test_cpu_export_carries_the_k2_op_and_no_plain_binning(shared):
    targets = _targets(load_program(shared["blob"], "cpu"))
    assert targets.count("gloc3d.pillar_bin_sums.default") == 2, targets
    plain = [t for t in targets if "index_add" in t or "bincount" in t]
    assert not plain, plain


def test_k1_op_in_an_exported_graph():
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(1, 40, 8).astype(np.float32))
    starts = torch.tensor([[0, 10, 10, 25, 40]], dtype=torch.int32)
    program = export_program(ss.segment_sum_sorted, x, starts)
    targets = _targets(program)
    assert targets == ["gloc3d.segment_sum_sorted.default"], targets
    assert torch.equal(program.module()(x, starts),
                       ss.segment_sum_sorted_plain(x, starts))


def test_export_matches_live_model_and_jax_blob(shared):
    got = load_exported(shared["blob"], "cpu")(shared["pts"], shared["mask"])
    with torch.no_grad():
        live = shared["model"](torch.from_numpy(shared["pts"]),
                               torch.from_numpy(shared["mask"]))
    np.testing.assert_allclose(got.numpy(), live.numpy(), **LIVE_TOL)
    np.testing.assert_allclose(got.numpy(), shared["jax"], **JAX_TOL)


FRESH_PROCESS_SCRIPT = textwrap.dedent("""
    import io
    import sys
    sys.modules["jax"] = None
    sys.modules["flax"] = None
    sys.modules["gloc3d_tpu"] = None
    import numpy as np
    import torch
    import gloc3d_tpu_torch.kernels.ops  # registers the gloc3d:: ops

    blob_path, pts_path, out_path = sys.argv[1:4]
    with open(blob_path, "rb") as f:
        program = torch.export.load(io.BytesIO(f.read()))
    d = np.load(pts_path)
    with torch.no_grad():
        out = program.module()(torch.from_numpy(d["pts"]),
                               torch.from_numpy(d["mask"]))
    # the hand-off contract: no model-building code was imported
    loaded = [m for m in sys.modules if m.startswith((
        "gloc3d_tpu_torch.models", "gloc3d_tpu_torch.pipeline",
        "gloc3d_tpu_torch.config"))]
    assert not loaded, loaded
    np.save(out_path, out.numpy())
""")


def test_fresh_process_reload_bit_identical(shared, tmp_path):
    want = load_exported(shared["blob"], "cpu")(shared["pts"],
                                                shared["mask"]).numpy()
    blob_path = tmp_path / "model.pt2"
    blob_path.write_bytes(shared["blob"])
    np.savez(tmp_path / "inputs.npz", pts=shared["pts"], mask=shared["mask"])
    script = tmp_path / "reload.py"
    script.write_text(FRESH_PROCESS_SCRIPT)
    out_path = tmp_path / "desc.npy"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    r = subprocess.run(
        [sys.executable, str(script), str(blob_path),
         str(tmp_path / "inputs.npz"), str(out_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, f"fresh process failed:\n{r.stderr[-3000:]}"
    got = np.load(out_path)
    assert np.array_equal(got, want), np.abs(got - want).max()


def test_importing_the_ops_loads_no_model_code():
    """``import gloc3d_tpu_torch.kernels.ops`` imports neither the models
    nor the pipeline; the package's names still load on first use."""
    script = textwrap.dedent("""
        import sys
        import gloc3d_tpu_torch.kernels.ops
        import torch
        assert hasattr(torch.ops.gloc3d, "pillar_bin_sums")
        assert hasattr(torch.ops.gloc3d, "segment_sum_sorted")
        heavy = [m for m in sys.modules if m.startswith((
            "gloc3d_tpu_torch.models", "gloc3d_tpu_torch.pipeline",
            "gloc3d_tpu_torch.config"))]
        assert not heavy, heavy
        import gloc3d_tpu_torch as g
        assert g.PipelineConfig.s2s().model.encoder == "pointpillar"
        assert g.GlobalLocalizer.__name__ == "GlobalLocalizer"
        assert "gloc3d_tpu_torch.pipeline" in sys.modules
    """)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-c", script], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]


def test_exported_model_refuses_kwargs(shared):
    shim = ExportedDescriptorModel(shared["blob"], "cpu")
    assert shim.supports_voxel_stats is False
    got = shim(torch.from_numpy(shared["pts"]),
               torch.from_numpy(shared["mask"]))
    with torch.no_grad():
        want = shared["model"](torch.from_numpy(shared["pts"]),
                               torch.from_numpy(shared["mask"]))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **LIVE_TOL)
    # keyword paths are refused, not silently wrong
    with pytest.raises(ValueError, match="voxel_stats"):
        shim(shared["pts"], shared["mask"], voxel_stats=None)


def test_localizer_on_an_exported_model_drops_host_stats(shared):
    from gloc3d_tpu_torch.config import PipelineConfig
    from gloc3d_tpu_torch.pipeline import GlobalLocalizer

    cfg = PipelineConfig(model=shared["model"].model_cfg,
                         voxel=VoxelConfig(max_points=N_PTS, xbound=XB,
                                           ybound=YB))
    loc = GlobalLocalizer(cfg, ExportedDescriptorModel(shared["blob"], "cpu"),
                          host_stats=True, device="cpu")
    assert loc.host_stats is False
    desc, _, _ = loc.extract(shared["pts"], shared["mask"])
    with torch.no_grad():
        want = shared["model"](torch.from_numpy(shared["pts"]),
                               torch.from_numpy(shared["mask"]))
    np.testing.assert_allclose(desc.numpy(), want.numpy(), **LIVE_TOL)


def test_export_roundtrip():
    def fn(x, y):
        return torch.tanh(x) @ y

    x, y = torch.ones((4, 8)), torch.ones((8, 3))
    blob = export_fn(fn, x, y)
    assert isinstance(blob, (bytes, bytearray))
    restored = load_exported(bytes(blob), "cpu")
    np.testing.assert_allclose(restored(x, y).numpy(), fn(x, y).numpy(),
                               atol=1e-6)


def test_export_descriptor_model_with_a_padded_mask():
    """tests/test_packed_export.py's export case: 256 points, a tenth of
    them masked out, the program = the live model."""
    model = init_params(build_model(
        ModelConfig(encoder="pointpillar", encoder_dim=128,
                    compute_dtype="float32"),
        VoxelConfig(max_points=256, xbound=XB, ybound=YB))).eval()
    pts, _ = _scan(256, seed=1)
    mask = (np.random.RandomState(1).uniform(size=(1, 256)) > 0.1
            ).astype(np.float32)
    p, m = torch.from_numpy(pts), torch.from_numpy(mask)
    fn = load_exported(export_descriptor_model(model, p, m), "cpu")
    with torch.no_grad():
        want = model(p, m)
    got = fn(pts, mask)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), **LIVE_TOL)


# ------------------------------------------------------------ custom ops


def _op_case(kind, batched):
    rng = np.random.RandomState(7)
    b = (2,) if batched else ()
    if kind == "K1":
        n, v, c = 300, 20, 64
        x = torch.from_numpy(rng.randn(*b, n, c).astype(np.float32))
        cuts = np.sort(rng.randint(0, n, b + (v - 1,)), axis=-1)
        starts = np.concatenate([np.zeros(b + (1,), np.int64), cuts,
                                 np.full(b + (1,), n)], axis=-1)
        return (torch.ops.gloc3d.segment_sum_sorted.default,
                (x, torch.from_numpy(starts.astype(np.int32))),
                ss.segment_sum_sorted_plain)
    n, v, c = 300, 20, 4
    x = torch.from_numpy(rng.randn(*b, n, c).astype(np.float32))
    ids = torch.from_numpy(rng.randint(0, v, b + (n,)).astype(np.int32))
    return (torch.ops.gloc3d.pillar_bin_sums.default, (x, ids, v),
            bs.pillar_bin_sums_plain)


OP_CASES = [("K1", True), ("K1", False), ("K2", True), ("K2", False)]
OP_IDS = ["K1 batched", "K1 one scan", "K2 batched", "K2 one scan"]


@pytest.mark.parametrize("kind,batched", OP_CASES, ids=OP_IDS)
def test_cpu_op_equals_plain_bit_for_bit(kind, batched):
    op, args, plain = _op_case(kind, batched)
    launches = (ss.segment_sum_sorted.launches, bs.pillar_bin_sums.launches)
    got, want = op(*args), plain(*args)
    for g, w in zip(*((got, want) if kind == "K2" else ((got,), (want,)))):
        assert g.dtype == torch.float32
        assert torch.equal(g, w)
    assert (ss.segment_sum_sorted.launches,
            bs.pillar_bin_sums.launches) == launches


@pytest.mark.parametrize("kind,batched", OP_CASES, ids=OP_IDS)
def test_opcheck(kind, batched):
    op, args, _ = _op_case(kind, batched)
    torch.library.opcheck(op, args)


@pytest.mark.parametrize("kind,batched", OP_CASES, ids=OP_IDS)
def test_fake_shapes(kind, batched):
    from torch._subclasses.fake_tensor import FakeTensorMode

    op, args, plain = _op_case(kind, batched)
    want = plain(*args)
    with FakeTensorMode() as mode:
        fake_args = tuple(mode.from_tensor(a) if isinstance(a, torch.Tensor)
                          else a for a in args)
        got = op(*fake_args)
    got, want = ((got, want) if kind == "K2" else ((got,), (want,)))
    assert [(g.shape, g.dtype) for g in got] == [(w.shape, w.dtype)
                                                 for w in want]
