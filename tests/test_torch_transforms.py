"""core/transforms.py and eval/registration.py: the port against the JAX
package on the same random inputs, made with numpy.

Tolerance atol 1e-6: the same fp32 elementwise formulas on both sides;
only transcendental functions and the order of a few adds differ."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gloc3d_tpu.core import transforms as jt
from gloc3d_tpu.eval.registration import compose_6dof as jax_compose
from gloc3d_tpu.eval.registration import registration_errors as jax_errors
from gloc3d_tpu_torch.core import transforms as tt
from gloc3d_tpu_torch.eval.registration import (
    compose_6dof, registration_errors,
)
from test_torch_threads import _two_threads  # noqa: F401


ATOL = 1e-6


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _quats(n, seed):
    q = _rand((n, 4), seed)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("name", [
    "quat_normalize", "quat_conj", "quat_to_matrix", "get_yaw", "remove_yaw",
])
def test_unary_quaternion_functions(name):
    q = _quats(64, 0) * 1.3  # not unit for quat_normalize / quat_conj
    if name not in ("quat_normalize", "quat_conj"):
        q = _quats(64, 0)
    _close(getattr(tt, name)(torch.from_numpy(q)),
           getattr(jt, name)(jnp.asarray(q)))


def test_matrix_to_quat_matches_jax():
    """Random rotations and one rotation per Shepperd pivot (the trace,
    then m00, m11, m22 largest: identity and 180° turns about x, y, z)."""
    half_turns = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0],
                           [0, 0, 0, 1]], np.float32)
    q = np.concatenate([_quats(64, 15), half_turns])
    m = np.asarray(jt.quat_to_matrix(jnp.asarray(q)))
    got = tt.matrix_to_quat(torch.from_numpy(m))
    _close(got, jt.matrix_to_quat(jnp.asarray(m)), atol=2e-6)
    # the same rotation: q or -q
    dots = np.abs((got.numpy() * q).sum(-1))
    np.testing.assert_allclose(dots, 1.0, atol=2e-6)


def test_quat_mul_rotate_identity():
    a, b, v = _quats(64, 1), _quats(64, 2), _rand((64, 3), 3)
    _close(tt.quat_mul(torch.from_numpy(a), torch.from_numpy(b)),
           jt.quat_mul(jnp.asarray(a), jnp.asarray(b)))
    _close(tt.quat_rotate(torch.from_numpy(a), torch.from_numpy(v)),
           jt.quat_rotate(jnp.asarray(a), jnp.asarray(v)), atol=4e-6)
    _close(tt.quat_identity(), jt.quat_identity())


def test_rpy_round_trip_matches_jax():
    rpy = _rand((3, 64), 4) * np.array([[0.5], [0.5], [3.0]], np.float32)
    q_t = tt.quat_from_rpy(*torch.from_numpy(rpy))
    q_j = jt.quat_from_rpy(*jnp.asarray(rpy))
    _close(q_t, q_j)
    for got, want in zip(tt.rpy_from_quat(q_t), jt.rpy_from_quat(q_j)):
        _close(got, want, atol=2e-6)


@pytest.mark.parametrize("case", ["random", "parallel", "antiparallel_x",
                                  "antiparallel_z"])
def test_quat_from_two_vectors(case):
    a = _rand((32, 3), 5)
    b = {"random": _rand((32, 3), 6), "parallel": 2.0 * a,
         "antiparallel_x": None, "antiparallel_z": None}[case]
    if case == "antiparallel_x":  # a ≈ ±ex takes the a×ez axis
        a = np.tile(np.array([[1.0, 0.02, 0.0]], np.float32), (32, 1))
        b = -a
    if case == "antiparallel_z":
        a = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (32, 1))
        b = -a
    got = tt.quat_from_two_vectors(torch.from_numpy(a), torch.from_numpy(b))
    want = jt.quat_from_two_vectors(jnp.asarray(a), jnp.asarray(b))
    _close(got, want, atol=2e-6)


def test_rigid3_compose_inverse_apply_transform_points():
    qa, qb = _quats(16, 7), _quats(16, 8)
    ta, tb, pts = _rand((16, 3), 9), _rand((16, 3), 10), _rand((16, 3), 11)
    a_t = tt.Rigid3(torch.from_numpy(qa), torch.from_numpy(ta))
    b_t = tt.Rigid3(torch.from_numpy(qb), torch.from_numpy(tb))
    a_j = jt.Rigid3(jnp.asarray(qa), jnp.asarray(ta))
    b_j = jt.Rigid3(jnp.asarray(qb), jnp.asarray(tb))
    for got, want in ((a_t.compose(b_t), a_j.compose(b_j)),
                      (a_t.inverse(), a_j.inverse())):
        _close(got.rotation, want.rotation)
        _close(got.translation, want.translation, atol=4e-6)
    _close(a_t.apply(torch.from_numpy(pts)), a_j.apply(jnp.asarray(pts)),
           atol=4e-6)
    one_t = tt.Rigid3(a_t.rotation[0], a_t.translation[0])
    one_j = jt.Rigid3(a_j.rotation[0], a_j.translation[0])
    _close(tt.transform_points(one_t, torch.from_numpy(pts)),
           jt.transform_points(one_j, jnp.asarray(pts)), atol=4e-6)


def test_rigid2_and_embed_3d():
    ang, t2, p2 = _rand((16,), 12), _rand((16, 2), 13), _rand((16, 2), 14)
    a_t = tt.Rigid2(torch.from_numpy(ang), torch.from_numpy(t2))
    a_j = jt.Rigid2(jnp.asarray(ang), jnp.asarray(t2))
    b_t = tt.Rigid2(torch.from_numpy(ang[::-1].copy()),
                    torch.from_numpy(t2[::-1].copy()))
    b_j = jt.Rigid2(jnp.asarray(ang[::-1]), jnp.asarray(t2[::-1]))
    for got, want in ((a_t.compose(b_t), a_j.compose(b_j)),
                      (a_t.inverse(), a_j.inverse())):
        _close(got.angle, want.angle)
        _close(got.translation, want.translation, atol=4e-6)
    _close(a_t.apply(torch.from_numpy(p2)), a_j.apply(jnp.asarray(p2)),
           atol=4e-6)
    e_t, e_j = tt.embed_3d(a_t), jt.embed_3d(a_j)
    _close(e_t.rotation, e_j.rotation)
    _close(e_t.translation, e_j.translation)


def _ground_frame(seed):
    rng = np.random.RandomState(seed)
    q = np.asarray(jt.remove_yaw(jt.quat_from_rpy(
        *jnp.asarray(rng.uniform(-0.05, 0.05, 3), jnp.float32))))
    return q.astype(np.float32), np.array([0, 0, rng.uniform(1.5, 1.9)],
                                          np.float32)


@pytest.mark.parametrize("which", ["both", "query_only", "db_only",
                                   "neither"])
def test_compose_6dof_either_none_rule(which):
    """Both ground frames → the aligned composition; either one missing →
    the non-aligned branch, exactly as the JAX function decides."""
    gq, gdb = _ground_frame(1), _ground_frame(2)
    t_q = gq if which in ("both", "query_only") else None
    t_db = gdb if which in ("both", "db_only") else None
    for xy_yaw in ([1.0, -2.0, 0.3], [0.0, 0.0, -3.1], [5.5, 2.0, 1.7]):
        got = compose_6dof(
            torch.tensor(xy_yaw), None if t_q is None else tt.Rigid3(*t_q),
            None if t_db is None else tt.Rigid3(*t_db))
        want = jax_compose(
            jnp.asarray(xy_yaw, jnp.float32),
            None if t_q is None else jt.Rigid3(*map(jnp.asarray, t_q)),
            None if t_db is None else jt.Rigid3(*map(jnp.asarray, t_db)))
        _close(got.rotation, want.rotation, atol=2e-6)
        _close(got.translation, want.translation, atol=4e-6)


def test_registration_errors_match_jax():
    rng = np.random.RandomState(3)
    pred_q, gt_q = _quats(32, 15), _quats(32, 16)
    # a few near-identity and near-180° errors (the forgiveness window)
    flip = np.asarray(jt.quat_mul(jnp.asarray(gt_q[:4]), jnp.asarray(
        [[0.0, 0.0, 0.0, 1.0]] * 4, jnp.float32)))
    pred_q[:4] = flip
    pred_q[4:8] = gt_q[4:8]
    pred_t = rng.randn(32, 3).astype(np.float32)
    gt_t = rng.randn(32, 3).astype(np.float32)
    got = registration_errors(tt.Rigid3(pred_q, pred_t),
                              tt.Rigid3(gt_q, gt_t))
    want = jax_errors(jt.Rigid3(jnp.asarray(pred_q), jnp.asarray(pred_t)),
                      jt.Rigid3(jnp.asarray(gt_q), jnp.asarray(gt_t)))
    _close(got[0], want[0], atol=4e-6)
    _close(got[1], want[1], atol=2e-3)  # degrees through arccos near ±1


def _rigid3(n, seed):
    """(q, t) numpy: n rotations and translations, or one when n is None."""
    q, t = _quats(n or 1, seed), _rand((n or 1, 3), seed + 1) * 10
    return (q, t) if n else (q[0], t[0])


@pytest.mark.parametrize("n", [8, None], ids=["batched", "single"])
def test_rigid3_identity_matrices_and_matmul_match_jax(n):
    """identity, to_matrix, from_matrix and __matmul__ against JAX, batched
    (8, 4, 4) and single; from_matrix(to_matrix(x)) gives x back."""
    (qa, ta), (qb, tb) = _rigid3(n, 20), _rigid3(n, 22)
    pts = _rand((n or 1, 3), 24)[0 if n is None else slice(None)]
    a_t = tt.Rigid3(torch.from_numpy(qa), torch.from_numpy(ta))
    b_t = tt.Rigid3(torch.from_numpy(qb), torch.from_numpy(tb))
    a_j = jt.Rigid3(jnp.asarray(qa), jnp.asarray(ta))
    b_j = jt.Rigid3(jnp.asarray(qb), jnp.asarray(tb))

    m_t, m_j = a_t.to_matrix(), a_j.to_matrix()
    assert m_t.shape == m_j.shape == (n,) * bool(n) + (4, 4)
    assert m_t.dtype == torch.float32
    _close(m_t, m_j)
    back_t = tt.Rigid3.from_matrix(m_t)
    back_j = jt.Rigid3.from_matrix(jnp.asarray(m_t.numpy()))
    _close(back_t.rotation, back_j.rotation, atol=2e-6)
    _close(back_t.translation, back_j.translation, atol=4e-6)
    # the round trip: the same rotation (q or -q) and translation
    np.testing.assert_allclose(np.abs((back_t.rotation.numpy() * qa).sum(-1)),
                               1.0, atol=2e-6)
    _close(back_t.translation, ta, atol=4e-6)

    for got, want in ((a_t @ b_t, a_j @ b_j), (a_t @ a_t.inverse(),
                                                 a_j @ a_j.inverse())):
        _close(got.rotation, want.rotation)
        _close(got.translation, want.translation, atol=4e-6)
    _close(a_t @ torch.from_numpy(pts), a_j @ jnp.asarray(pts), atol=4e-6)

    for dtype in (torch.float32, torch.float64):
        i3 = tt.Rigid3.identity(dtype)
        j3 = jt.Rigid3.identity()
        assert i3.rotation.dtype == i3.translation.dtype == dtype
        _close(i3.rotation, j3.rotation)
        _close(i3.translation, j3.translation)
        i2, j2 = tt.Rigid2.identity(dtype), jt.Rigid2.identity()
        assert i2.angle.shape == () and i2.translation.shape == (2,)
        assert i2.angle.dtype == dtype
        _close(i2.angle, j2.angle)
        _close(i2.translation, j2.translation)
    ident = tt.Rigid3.identity() @ a_t
    _close(ident.rotation, qa)
    _close(ident.translation, ta, atol=4e-6)


def _numpy_case(name):
    """(port result, JAX result) of ``name`` called on numpy-held fields and
    numpy operands, the same numpy on both sides."""
    qa, ta = _rigid3(8, 30)
    qb, tb = _rigid3(8, 32)
    pts = _rand((8, 3), 34)
    ang, t2, p2 = _rand((8,), 35), _rand((8, 2), 36), _rand((8, 2), 37)
    a_t, a_j = tt.Rigid3(qa, ta), jt.Rigid3(qa, ta)
    b_t, b_j = tt.Rigid3(qb, tb), jt.Rigid3(qb, tb)
    r_t, r_j = tt.Rigid2(ang, t2), jt.Rigid2(ang, t2)
    s_t, s_j = tt.Rigid2(ang[::-1], t2[::-1]), jt.Rigid2(ang[::-1], t2[::-1])
    one_t, one_j = tt.Rigid3(qa[0], ta[0]), jt.Rigid3(qa[0], ta[0])
    return {
        "compose": lambda: (a_t.compose(b_t), a_j.compose(b_j)),
        "inverse": lambda: (a_t.inverse(), a_j.inverse()),
        "apply": lambda: (a_t.apply(pts), a_j.apply(pts)),
        "to_matrix": lambda: (a_t.to_matrix(), a_j.to_matrix()),
        "from_matrix": lambda: (
            tt.Rigid3.from_matrix(np.asarray(a_j.to_matrix())),
            jt.Rigid3.from_matrix(np.asarray(a_j.to_matrix()))),
        "matmul_points": lambda: (a_t @ pts, a_j @ pts),
        "matmul_rigid3": lambda: (a_t @ b_t, a_j @ b_j),
        "rigid2_compose": lambda: (r_t.compose(s_t), r_j.compose(s_j)),
        "rigid2_inverse": lambda: (r_t.inverse(), r_j.inverse()),
        "rigid2_apply": lambda: (r_t.apply(p2), r_j.apply(p2)),
        "project_2d": lambda: (tt.project_2d(a_t), jt.project_2d(a_j)),
        "embed_3d": lambda: (tt.embed_3d(r_t), jt.embed_3d(r_j)),
        "transform_points": lambda: (tt.transform_points(one_t, pts),
                                     jt.transform_points(one_j, pts)),
    }[name]()


@pytest.mark.parametrize("name", [
    "compose", "inverse", "apply", "to_matrix", "from_matrix",
    "matmul_points", "matmul_rigid3", "rigid2_compose", "rigid2_inverse",
    "rigid2_apply", "project_2d", "embed_3d", "transform_points"])
def test_methods_take_numpy_fields_as_jax_does(name):
    """Results hold numpy poses (LocalizationResult.pose): every method and
    project_2d / embed_3d / transform_points takes numpy fields and
    operands, as JAX's do, and returns tensors equal to JAX's."""
    got, want = _numpy_case(name)
    # quaternions from matrices 2e-6, translations and points 4e-6
    tol = {"from_matrix": (2e-6, 4e-6)}.get(name, (ATOL, 4e-6))
    if isinstance(want, tuple):
        assert type(got).__name__ == type(want).__name__
        for i, (g, w) in enumerate(zip(got, want)):
            assert isinstance(g, torch.Tensor)
            _close(g, w, atol=tol[min(i, 1)])
    else:
        assert isinstance(got, torch.Tensor)
        _close(got, want, atol=tol[0] if name == "to_matrix" else tol[1])


def test_numpy_fields_follow_the_tensor_operand():
    """A numpy field keeps its dtype and takes the tensor operand's device
    (the CPU here; the card in chip_smoke.py's [surface] phase); a numpy
    operand goes to the fields' device. Views torch cannot share (reversed,
    read-only) are copied."""
    qa, ta = _rigid3(None, 40)
    q64, t64 = qa.astype(np.float64), ta.astype(np.float64)
    pts = _rand((5, 3), 41).astype(np.float64)
    got = tt.Rigid3(q64, t64) @ torch.from_numpy(pts)
    assert got.dtype == torch.float64 and got.device == torch.device("cpu")
    _close(got, jt.Rigid3(qa, ta) @ pts.astype(np.float32), atol=4e-6)
    t = tt.Rigid3(torch.from_numpy(qa), torch.from_numpy(ta))
    assert (t @ pts.astype(np.float32)).dtype == torch.float32
    m = tt.Rigid3(q64, t64).to_matrix()
    assert m.dtype == torch.float64
    np.testing.assert_array_equal(m[3].numpy(), [0, 0, 0, 1])
    ro = pts.astype(np.float32)[::-1]
    ro.flags.writeable = False
    _close(t @ ro, jt.Rigid3(qa, ta) @ ro, atol=4e-6)
