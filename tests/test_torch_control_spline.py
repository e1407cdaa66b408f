"""The port's KKT QP, reference MPC QP and spline planner against JAX's.

``merging_gym_tpu_torch.core.control.eq_qp`` / ``mpc_1d_qp`` and
``core.spline.fit`` / ``evaluate`` on the CPU in f64, held against the JAX
package's f64 results at the tolerances of ``tests/test_control.py``
(1e-9, 1e-8) and ``tests/test_spline.py``, and a ``torch.autograd``
gradient of ``fit`` with respect to the waypoints against ``jax.grad``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merging_gym_tpu.core import control as jcontrol
from merging_gym_tpu.core import spline as jspline
from merging_gym_tpu_torch.core import constants as C
from merging_gym_tpu_torch.core import control, spline
from tests.torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")

# (xs, ys, ts, kwargs) of tests/test_spline.py's fits, and five waypoints
# at default times under a yaw constraint.
FITS = [
    ([0.0, 10.0, 20.0], [0.0, 1.0, 0.0], [0.0, 1.0, 2.0],
     dict(vx=20.0, vy=0.0)),
    (list(3.0 * np.linspace(0.0, 2.0, 5)), [0.0] * 5,
     list(np.linspace(0.0, 2.0, 5)), {}),
    ([0.0, 5.0], [0.0, 3.0], [0.0, 1.0], dict(yaw=0.5)),
    ([0.0, 1.0], [0.0, 1.0], [0.0, 1.0], {}),
    ([1.0, 4.0, 9.0, 15.0, 18.0], [0.0, 0.5, 2.0, 2.5, 2.0], None,
     dict(yaw=0.2)),
]


def _f64(v):
    return torch.tensor(v, dtype=torch.float64)


@pytest.mark.parametrize("v0", [0.0, 7.3, 20.0, 39.9, 55.0])
@pytest.mark.parametrize("vt", list(C.TARGET_VELS))
def test_mpc_1d_qp_equals_jax_and_the_analytic_law(v0, vt):
    u = control.mpc_1d_qp(v0, vt, device=CPU)
    assert u.dtype == torch.float64 and u.shape == (10,)
    analytic = (vt - v0) / C.PREDICTION_T
    np.testing.assert_allclose(u.numpy(), np.full(10, analytic), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(u.numpy(),
                               np.asarray(jcontrol.mpc_1d_qp(v0, vt)),
                               rtol=0, atol=1e-9)
    assert float(control.action_to_acc(_f64(v0), _f64(vt))) == \
        pytest.approx(analytic, abs=1e-12)


def test_qp_constraint_satisfied():
    u = control.mpc_1d_qp(5.0, 37.0, device=CPU)
    dt = C.PREDICTION_T / 10
    np.testing.assert_allclose(dt * float(u.sum()), 37.0 - 5.0, atol=1e-9)


@pytest.mark.parametrize("n,m", [(12, 3), (10, 1), (6, 2)])
def test_eq_qp_equals_numpy_kkt_and_jax(n, m):
    rng = np.random.default_rng(n * 10 + m)
    a = rng.standard_normal((n, n))
    P = a @ a.T + np.eye(n)
    q = rng.standard_normal(n)
    A = rng.standard_normal((m, n))
    b = rng.standard_normal(m)
    kkt = np.block([[P, A.T], [A, np.zeros((m, m))]])
    expect = np.linalg.solve(kkt, np.concatenate([-q, b]))[:n]
    got = control.eq_qp(_f64(P), _f64(q), _f64(A), _f64(b))
    np.testing.assert_allclose(got.numpy(), expect, atol=1e-8)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jcontrol.eq_qp(P, q, A, b)),
                               atol=1e-8)
    if m == 1:  # a single constraint row may be 1-D, b a scalar
        one = control.eq_qp(_f64(P), _f64(q), _f64(A[0]), _f64(b[0]))
        np.testing.assert_allclose(one.numpy(), expect, atol=1e-8)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        control.mpc_1d_qp(0.0, 10.0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        spline.fit([0.0, 1.0], [0.0, 1.0])


@pytest.mark.parametrize("case", range(len(FITS)))
def test_fit_and_evaluate_equal_jax(case):
    xs, ys, ts, kw = FITS[case]
    got = spline.fit(_f64(xs), _f64(ys), None if ts is None else _f64(ts),
                     **kw)
    want = jspline.fit(jnp.asarray(xs, jnp.float64),
                       jnp.asarray(ys, jnp.float64),
                       None if ts is None else jnp.asarray(ts, jnp.float64),
                       **kw)
    assert got.dtype == torch.float64 and got.shape == (8,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9,
                               atol=1e-9)
    taus = np.array([-0.25, 0.0, 0.3, 0.5, 1.0, 1.5])
    for g, w in zip(spline.evaluate(got, _f64(taus)),
                    jspline.evaluate(want, jnp.asarray(taus))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9,
                                   atol=1e-9)
    # The port's fit on the JAX tests' own asserts (tests/test_spline.py).
    x0, y0, dx0, dy0 = (float(v) for v in spline.evaluate(got, 0.0))
    assert abs(x0 - xs[0]) < 1e-5 and abs(y0 - ys[0]) < 1e-5
    if "vx" in kw and "yaw" not in kw:
        assert abs(dx0 - kw["vx"]) < 1e-4 and abs(dy0 - kw["vy"]) < 1e-4
    if "yaw" in kw:
        assert abs(math.tan(kw["yaw"]) * dx0 - dy0) < 1e-4
    x, y, dx, dy = (float(v) for v in spline.evaluate(got, 1.5))
    assert x == 0.0 and y == 0.0 and dx == 0.0 and dy == 0.0


def test_fit_in_f32_from_f32_waypoints():
    c = spline.fit(torch.tensor([0.0, 10.0, 20.0]),
                   torch.tensor([0.0, 1.0, 0.0]), [0.0, 1.0, 2.0], vx=20.0,
                   vy=0.0)
    assert c.dtype == torch.float32
    want = jspline.fit(jnp.asarray([0.0, 10.0, 20.0], jnp.float32),
                       jnp.asarray([0.0, 1.0, 0.0], jnp.float32),
                       [0.0, 1.0, 2.0], vx=20.0, vy=0.0)
    assert want.dtype == jnp.float32
    np.testing.assert_allclose(c.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("case", [0, 2, 4])
def test_fit_gradient_equals_jax_grad(case):
    xs, ys, ts, kw = FITS[case]
    w = np.random.default_rng(case).standard_normal(8)
    ts_np = None if ts is None else np.asarray(ts)

    def jax_loss(xs_, ys_):
        return jnp.sum(jspline.fit(xs_, ys_, ts_np, **kw) * w)

    want = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(xs, jnp.float64),
                                              jnp.asarray(ys, jnp.float64))
    xs_t = _f64(xs).requires_grad_()
    ys_t = _f64(ys).requires_grad_()
    loss = torch.sum(spline.fit(xs_t, ys_t, None if ts is None
                                else _f64(ts), **kw) * _f64(w))
    got = torch.autograd.grad(loss, (xs_t, ys_t))
    for g, v in zip(got, want):
        assert np.abs(np.asarray(v)).max() > 0
        np.testing.assert_allclose(g.numpy(), np.asarray(v), rtol=1e-8,
                                   atol=1e-9)
    # The control law's QP is differentiable too: d u / d vt = 1 / t.
    vt = torch.tensor(30.0, dtype=torch.float64, requires_grad=True)
    P = torch.eye(10, dtype=torch.float64)
    u = control.eq_qp(P, torch.zeros(10, dtype=torch.float64),
                      torch.full((1, 10), 0.3, dtype=torch.float64),
                      vt.reshape(1))
    (g,) = torch.autograd.grad(u.sum(), vt)
    assert float(g) == pytest.approx(1.0 / 0.3, rel=1e-12)
