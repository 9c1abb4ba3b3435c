"""Matrix-free linear-CG and nonlinear-CG minimizers.

The replacement for the reference's use of ALGLIB's ``mincg``
(``src/optimization/alglib_objective.cpp``). Both solvers call a
user-supplied fused cost+gradient function and do their vector algebra
(``x + t d``, dot products, norms) with plain tensor ops on the tensors' own
device. The JAX package runs each solver as one ``lax.while_loop``; here the
loop is a Python loop that makes the same decisions in the same order:

- ``linear_cg`` keeps every scalar as a 0-d tensor on the device and reads
  back one boolean (``converged``) per iteration;
- ``cg`` (Polak-Ribiere+ with a strong-Wolfe line search) reads the line
  search's two scalars back per evaluation and runs its state machine in
  float64 on the host.

Matching the ALGLIB surface used by the reference:

- Stopping criteria (``mincgsetcond`` semantics, applied per iteration):
  ``|g| <= eps_g`` (Euclidean), ``|f_k - f_{k+1}| <= eps_f *
  max(|f_k|, |f_{k+1}|, 1)``, ``|x_{k+1} - x_k| <= eps_x``, and
  ``max_iterations`` (0 = unlimited -> capped at a large bound).
- CG: Polak-Ribiere+ with automatic restart on non-descent directions, and
  a strong-Wolfe bracketing + zoom line search (Nocedal & Wright
  Alg. 3.5/3.6) with fixed evaluation bounds.

L-BFGS is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

__all__ = ["minimize", "MinimizeResult", "LineSearchConfig", "wolfe_line_search"]


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _norm(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(_vdot(a, a))


class MinimizeResult(NamedTuple):
    x: torch.Tensor
    cost: torch.Tensor          # 0-d tensor on x's device
    grad_norm: torch.Tensor     # 0-d tensor on x's device
    iterations: int
    converged: bool
    # Total objective (cost+grad) evaluations, incl. line-search trials and
    # the initial one — the real unit of work (each is one fused kernel pass).
    num_evaluations: int = 0


@dataclasses.dataclass(frozen=True)
class LineSearchConfig:
    c1: float = 1e-4
    c2: float = 0.4  # 0.4 for CG
    max_bracket: int = 10
    max_zoom: int = 10
    expansion: float = 2.0


def _cubic_min(a, fa, dfa, b, fb, dfb):
    """Minimizer of the cubic interpolant on [a, b]; falls back to bisection.

    float64 numpy scalars, so a zero denominator gives inf/nan (-> bisection)
    instead of raising.
    """
    with np.errstate(all="ignore"):
        d1 = dfa + dfb - 3.0 * (fa - fb) / (a - b)
        arg = d1 * d1 - dfa * dfb
        safe = arg >= 0.0
        d2 = np.sqrt(arg if safe else np.float64(0.0)) * np.sign(b - a)
        denom = dfb - dfa + 2.0 * d2
        t = b - (b - a) * (dfb + d2 - d1) / denom
        mid = 0.5 * (a + b)
        bad = (
            (not safe)
            or (not np.isfinite(t))
            or (t <= min(a, b))
            or (t >= max(a, b))
            or (abs(denom) < 1e-30)
        )
    return mid if bad else t


def wolfe_line_search(
    value_and_grad: Callable,
    x: torch.Tensor,
    direction: torch.Tensor,
    f0: float,
    g0: torch.Tensor,
    dphi0: float,
    initial_step: float,
    config: LineSearchConfig,
):
    """Strong-Wolfe line search along ``direction`` from ``x``.

    ``f0`` and ``dphi0 = <g0, direction>`` are host floats. Returns
    ``(alpha, f_new, g_new, success, evaluations)`` with ``alpha`` and
    ``f_new`` as host floats. On failure returns the best
    Armijo-satisfying point seen (or the starting point, ``alpha = 0``).
    One objective evaluation and one host readback per trial.
    """
    f64 = np.float64
    f0, dphi0 = f64(f0), f64(dphi0)
    c1, c2 = f64(config.c1), f64(config.c2)

    def phi(a):
        f, g = value_and_grad(x + float(a) * direction)
        f_v, dphi_v = torch.stack([f.to(g.dtype), _vdot(g, direction)]).tolist()
        return f64(f_v), g, f64(dphi_v)

    max_iters = config.max_bracket + config.max_zoom
    zero = f64(0.0)
    phase, it = 0, 0  # phase 0 = bracketing, 1 = zoom, 2 = done
    a_prev, phi_prev, dphi_prev = zero, f0, dphi0
    a_cur = max(f64(initial_step), f64(1e-20))
    a_lo, phi_lo, dphi_lo = zero, f0, dphi0
    a_hi, phi_hi, dphi_hi = zero, f0, dphi0
    a_star, phi_star, g_star = zero, f0, g0
    found = False

    while phase < 2 and it < max_iters:
        if phase == 0:
            a_trial = a_cur
        else:
            a_trial = _cubic_min(a_lo, phi_lo, dphi_lo, a_hi, phi_hi, dphi_hi)
        phi_a, g_a, dphi_a = phi(a_trial)

        sufficient = phi_a <= f0 + c1 * a_trial * dphi0
        armijo_fail = bool(phi_a > f0 + c1 * a_trial * dphi0) or (
            it > 0 and phase == 0 and bool(phi_a >= phi_prev)
        )
        curvature_ok = bool(abs(dphi_a) <= -c2 * dphi0)
        wolfe = (not armijo_fail) and curvature_ok

        if phase == 0:
            # Bracketing transitions (N&W Alg 3.5).
            to_zoom_hi = armijo_fail                                         # zoom(a_prev, a)
            to_zoom_lo = (not armijo_fail) and (not curvature_ok) and bool(dphi_a >= 0)  # zoom(a, a_prev)
            if to_zoom_hi:
                a_lo, phi_lo, dphi_lo = a_prev, phi_prev, dphi_prev
                a_hi, phi_hi, dphi_hi = a_trial, phi_a, dphi_a
            elif to_zoom_lo:
                a_lo, phi_lo, dphi_lo = a_trial, phi_a, dphi_a
                a_hi, phi_hi, dphi_hi = a_prev, phi_prev, dphi_prev
            phase = 2 if wolfe else (1 if (to_zoom_hi or to_zoom_lo) else 0)
            a_prev, phi_prev, dphi_prev = a_trial, phi_a, dphi_a
            a_cur = a_trial * config.expansion
        else:
            # Zoom transitions (N&W Alg 3.6).
            shrink_hi = bool(phi_a > f0 + c1 * a_trial * dphi0) or bool(phi_a >= phi_lo)
            if shrink_hi:
                a_hi, phi_hi, dphi_hi = a_trial, phi_a, dphi_a
            else:
                # a_trial becomes the new lo; hi may flip to the old lo.
                if bool(dphi_a * (a_hi - a_lo) >= 0):
                    a_hi, phi_hi, dphi_hi = a_lo, phi_lo, dphi_lo
                a_lo, phi_lo, dphi_lo = a_trial, phi_a, dphi_a
            phase = 2 if wolfe else 1

        # Track the best point satisfying at least sufficient decrease.
        better = bool(phi_a < phi_star) and bool(sufficient)
        if wolfe or better:
            a_star, phi_star, g_star = a_trial, phi_a, g_a
        found = found or wolfe
        it += 1

    return float(a_star), float(phi_star), g_star, found, it


def _minimize_linear_cg(
    value_and_grad: Callable,
    x0: torch.Tensor,
    max_iterations: int,
    eps_g: float,
    eps_f: float,
    eps_x: float,
    refresh_every: int,
    log_iterations: bool,
) -> MinimizeResult:
    """Exact-step CG for the (piecewise-)quadratic IRLS inner subproblem.

    With the IRLS weights fixed, the MAP inner objective is quadratic in
    ``x`` except on the measure-zero sign-crossing set of the TV/BTV forward
    differences. Per iteration this method spends exactly ONE evaluation,
    at the trial point ``x + t d``:

        H d      = (g(x + t d) - g(x)) / t        (exact for quadratics)
        alpha    = -g.d / d.H d                   (the exact minimizing step)
        g_{k+1}  = g + alpha H d                  (gradient is affine)
        f_{k+1}  = f + alpha g.d + alpha^2/2 d.Hd

    Every ``refresh_every``-th iteration instead ACCEPTS the trial point
    (``alpha = t``, taking the trial's TRUE ``(f, g)``), which bounds both
    the floating-point drift of the extrapolation and the model error from
    sign-boundary crossings at zero extra cost. The acceptance is
    UNCONDITIONAL: gating it on ``f_t < f`` deadlocks once the extrapolated
    ``f`` drifts below the objective's true floor (every refresh then rejects
    and ``f`` free-falls). A rare ascent trial costs one iteration; PR+
    recovers. Directions update with Polak-Ribiere+ exactly as the ``"cg"``
    method.

    Scalars stay 0-d tensors on ``x0``'s device; the loop reads back only
    ``converged``, once per iteration. The gradient-norm and step-size checks
    are left out of the loop when their thresholds are 0.
    """
    dtype = x0.dtype
    f, g = value_and_grad(x0)
    f = f.to(dtype)
    tiny = 1e-300 if dtype == torch.float64 else 1e-30
    check_g = eps_g > 0.0
    check_x = eps_x > 0.0

    x = x0
    d = -g
    alpha_prev = torch.zeros((), dtype=dtype, device=x0.device)
    one = torch.ones((), dtype=dtype, device=x0.device)
    zero = torch.zeros((), dtype=dtype, device=x0.device)
    converged = bool(_norm(g) <= eps_g)
    k = 0
    n_evals = 1

    while k < max_iterations and not converged:
        # Second-order scalars off the carried arrays: <g,d> and <g,g> (the
        # latter serves the descent restart, the k=0 bootstrap scale, AND the
        # PR+ denominator).
        dphi = _vdot(g, d)
        gg = _vdot(g, g)
        # Restart with steepest descent if d is not a descent direction.
        bad_dir = dphi >= 0
        d = torch.where(bad_dir, -g, d)
        dphi = torch.where(bad_dir, -gg, dphi)

        # Trial scale for the secant: the previous accepted step is the right
        # order of magnitude (keeps the gradient difference well above
        # rounding); 1/|g| bootstraps iteration 0.
        if k == 0:
            t = 1.0 / torch.clamp(torch.sqrt(gg), min=1e-12)
        else:
            t = torch.clamp(alpha_prev, 1e-12, 1e12)
        f_t, g_t = value_and_grad(x + t * d)
        f_t = f_t.to(dtype)
        dg = g_t - g                       # = t * H d for quadratics
        dhd = _vdot(d, dg) / t

        pos = dhd > tiny
        alpha_exact = -dphi / torch.where(pos, dhd, one)
        # Drift refresh: every refresh_every-th iteration accept the trial
        # point outright. Nonpositive curvature along d (sign-boundary
        # crossings / rounding on this convex objective) also takes the trial
        # when it decreased f, else stalls.
        refresh_due = (k + 1) % refresh_every == 0
        took_trial = (~pos) & (f_t < f)
        if refresh_due:
            took_trial = torch.ones_like(took_trial)
        alpha = torch.where(took_trial, t, torch.where(pos, alpha_exact, zero))

        # SCALAR blend covers every case with no full-array selects:
        # g_new = g + c*dg is the affine extrapolation for c = alpha/t and
        # EXACTLY g_t for c = 1 (the accepted trial).
        c = torch.where(took_trial, one, alpha / t)
        x_new = x + alpha * d
        g_new = g + c * dg
        f_lin = f + alpha * dphi + 0.5 * alpha * alpha * dhd
        f_new = torch.where(took_trial, f_t, f_lin)

        # Polak-Ribiere+: g_new - g = c*dg, so the numerator reuses dg.
        beta = c * _vdot(g_new, dg) / torch.clamp(gg, min=tiny)
        beta = torch.clamp(beta, min=0.0)
        d_new = -g_new + beta * d

        stalled = alpha == 0.0
        f_small = torch.abs(f - f_new) <= eps_f * torch.clamp(
            torch.maximum(torch.abs(f), torch.abs(f_new)), min=1.0
        )
        conv = f_small | stalled
        if check_g:
            conv = conv | (_norm(g_new) <= eps_g)
        if check_x:
            conv = conv | (torch.abs(alpha) * _norm(d) <= eps_x)

        k += 1
        n_evals += 1
        x, f, g, d = x_new, f_new, g_new, d_new
        alpha_prev = torch.abs(alpha)
        if log_iterations:
            print(f"Iteration complete ({k}). Sum of squared residuals = {float(f)}")
        converged = bool(conv)  # the one host readback of the iteration

    return MinimizeResult(
        x=x, cost=f, grad_norm=_norm(g), iterations=k,
        converged=converged, num_evaluations=n_evals,
    )


def _minimize_cg(
    value_and_grad: Callable,
    x0: torch.Tensor,
    max_iterations: int,
    eps_g: float,
    eps_f: float,
    eps_x: float,
    log_iterations: bool,
    ls_config: LineSearchConfig,
) -> MinimizeResult:
    """Polak-Ribiere+ nonlinear CG with a strong-Wolfe line search."""
    dtype = x0.dtype
    f_t, g = value_and_grad(x0)
    f, gnorm0 = torch.stack([f_t.to(dtype), _norm(g)]).tolist()
    x = x0
    d = -g
    alpha_prev = 0.0
    dphi_prev = 0.0
    converged = gnorm0 <= eps_g
    k = 0
    n_evals = 1

    while k < max_iterations and not converged:
        dphi, gg = torch.stack([_vdot(g, d), _vdot(g, g)]).tolist()
        # Guard: if d is not a descent direction, restart with steepest descent.
        if dphi >= 0:
            d = -g
            dphi = -gg
        # Initial step: previous-step scaling (N&W eq. 3.60) or 1/|g| at k=0.
        gnorm = float(np.sqrt(np.float64(gg)))
        if k == 0:
            alpha0 = 1.0 / max(gnorm, 1e-12)
        else:
            safe_dphi = 1.0 if dphi == 0 else dphi
            alpha0 = float(np.clip(np.float64(alpha_prev) * dphi_prev / safe_dphi, 1e-12, 1e12))

        alpha, f_new, g_new, _, ls_evals = wolfe_line_search(
            value_and_grad, x, d, f, g, dphi, alpha0, ls_config
        )
        # If the line search found nothing acceptable, stay put (alpha = 0)
        # and mark converged to avoid spinning.
        stalled = alpha == 0.0
        step = alpha * d
        x_new = x + step

        # Polak-Ribiere+ with restart.
        y = g_new - g
        pr_num, gnorm_new, step_norm = torch.stack(
            [_vdot(g_new, y), _norm(g_new), _norm(step)]
        ).tolist()
        beta = max(pr_num / max(gg, 1e-300), 0.0)
        d_new = -g_new + beta * d

        # ALGLIB-style stopping conditions.
        g_small = gnorm_new <= eps_g
        f_small = abs(f - f_new) <= eps_f * max(abs(f), abs(f_new), 1.0)
        x_small = step_norm <= eps_x
        converged = g_small or f_small or x_small or stalled

        k += 1
        n_evals += ls_evals
        x, f, g, d = x_new, f_new, g_new, d_new
        alpha_prev, dphi_prev = alpha, dphi
        if log_iterations:
            # Mirror of AlglibSolverIterationCallback (alglib_objective.cpp:165-178).
            print(f"Iteration complete ({k}). Sum of squared residuals = {f}")

    return MinimizeResult(
        x=x,
        cost=torch.as_tensor(f, dtype=dtype, device=x0.device),
        grad_norm=_norm(g),
        iterations=k,
        converged=bool(converged),
        num_evaluations=n_evals,
    )


def minimize(
    value_and_grad: Callable,
    x0: torch.Tensor,
    method: str = "cg",
    max_iterations: int = 50,
    gradient_norm_threshold: float = 1e-6,
    cost_decrease_threshold: float = 1e-6,
    parameter_variation_threshold: float = 1e-6,
    log_iterations: bool = False,
    line_search: LineSearchConfig | None = None,
    linear_cg_refresh_every: int = 8,
) -> MinimizeResult:
    """Minimize a smooth objective given its fused value+gradient function.

    ``method`` is ``"cg"`` (Polak-Ribiere+ nonlinear CG, the reference's
    default solver) or ``"linear_cg"`` (exact-step CG for the quadratic IRLS
    inner subproblem — one objective evaluation per iteration; see
    :func:`_minimize_linear_cg`). ``"lbfgs"`` is not ported yet. The solve
    runs on ``x0``'s device in ``x0``'s dtype.
    """
    if method not in ("cg", "lbfgs", "linear_cg"):
        raise ValueError(
            f"Unknown method {method!r}; options: 'cg', 'lbfgs', 'linear_cg'"
        )
    if method == "lbfgs":
        raise NotImplementedError("method 'lbfgs' is not ported yet; use 'cg' or 'linear_cg'.")
    if max_iterations <= 0:
        max_iterations = 10_000  # "0 = unlimited" with a safety bound
    eps_g = float(gradient_norm_threshold)
    eps_f = float(cost_decrease_threshold)
    eps_x = float(parameter_variation_threshold)
    if method == "linear_cg":
        return _minimize_linear_cg(
            value_and_grad, x0, max_iterations, eps_g, eps_f, eps_x,
            max(1, linear_cg_refresh_every), log_iterations,
        )
    return _minimize_cg(
        value_and_grad, x0, max_iterations, eps_g, eps_f, eps_x, log_iterations,
        line_search or LineSearchConfig(c2=0.4),
    )
