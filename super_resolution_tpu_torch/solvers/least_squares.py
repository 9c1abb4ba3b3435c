"""Matrix-free linear-CG and nonlinear-CG minimizers.

The replacement for the reference's use of ALGLIB's ``mincg``
(``src/optimization/alglib_objective.cpp``). Both solvers call a
user-supplied fused cost+gradient function and do their vector algebra
(``x + t d``, dot products, norms) with plain tensor ops on the tensors' own
device. The JAX package runs each solver as one ``lax.while_loop``; here the
loop is a Python loop that makes the same decisions in the same order:

- ``linear_cg`` is one step function, :func:`linear_cg_step`, whose every
  scalar and decision (the iteration count and the stop flags included) is
  a 0-d tensor on the device; :func:`minimize` calls it in a Python loop and
  reads back the stop flag once per iteration, and the fused IRLS solve
  (``solvers/irls.py``) replays the same step in CUDA graphs of a chunk of
  iterations and reads back once per chunk;
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

The state may be a ``parallel.sharded.Sharded`` instead of a tensor: a value
spread over the shards of a device mesh, whose elementwise algebra runs shard
by shard. Three helpers are all that know: :func:`_vdot` (the one reduction,
summed over the shards), :func:`_scalar_like` (a loop constant, one per
device) and :func:`_host_values` (a read-back takes shard 0's copy). The
loops below are the same code either way.

L-BFGS is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

__all__ = [
    "minimize",
    "MinimizeResult",
    "LineSearchConfig",
    "wolfe_line_search",
    "LinearCGSettings",
    "LinearCGState",
    "linear_cg_settings",
    "linear_cg_start",
    "linear_cg_step",
    "linear_cg_done",
]


def _vdot(a, b):
    """``<a, b>`` as a 0-d value where ``a`` lives; a sharded state sums its shards' dots itself."""
    if isinstance(a, torch.Tensor):
        return torch.dot(a.reshape(-1), b.reshape(-1))
    return a.vdot(b)


def _scalar_like(x, value: float):
    """A 0-d constant of ``x``'s dtype on ``x``'s device (on every device of a sharded ``x``)."""
    return x.new_full((), value)


def _host_values(*scalars) -> list[float]:
    """The 0-d values as host floats, in one read-back (shard 0's copy of a sharded one)."""
    return torch.stack([s if isinstance(s, torch.Tensor) else s.local(0) for s in scalars]).tolist()


def _norm(a):
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
        f_v, dphi_v = _host_values(f.to(g.dtype), _vdot(g, direction))
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


class LinearCGSettings(NamedTuple):
    """The constants of a linear-CG solve (``max_iterations`` already capped)."""

    max_iterations: int
    eps_g: float
    eps_f: float
    eps_x: float
    refresh_every: int


class LinearCGState(NamedTuple):
    """What one linear-CG iteration hands the next, every field on the state's
    device: the estimate, its (extrapolated) cost and gradient, the search
    direction, the next iteration's trial scale (``1 / |g|`` before the
    first, then the last step length clamped to ``[1e-12, 1e12]``), the
    iterations and objective evaluations so far (0-d int64) and whether a
    stop test has fired (0-d bool)."""

    x: torch.Tensor
    f: torch.Tensor
    g: torch.Tensor
    d: torch.Tensor
    trial_scale: torch.Tensor
    k: torch.Tensor
    evaluations: torch.Tensor
    converged: torch.Tensor


def linear_cg_settings(
    max_iterations: int,
    gradient_norm_threshold: float,
    cost_decrease_threshold: float,
    parameter_variation_threshold: float,
    refresh_every: int,
) -> LinearCGSettings:
    """:func:`minimize`'s arguments as the linear-CG step reads them."""
    return LinearCGSettings(
        max_iterations if max_iterations > 0 else 10_000,  # "0 = unlimited" with a safety bound
        float(gradient_norm_threshold), float(cost_decrease_threshold),
        float(parameter_variation_threshold), max(1, int(refresh_every)),
    )


def linear_cg_start(value_and_grad: Callable, x0, settings: LinearCGSettings) -> LinearCGState:
    """The state before the first iteration: one evaluation at ``x0``, the
    steepest-descent direction, the gradient-norm test already applied, and
    the first iteration's trial scale ``1 / |g|``."""
    f, g = value_and_grad(x0)
    norm = torch.sqrt(_vdot(g, g))
    count = _scalar_like(x0, 0.0).to(torch.int64)
    return LinearCGState(x=x0, f=f.to(x0.dtype), g=g, d=-g, trial_scale=1.0 / torch.clamp(norm, min=1e-12),
                         k=count, evaluations=count + 1, converged=norm <= settings.eps_g)


def linear_cg_done(state: LinearCGState, settings: LinearCGSettings):
    """0-d bool: a stop test has fired or the iteration cap is reached."""
    return state.converged | (state.k >= settings.max_iterations)


def linear_cg_step(value_and_grad: Callable, state: LinearCGState, settings: LinearCGSettings,
                   masked: bool = True) -> LinearCGState:
    """One exact-step CG iteration for the (piecewise-)quadratic IRLS inner subproblem.

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

    Every decision is a 0-d tensor on the state's device and nothing is read
    back, so a run of steps can be captured into a CUDA graph. ``masked``:
    the step may be taken once :func:`linear_cg_done` holds (a chunk of the
    fused solve), and is then FROZEN: it still spends its evaluation, but
    its step length, blend and the gradient's share of the new direction are
    0 (the old direction's 1), so it returns the state it was given with
    ``k`` and the evaluation count unchanged. The mask lives in those
    scalars, not in full-array selects, and an active step computes the same
    values, bit for bit, as an unmasked one (``masked=False``: the host loop,
    which never steps a done state). The gradient-norm and step-size checks
    are left out when their thresholds are 0.
    """
    x, f, g, d, t, k, n_evals, converged = state
    dtype = x.dtype
    tiny = 1e-300 if dtype == torch.float64 else 1e-30
    active = (~converged & (k < settings.max_iterations)) if masked else None

    def gate(flag):
        return flag if active is None else flag & active

    # Second-order scalars off the carried arrays: <g,d> and <g,g> (the
    # latter serves the descent restart AND the PR+ denominator).
    dphi = _vdot(g, d)
    gg = _vdot(g, g)
    # Restart with steepest descent if d is not a descent direction.
    bad_dir = gate(dphi >= 0)
    d = torch.where(bad_dir, -g, d)
    dphi = torch.where(bad_dir, -gg, dphi)

    # Trial scale t for the secant: the previous accepted step is the right
    # order of magnitude (keeps the gradient difference well above
    # rounding); 1/|g| (linear_cg_start) bootstraps iteration 0.
    f_t, g_t = value_and_grad(x + t * d)
    f_t = f_t.to(dtype)
    dg = g_t - g                       # = t * H d for quadratics
    dhd = _vdot(d, dg) / t

    pos = dhd > tiny
    alpha_exact = -dphi / torch.where(pos, dhd, 1.0)
    # Drift refresh: every refresh_every-th iteration accept the trial
    # point outright. Nonpositive curvature along d (sign-boundary
    # crossings / rounding on this convex objective) also takes the trial
    # when it decreased f, else stalls.
    k_next = k + 1
    refresh_due = torch.remainder(k_next, settings.refresh_every) == 0
    took_trial = gate(((~pos) & (f_t < f)) | refresh_due)
    alpha = torch.where(took_trial, t, torch.where(gate(pos), alpha_exact, 0.0))

    # SCALAR blend covers every case with no full-array selects:
    # g_new = g + c*dg is the affine extrapolation for c = alpha/t and
    # EXACTLY g_t for c = 1 (the accepted trial).
    c = torch.where(took_trial, 1.0, alpha / t)
    x_new = x + alpha * d
    g_new = g + c * dg
    f_lin = f + alpha * dphi + 0.5 * alpha * alpha * dhd
    f_new = torch.where(took_trial, f_t, f_lin if active is None else torch.where(active, f_lin, f))

    # Polak-Ribiere+: g_new - g = c*dg, so the numerator reuses dg.
    beta = c * _vdot(g_new, dg) / torch.clamp(gg, min=tiny)
    beta = torch.clamp(beta, min=0.0)
    if active is None:
        d_new = -g_new + beta * d
    else:
        d_new = -active.to(dtype) * g_new + torch.where(active, beta, 1.0) * d

    stalled = alpha == 0.0
    f_small = torch.abs(f - f_new) <= settings.eps_f * torch.clamp(
        torch.maximum(torch.abs(f), torch.abs(f_new)), min=1.0
    )
    conv = f_small | stalled
    if settings.eps_g > 0.0:
        conv = conv | (_norm(g_new) <= settings.eps_g)
    if settings.eps_x > 0.0:
        conv = conv | (torch.abs(alpha) * _norm(d) <= settings.eps_x)

    next_scale = torch.clamp(torch.abs(alpha), 1e-12, 1e12)
    if active is None:
        return LinearCGState(x=x_new, f=f_new, g=g_new, d=d_new, trial_scale=next_scale, k=k_next,
                             evaluations=n_evals + 1, converged=conv)
    taken = active.to(torch.int64)
    return LinearCGState(
        x=x_new, f=f_new, g=g_new, d=d_new, trial_scale=torch.where(active, next_scale, t),
        k=k + taken, evaluations=n_evals + taken, converged=converged | (conv & active),
    )


def _minimize_linear_cg(
    value_and_grad: Callable,
    x0: torch.Tensor,
    settings: LinearCGSettings,
    log_iterations: bool,
) -> MinimizeResult:
    """:func:`linear_cg_step` until :func:`linear_cg_done`, reading back the
    stop flag once per iteration and counting the iterations on the host as
    well (the fused IRLS solve replays the same steps in chunks and reads
    back once per chunk, ``solvers/irls.py``)."""
    state = linear_cg_start(value_and_grad, x0, settings)
    k = 0
    converged = bool(state.converged)
    while k < settings.max_iterations and not converged:
        state = linear_cg_step(value_and_grad, state, settings, masked=False)
        k += 1
        if log_iterations:
            print(f"Iteration complete ({k}). Sum of squared residuals = {float(state.f)}")
        converged = bool(state.converged)  # the one host readback of the iteration

    return MinimizeResult(
        x=state.x, cost=state.f, grad_norm=_norm(state.g), iterations=k,
        converged=converged, num_evaluations=k + 1,
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
    f, gnorm0 = _host_values(f_t.to(dtype), _norm(g))
    x = x0
    d = -g
    alpha_prev = 0.0
    dphi_prev = 0.0
    converged = gnorm0 <= eps_g
    k = 0
    n_evals = 1

    while k < max_iterations and not converged:
        dphi, gg = _host_values(_vdot(g, d), _vdot(g, g))
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
        pr_num, gnorm_new, step_norm = _host_values(_vdot(g_new, y), _norm(g_new), _norm(step))
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
        cost=_scalar_like(x0, f),
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
    if method == "linear_cg":
        settings = linear_cg_settings(max_iterations, gradient_norm_threshold, cost_decrease_threshold,
                                      parameter_variation_threshold, linear_cg_refresh_every)
        return _minimize_linear_cg(value_and_grad, x0, settings, log_iterations)
    if max_iterations <= 0:
        max_iterations = 10_000  # "0 = unlimited" with a safety bound
    eps_g = float(gradient_norm_threshold)
    eps_f = float(cost_decrease_threshold)
    eps_x = float(parameter_variation_threshold)
    return _minimize_cg(
        value_and_grad, x0, max_iterations, eps_g, eps_f, eps_x, log_iterations,
        line_search or LineSearchConfig(c2=0.4),
    )
