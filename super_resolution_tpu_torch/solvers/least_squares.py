"""Matrix-free linear-CG, nonlinear-CG and L-BFGS minimizers.

The replacement for the reference's use of ALGLIB's ``mincg`` /
``minlbfgs`` (``src/optimization/alglib_objective.cpp``). Every solver calls a
user-supplied fused cost+gradient function and does its vector algebra
(``x + t d``, dot products, norms) with plain tensor ops on the tensors' own
device. The JAX package runs each solver as one ``lax.while_loop``; here each
is a step function whose every scalar and decision is a 0-d tensor on the
device, called in a Python loop that makes the same decisions in the same
order:

- ``linear_cg``: :func:`linear_cg_step` is one iteration (one evaluation);
- ``cg`` (Polak-Ribiere+) and ``lbfgs``: :func:`wolfe_step` is one trial of
  the strong-Wolfe line search (one evaluation); the step in which the
  search ends also makes the rest of the iteration (the direction update,
  the stop tests, the next search's first trial step).

:func:`minimize` calls a step in a Python loop and reads back the stop flag
once per step (``cg`` / ``lbfgs``: with whether the trial ended the search,
and makes the rest of an iteration's end only where it did); the fused IRLS
solve (``solvers/irls.py``) replays the same
steps in CUDA graphs of a chunk of steps and reads back once per chunk. A
step taken once the solve is done is frozen: it returns the state it was
given, so a chunk may outlive the solve.

Matching the ALGLIB surface used by the reference:

- Stopping criteria (``mincgsetcond`` semantics, applied per iteration):
  ``|g| <= eps_g`` (Euclidean), ``|f_k - f_{k+1}| <= eps_f *
  max(|f_k|, |f_{k+1}|, 1)``, ``|x_{k+1} - x_k| <= eps_x``, and
  ``max_iterations`` (0 = unlimited -> capped at a large bound).
- CG: Polak-Ribiere+ with automatic restart on non-descent directions.
- L-BFGS: two-loop recursion with ``memory`` corrections (reference default
  ``num_lbfgs_hessian_corrections = 5``, ``map_solver.h:49-52``).
- Both share a strong-Wolfe bracketing + zoom line search (Nocedal & Wright
  Alg. 3.5/3.6) with fixed evaluation bounds.

The state may be a ``parallel.sharded.Sharded`` instead of a tensor: a value
spread over the shards of a device mesh, whose elementwise algebra runs shard
by shard. Four helpers are all that know: :func:`_vdot` (the one reduction,
summed over the shards), :func:`_scalar_like` (a loop constant, one per
device), :func:`_per_shard` (stacking, slot reads and writes, shard by shard)
and :func:`_host_values` (a read-back takes shard 0's copy). The loops below
are the same code either way.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

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
    "WolfeSettings",
    "WolfeState",
    "wolfe_settings",
    "wolfe_start",
    "wolfe_step",
    "wolfe_done",
    "solver_settings",
    "solver_steps",
    "blank_state",
]

METHODS = ("cg", "lbfgs", "linear_cg")
INITIAL_STEP_MODES = ("scaled", "quadratic", "quadratic_min")


def _vdot(a, b):
    """``<a, b>`` as a 0-d value where ``a`` lives; a sharded state sums its shards' dots itself."""
    if isinstance(a, torch.Tensor):
        return torch.dot(a.reshape(-1), b.reshape(-1))
    return a.vdot(b)


def _scalar_like(x, value: float):
    """A 0-d constant of ``x``'s dtype on ``x``'s device (on every device of a sharded ``x``)."""
    return x.new_full((), value)


def _per_shard(fn, *operands):
    """``fn(*operands)``; with a sharded operand, ``fn`` of each shard's locals."""
    for operand in operands:
        if hasattr(operand, "per_shard"):
            return operand.per_shard(fn, *operands)
    return fn(*operands)


def _stack(values):
    return _per_shard(lambda *v: torch.stack(v), *values)


def _cat(values):
    return _per_shard(lambda *v: torch.cat(v), *values)


def _host_values(*scalars) -> list[float]:
    """The 0-d values as host floats, in one read-back (shard 0's copy of a sharded one)."""
    return torch.stack([(s if isinstance(s, torch.Tensor) else s.local(0)).to(torch.float64)
                        for s in scalars]).tolist()


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
    c2: float = 0.4  # 0.4 for CG; 0.9 for (L-)BFGS-style directions
    max_bracket: int = 10
    max_zoom: int = 10
    expansion: float = 2.0


def _cubic_min(a, fa, dfa, b, fb, dfb):
    """Minimizer of the cubic interpolant on [a, b]; falls back to bisection.

    0-d tensors: a zero denominator gives inf/nan (-> bisection), never an error.
    """
    d1 = dfa + dfb - 3.0 * (fa - fb) / (a - b)
    arg = d1 * d1 - dfa * dfb
    safe = arg >= 0.0
    d2 = torch.sqrt(torch.where(safe, arg, 0.0)) * torch.sign(b - a)
    denom = dfb - dfa + 2.0 * d2
    t = b - (b - a) * (dfb + d2 - d1) / denom
    mid = 0.5 * (a + b)
    bad = (
        ~safe
        | ~torch.isfinite(t)
        | (t <= torch.minimum(a, b))
        | (t >= torch.maximum(a, b))
        | (torch.abs(denom) < 1e-30)
    )
    return torch.where(bad, mid, t)


# The line search's scalars, one vector of x's dtype (the JAX package's
# ``_LSState`` packed): the last bracketing trial (step, cost, slope), the
# next bracketing step, the zoom interval's ends, the best point of
# sufficient decrease so far (step, cost), the phase (0 bracketing, 1 zoom,
# 2 done), the trials made, whether a Wolfe point was found, and the
# search's own <g, d> and <g, g> at its start.
_PREV, _A_CUR, _LO, _HI, _STAR = slice(0, 3), 3, slice(4, 7), slice(7, 10), slice(10, 12)
_PHASE, _TRIALS, _FOUND, _DPHI0, _GG = 12, 13, 14, 15, 16


def _search_start(f0, dphi0, gg, initial_step):
    """The search vector before the first trial from a point of cost ``f0``."""
    zero = torch.zeros_like(f0)
    return _stack([zero, f0, dphi0, torch.clamp(initial_step, min=1e-20), zero, f0, dphi0, zero, f0, dphi0,
                   zero, f0, zero, zero, zero, dphi0, gg])


def _search_trial(value_and_grad, x, d, f0, search, g_star, config: LineSearchConfig, active=None):
    """One trial of the strong-Wolfe search along ``d`` from ``x`` (cost ``f0``):
    one evaluation at the trial step (``a_cur`` while bracketing, the cubic
    interpolant's minimizer while zooming), the bracketing (N&W Alg. 3.5) or
    zoom (Alg. 3.6) transition, and the best Armijo point tracked. Returns
    the new search vector, the gradient at its best point and whether the
    search has ended (a Wolfe point, or ``max_bracket + max_zoom`` trials).
    ``active`` (0-d bool, or ``None`` for always): where false, the search
    vector and best gradient come back as they were."""
    bracketing = search[_PHASE] == 0
    a_lo, phi_lo, dphi_lo = search[4], search[5], search[6]
    a_hi, phi_hi, dphi_hi = search[7], search[8], search[9]
    dphi0, trials = search[_DPHI0], search[_TRIALS]
    a_trial = torch.where(bracketing, search[_A_CUR], _cubic_min(a_lo, phi_lo, dphi_lo, a_hi, phi_hi, dphi_hi))
    f_a, g_a = value_and_grad(x + a_trial * d)
    f_a = f_a.to(x.dtype)
    dphi_a = _vdot(g_a, d)

    above = f_a > f0 + config.c1 * a_trial * dphi0
    armijo_fail = above | ((trials > 0) & bracketing & (f_a >= search[1]))
    curvature_ok = torch.abs(dphi_a) <= -config.c2 * dphi0
    wolfe = ~armijo_fail & curvature_ok
    # Bracketing: armijo_fail -> zoom(a_prev, a); to_zoom_lo -> zoom(a, a_prev).
    to_zoom_lo = ~armijo_fail & ~curvature_ok & (dphi_a >= 0)
    # Zooming: the trial is the new hi, else the new lo and hi may flip to the old lo.
    shrink_hi = above | (f_a >= phi_lo)
    flip = ~shrink_hi & (dphi_a * (a_hi - a_lo) >= 0)
    zooming = ~bracketing
    trial, prev, lo, hi = _stack([a_trial, f_a, dphi_a]), search[_PREV], search[_LO], search[_HI]
    lo = torch.where(bracketing & armijo_fail, prev,
                     torch.where((bracketing & to_zoom_lo) | (zooming & ~shrink_hi), trial, lo))
    hi = torch.where((bracketing & armijo_fail) | (zooming & shrink_hi), trial,
                     torch.where(bracketing & to_zoom_lo, prev, torch.where(zooming & flip, search[_LO], hi)))
    # 2 once a Wolfe point is found; bracketing goes on (0) until it brackets.
    phase = 2 * wolfe.to(x.dtype) + (~wolfe & (zooming | armijo_fail | to_zoom_lo)).to(x.dtype)
    accept = wolfe | ((f_a < search[11]) & ~above)
    new = _cat([
        torch.where(bracketing, trial, prev),
        torch.where(bracketing, a_trial * config.expansion, search[_A_CUR])[None],
        lo, hi,
        torch.where(accept, trial[0:2], search[_STAR]),
        _stack([phase, trials + 1, torch.maximum(search[_FOUND], wolfe.to(x.dtype))]),
        search[_DPHI0:],
    ])
    if active is not None:
        new = torch.where(active, new, search)
        accept = accept & active
    done = (phase == 2) | (trials + 1 >= config.max_bracket + config.max_zoom)
    return new, torch.where(accept, g_a, g_star), done


def wolfe_line_search(
    value_and_grad: Callable,
    x: torch.Tensor,
    direction: torch.Tensor,
    f0,
    g0: torch.Tensor,
    dphi0,
    initial_step,
    config: LineSearchConfig,
):
    """Strong-Wolfe line search along ``direction`` from ``x``, on its own.

    ``f0`` and ``dphi0 = <g0, direction>`` are numbers or 0-d tensors.
    Returns ``(alpha, f_new, g_new, success, evaluations)``, the first two
    as host floats. On failure returns the best Armijo-satisfying point
    seen (or the starting point, ``alpha = 0``). One evaluation and one
    read-back per trial; :func:`wolfe_step` makes the same trials inside an
    iteration of ``cg`` / ``lbfgs``.
    """
    f0 = torch.as_tensor(f0, dtype=x.dtype, device=x.device)
    dphi0 = torch.as_tensor(dphi0, dtype=x.dtype, device=x.device)
    step = torch.as_tensor(initial_step, dtype=x.dtype, device=x.device)
    search, g_star = _search_start(f0, dphi0, torch.zeros_like(f0), step), g0
    done = False
    while not done:
        search, g_star, ended = _search_trial(value_and_grad, x, direction, f0, search, g_star, config)
        done = bool(ended)
    alpha, f_new, found, trials = _host_values(search[10], search[11], search[_FOUND], search[_TRIALS])
    return alpha, f_new, g_star, bool(found), int(trials)


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


class WolfeSettings(NamedTuple):
    """The constants of a ``cg`` or ``lbfgs`` solve (``max_iterations`` already capped)."""

    method: str
    max_iterations: int
    eps_g: float
    eps_f: float
    eps_x: float
    line_search: LineSearchConfig
    memory: int                 # L-BFGS corrections; 0 for CG
    initial_step_mode: str


class WolfeState(NamedTuple):
    """What one :func:`wolfe_step` hands the next, every field on the state's
    device: the iterate, its cost and gradient, the direction of the search
    under way (already a descent direction), the gradient at the search's
    best point, the search's scalars (one vector, see ``_search_start``),
    the iterations and evaluations so far (0-d int64), whether a stop test
    has fired (0-d bool), and the L-BFGS memory (``None`` for CG): the last
    ``m`` steps ``s`` and gradient changes ``y`` as ``[m + 1, *x.shape]``
    (slot ``m`` takes the writes a step discards), their ``1 / <s, y>`` and
    the pairs stored so far (0-d int64; the newest is slot ``count - 1 mod m``)."""

    x: torch.Tensor
    f: torch.Tensor
    g: torch.Tensor
    d: torch.Tensor
    g_star: torch.Tensor
    search: torch.Tensor
    k: torch.Tensor
    evaluations: torch.Tensor
    converged: torch.Tensor
    s_memory: torch.Tensor | None = None
    y_memory: torch.Tensor | None = None
    rho: torch.Tensor | None = None
    pairs: torch.Tensor | None = None


def wolfe_settings(
    method: str,
    max_iterations: int,
    gradient_norm_threshold: float,
    cost_decrease_threshold: float,
    parameter_variation_threshold: float,
    memory: int = 5,
    initial_step_mode: str = "scaled",
    line_search: LineSearchConfig | None = None,
) -> WolfeSettings:
    """:func:`minimize`'s arguments as :func:`wolfe_step` reads them."""
    if method == "lbfgs" and memory < 1:
        raise ValueError(f"L-BFGS needs memory >= 1, got {memory}.")
    return WolfeSettings(
        method, max_iterations if max_iterations > 0 else 10_000, float(gradient_norm_threshold),
        float(cost_decrease_threshold), float(parameter_variation_threshold),
        line_search or LineSearchConfig(c2=0.4 if method == "cg" else 0.9),
        int(memory) if method == "lbfgs" else 0, initial_step_mode,
    )


def _memory(x, settings: WolfeSettings):
    """Empty L-BFGS memory for iterates like ``x``: ``(s, y, rho, pairs)``, or Nones for CG."""
    m = settings.memory
    if m == 0:
        return None, None, None, None
    slots = lambda t: t.new_zeros((m + 1,) + tuple(t.shape))  # noqa: E731
    return (_per_shard(slots, x), _per_shard(slots, x), x.new_full((m + 1,), 0.0),
            _scalar_like(x, 0.0).to(torch.int64))


def wolfe_start(value_and_grad: Callable, x0, settings: WolfeSettings) -> WolfeState:
    """The state before the first iteration: one evaluation at ``x0``, the
    steepest-descent direction, the gradient-norm test applied, and the
    first search's trial step ``1 / |g|``."""
    f, g = value_and_grad(x0)
    f = f.to(x0.dtype)
    d = -g
    gg = _vdot(g, g)
    dphi = _vdot(g, d)
    dphi = torch.where(dphi >= 0, -gg, dphi)
    gnorm = torch.sqrt(gg)
    count = _scalar_like(x0, 0.0).to(torch.int64)
    search = _search_start(f, dphi, gg, 1.0 / torch.clamp(gnorm, min=1e-12))
    return WolfeState(x0, f, g, d, g, search, count, count + 1, gnorm <= settings.eps_g,
                      *_memory(x0, settings))


def wolfe_done(state: WolfeState, settings: WolfeSettings):
    """0-d bool: a stop test has fired or the iteration cap is reached."""
    return state.converged | (state.k >= settings.max_iterations)


def _slot(memory, index):
    """``memory[index]`` for a 0-d device ``index`` (a copy)."""
    return _per_shard(lambda t, i: t.index_select(0, i.reshape(1))[0], memory, index)


def _write_slot(memory, index, value) -> None:
    """``memory[index] = value`` in place, for a 0-d device ``index``: one slot written."""
    _per_shard(lambda t, i, v: t.index_copy_(0, i.reshape(1), v.unsqueeze(0)), memory, index, value)


def _lbfgs_direction(state: WolfeState, step, y, g_new, sy, keep, m):
    """Store the pair ``(step, y)`` where ``keep`` (else into the spare
    slot), then the two-loop recursion over the valid window: ``-H g_new``,
    and the pairs now stored. The ring's order lives in device indices, so
    each slot the recursion reads is gathered once per call."""
    s_mem, y_mem, rho, pairs = state.s_memory, state.y_memory, state.rho, state.pairs
    slot = torch.where(keep, torch.remainder(pairs, m), m)
    _write_slot(s_mem, slot, step)
    _write_slot(y_mem, slot, y)
    _write_slot(rho, slot, 1.0 / torch.where(sy == 0, 1.0, sy))
    pairs = pairs + keep.to(torch.int64)
    count = torch.clamp(pairs, max=m)
    newest_first = [torch.remainder(pairs - (i + 1), m) for i in range(m)]
    s_i = [_slot(s_mem, i) for i in newest_first]
    y_i = [_slot(y_mem, i) for i in newest_first]
    rho_i = [_slot(rho, i) for i in newest_first]
    valid = [count > i for i in range(m)]
    q = g_new
    alphas = []
    for i in range(m):
        a_i = torch.where(valid[i], rho_i[i] * _vdot(s_i[i], q), 0.0)
        q = q - a_i * y_i[i]
        alphas.append(a_i)
    gamma = torch.where(valid[0], _vdot(s_i[0], y_i[0]) / torch.clamp(_vdot(y_i[0], y_i[0]), min=1e-300), 1.0)
    q = gamma * q
    for j in reversed(range(m)):
        # Both terms are 0 outside the window: no second select.
        b_j = torch.where(valid[j], rho_i[j] * _vdot(y_i[j], q), 0.0)
        q = q + (alphas[j] - b_j) * s_i[j]
    return -q, pairs


def wolfe_step(value_and_grad: Callable, state: WolfeState, settings: WolfeSettings,
               masked: bool = True) -> WolfeState:
    """One evaluation of a ``cg`` or ``lbfgs`` solve: a trial of the line
    search (``_search_trial``) and, where the search ends, the rest of the
    iteration as the JAX package's loop body makes it:

    - the step ``alpha d`` to the search's best point (``alpha = 0`` if it
      found none: the solve stalls and stops);
    - the direction: Polak-Ribiere+ ``-g + max(<g, g - g_prev> / |g_prev|^2, 0) d``
      for CG; for L-BFGS the pair ``(s, y)`` stored when ``<s, y> > 1e-10
      |s| |y|`` (one slot of the ring written) and ``-H g`` by the two-loop
      recursion, unrolled over the ``m`` slots behind scalar validity masks;
      steepest descent if that is no descent direction;
    - the ALGLIB stop tests (``g_small | f_small | x_small | stalled``);
    - the next search's first trial step: CG ``alpha <g_prev, d_prev> / <g, d>``
      (``"scaled"``, N&W eq. 3.60) or from the quadratic through the last two
      costs (``"quadratic"``, ``"quadratic_min"``), clipped to [1e-12, 1e12];
      L-BFGS ``1 / |g|`` while the memory is empty, then 1.

    Every decision is a 0-d tensor and nothing is read back, so a run of
    steps can be captured into a CUDA graph. Where the search goes on, the
    iterate, its gradient and the direction come back unchanged (selects
    and a zero step length). ``masked``: the step may be taken once
    :func:`wolfe_done` holds (a chunk of the fused solve), and is then
    frozen: it still spends its evaluation, but returns the state it was
    given with ``k`` and the evaluation count unchanged (the L-BFGS write
    goes to the spare slot). An active step computes the same values, bit
    for bit, as an unmasked one (``masked=False``: what the host loop
    computes, never stepping a done state and making the iteration's end
    only where the search ended).
    """
    active = (~state.converged & (state.k < settings.max_iterations)) if masked else None
    return _end_iteration(state, _wolfe_trial(value_and_grad, state, settings, active), active, settings)


class _Trial(NamedTuple):
    """What a trial of :func:`wolfe_step` hands the iteration's end: the
    search vector, the gradient at its best point, whether the search ended
    in this trial (``end``), the step ``alpha d`` it ended with (0 where it
    goes on), that step's norm (``None`` where no test reads it), ``<g, g>``
    and ``|g|`` at the best point, and the ALGLIB stop test of the iteration
    (``g_small | f_small | x_small | stalled``), which counts where ``end`` holds."""

    search: torch.Tensor
    g_new: torch.Tensor
    end: torch.Tensor
    step: torch.Tensor
    step_norm: torch.Tensor | None
    gg_new: torch.Tensor
    gnorm: torch.Tensor
    conv: torch.Tensor


def _wolfe_trial(value_and_grad: Callable, state: WolfeState, settings: WolfeSettings, active=None) -> _Trial:
    """The line-search trial of :func:`wolfe_step` (``end`` false where
    ``active`` is) and the stop test of the iteration it would end."""
    f = state.f
    search, g_new, ended = _search_trial(value_and_grad, state.x, state.d, f, state.search, state.g_star,
                                         settings.line_search, active)
    end = ended if active is None else ended & active
    alpha, f_new = search[10], search[11]
    step = torch.where(end, alpha, 0.0) * state.d
    step_norm = _norm(step) if settings.memory or settings.eps_x > 0.0 else None
    gg_new = _vdot(g_new, g_new)
    gnorm = torch.sqrt(gg_new)
    conv = (gnorm <= settings.eps_g) | (alpha == 0.0) | (torch.abs(f - f_new) <= settings.eps_f * torch.clamp(
        torch.maximum(torch.abs(f), torch.abs(f_new)), min=1.0))
    if step_norm is not None:
        conv = conv | (step_norm <= settings.eps_x)
    return _Trial(search, g_new, end, step, step_norm, gg_new, gnorm, conv)


def _end_iteration(state: WolfeState, trial: _Trial, active, settings: WolfeSettings) -> WolfeState:
    """The rest of :func:`wolfe_step` after its trial: the iteration's end
    where ``trial.end`` holds, else the state with the trial's search vector
    and best gradient and one more evaluation."""
    x, f, g, d, _, _, k, n_evals, converged = state[:9]
    search, g_new, end, step, step_norm, gg_new, gnorm, conv = trial
    alpha, f_new = search[10], search[11]
    dphi0, gg = search[_DPHI0], search[_GG]
    x_new = x + step
    y = g_new - g
    memory = {}
    if settings.memory:
        y_norm, sy = _norm(y), _vdot(step, y)
        keep = end & (sy > 1e-10 * step_norm * y_norm)
        d_new, pairs = _lbfgs_direction(state, step, y, g_new, sy, keep, settings.memory)
        memory = dict(s_memory=state.s_memory, y_memory=state.y_memory, rho=state.rho, pairs=pairs)
    else:
        beta = torch.clamp(_vdot(g_new, y) / torch.clamp(gg, min=1e-300), min=0.0)
        d_new = -g_new + beta * d
    # The next iteration's descent guard: restart with steepest descent.
    dphi = _vdot(g_new, d_new)
    bad_dir = dphi >= 0
    d_new = torch.where(bad_dir, -g_new, d_new)
    dphi = torch.where(bad_dir, -gg_new, dphi)

    if settings.memory:
        alpha0 = torch.where(memory["pairs"] == 0, 1.0 / torch.clamp(gnorm, min=1e-12), 1.0)
    else:
        safe_dphi = torch.where(dphi == 0, 1.0, dphi)
        alpha0 = alpha * dphi0 / safe_dphi
        if settings.initial_step_mode != "scaled":
            # N&W, just before eq. 3.60: the 1-D quadratic through the last
            # two costs and the slope; near-exact on the IRLS subproblem.
            quadratic = 2.0 * (f_new - f) / safe_dphi
            take = quadratic if settings.initial_step_mode == "quadratic" else torch.minimum(1.01 * quadratic,
                                                                                              alpha0)
            alpha0 = torch.where(quadratic > 0, take, alpha0)
        alpha0 = torch.clamp(alpha0, 1e-12, 1e12)

    search = torch.where(end, _search_start(f_new, dphi, gg_new, alpha0), search)
    ended_now = end.to(torch.int64)
    return WolfeState(
        x=x_new, f=torch.where(end, f_new, f), g=torch.where(end, g_new, g), d=torch.where(end, d_new, d),
        g_star=g_new, search=search, k=k + ended_now,
        evaluations=n_evals + (1 if active is None else active.to(torch.int64)),
        converged=converged | (conv & end), **memory,
    )


def _minimize_wolfe(value_and_grad: Callable, x0, settings: WolfeSettings, log_iterations: bool) -> MinimizeResult:
    """:func:`wolfe_step` until :func:`wolfe_done`, split where the host can
    see it: one read-back per trial brings whether its search ended, whether
    the solve is then done (the trial computes the iteration's stop test) and
    the cost ``log_iterations`` prints, and only a trial that
    ended the search makes the rest of the iteration's end. A trial that did
    not end it leaves what :func:`wolfe_step`'s zero step and selects leave,
    so the host loop keeps the fused solve's values bit for bit with fewer
    launches."""
    state = wolfe_start(value_and_grad, x0, settings)
    done, k = bool(wolfe_done(state, settings)), 0
    while not done:
        trial = _wolfe_trial(value_and_grad, state, settings)
        stop = state.converged | (trial.conv & trial.end) | (
            state.k + trial.end.to(torch.int64) >= settings.max_iterations)
        end, done, cost = _host_values(trial.end, stop, trial.search[11])  # the read-back of the trial
        done = bool(done)
        if not end:
            state = state._replace(g_star=trial.g_new, search=trial.search, evaluations=state.evaluations + 1)
            continue
        state = _end_iteration(state, trial, None, settings)
        k += 1
        if log_iterations:
            # Mirror of AlglibSolverIterationCallback (alglib_objective.cpp:165-178).
            print(f"Iteration complete ({k}). Sum of squared residuals = {cost}")
    k, evaluations, converged = _host_values(state.k, state.evaluations, state.converged)
    return MinimizeResult(x=state.x, cost=state.f, grad_norm=_norm(state.g), iterations=int(k),
                          converged=bool(converged), num_evaluations=int(evaluations))


def solver_settings(
    method: str,
    max_iterations: int,
    gradient_norm_threshold: float,
    cost_decrease_threshold: float,
    parameter_variation_threshold: float,
    linear_cg_refresh_every: int = 8,
    memory: int = 5,
    initial_step_mode: str = "scaled",
    line_search: LineSearchConfig | None = None,
):
    """The settings of ``method``'s step function, with the JAX package's checks."""
    if method not in METHODS:
        raise ValueError(f"Unknown method {method!r}; options: 'cg', 'lbfgs', 'linear_cg'")
    if initial_step_mode not in INITIAL_STEP_MODES:
        raise ValueError(
            f"Unknown initial_step_mode {initial_step_mode!r}; options: 'scaled', 'quadratic', 'quadratic_min'")
    if method == "lbfgs" and initial_step_mode != "scaled":
        raise ValueError(
            "initial_step_mode applies to CG only: L-BFGS directions are naturally scaled and always try "
            "alpha = 1 first.")
    thresholds = (gradient_norm_threshold, cost_decrease_threshold, parameter_variation_threshold)
    if method == "linear_cg":
        return linear_cg_settings(max_iterations, *thresholds, linear_cg_refresh_every)
    return wolfe_settings(method, max_iterations, *thresholds, memory, initial_step_mode, line_search)


def solver_steps(settings):
    """``(start, step, done)`` of the method ``settings`` are for."""
    if isinstance(settings, LinearCGSettings):
        return linear_cg_start, linear_cg_step, linear_cg_done
    return wolfe_start, wolfe_step, wolfe_done


def blank_state(settings, x_like: torch.Tensor):
    """A state of zeros for iterates like ``x_like``: the buffers a captured step reads and writes."""
    def scalar(kind):
        return torch.zeros((), dtype=kind, device=x_like.device)

    dtype = x_like.dtype
    if isinstance(settings, LinearCGSettings):
        return LinearCGState(
            x=torch.zeros_like(x_like), f=scalar(dtype), g=torch.zeros_like(x_like), d=torch.zeros_like(x_like),
            trial_scale=scalar(dtype), k=scalar(torch.int64), evaluations=scalar(torch.int64),
            converged=scalar(torch.bool))
    return WolfeState(
        torch.zeros_like(x_like), scalar(dtype), torch.zeros_like(x_like), torch.zeros_like(x_like),
        torch.zeros_like(x_like), _search_start(scalar(dtype), scalar(dtype), scalar(dtype), scalar(dtype)),
        scalar(torch.int64), scalar(torch.int64), scalar(torch.bool), *_memory(x_like, settings))


def minimize(
    value_and_grad: Callable,
    x0: torch.Tensor,
    method: str = "cg",
    max_iterations: int = 50,
    gradient_norm_threshold: float = 1e-6,
    cost_decrease_threshold: float = 1e-6,
    parameter_variation_threshold: float = 1e-6,
    memory: int = 5,
    log_iterations: bool = False,
    line_search: LineSearchConfig | None = None,
    initial_step_mode: str = "scaled",
    linear_cg_refresh_every: int = 8,
) -> MinimizeResult:
    """Minimize a smooth objective given its fused value+gradient function.

    ``method`` is ``"cg"`` (Polak-Ribiere+ nonlinear CG, the reference's
    default solver), ``"lbfgs"`` (``memory`` corrections), or ``"linear_cg"``
    (exact-step CG for the quadratic IRLS inner subproblem — one objective
    evaluation per iteration; see :func:`linear_cg_step`).
    ``initial_step_mode`` (CG only) picks the first trial step of each line
    search after the first. The solve runs on ``x0``'s device in ``x0``'s
    dtype.
    """
    settings = solver_settings(method, max_iterations, gradient_norm_threshold, cost_decrease_threshold,
                               parameter_variation_threshold, linear_cg_refresh_every, memory, initial_step_mode,
                               line_search)
    if method == "linear_cg":
        return _minimize_linear_cg(value_and_grad, x0, settings, log_iterations)
    return _minimize_wolfe(value_and_grad, x0, settings, log_iterations)
