"""Per-solve runtime options — the reference's PETSc options-string escape
hatch (`lib/Runtime/PETSc/NeptunePETScRuntime.cpp:139-150, 284-298, 1465-1472`
lets callers inject e.g. "-ksp_gmres_restart 50 -ksp_atol 1e-12" per solver
object). The TPU build's equivalent: a typed options dict (or a PETSc-style
string) attached to `solve_linear` / `solve_nonlinear` / `time_advance` IR
ops, validated against a per-solver-class whitelist and threaded into the
Krylov / Newton solvers, with env-var defaults
(`NEPTUNE_KSP_OPTIONS` / `NEPTUNE_SNES_OPTIONS`) playing the role of PETSc's
global options database.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional, Union


def _as_bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)):
        return bool(v)
    s = str(v).strip().lower()
    if s in ("1", "true", "yes", "on"):
        return True
    if s in ("0", "false", "no", "off"):
        return False
    raise ValueError(f"not a boolean: {v!r}")


# key -> coercion. Linear (KSP-class) options.
LINEAR_OPTION_KEYS = {
    "restart": int,  # GMRES restart length (PETSc -ksp_gmres_restart)
    "atol": float,  # absolute residual tolerance (-ksp_atol)
    "divtol": float,  # divergence tolerance, relative to ||b|| (-ksp_divtol)
    "lam_min": float,  # Chebyshev spectrum lower bound (-ksp_chebyshev_eigenvalues)
    "lam_max": float,  # Chebyshev spectrum upper bound
    "check_every": int,  # Chebyshev residual-test period (0 = reduction-free)
    # preconditioner options (consumed by the precond builder, not the
    # Krylov loop — the analog of PETSc's -pc_* namespace):
    "omega": float,  # SSOR relaxation weight (-pc_sor_omega)
    "mg_levels": int,  # total geometric-MG levels incl. finest (-pc_mg_levels)
    "mg_smoother": str,  # "jacobi" | "cheb" | "symgs" (-mg_levels_ksp_type analog)
    # "cell" | "vertex": halve the grid (mean transfers, each level damped
    # by 1/4), or halve the interior keeping the ring (HPCG's hierarchy:
    # injection, the operator unscaled)
    "mg_coarsen": str,
    "mg_coarse_sweeps": int,  # smoothing sweeps on the coarsest level (-mg_coarse_ksp_max_it)
}

# options consumed by the preconditioner construction; split off the dict
# handed to the Krylov loop (PETSc's -pc_* vs -ksp_* namespaces)
MG_OPTION_KEYS = ("mg_levels", "mg_smoother", "mg_coarsen", "mg_coarse_sweeps")
PRECOND_OPTION_KEYS = ("omega",) + MG_OPTION_KEYS


def split_precond_options(opts: dict, precond: str) -> dict:
    """Pop the -pc_*-namespace options out of `opts`, validating that each
    one applies to the selected preconditioner."""
    pc = {k: opts.pop(k) for k in PRECOND_OPTION_KEYS if k in opts}
    if "omega" in pc and precond not in ("ssor", "ssor_dense"):
        raise ValueError(
            "option 'omega' only applies to precond='ssor'/'ssor_dense' "
            f"(got precond={precond!r})"
        )
    for k in MG_OPTION_KEYS:
        if k in pc and precond != "mg":
            raise ValueError(
                f"option {k!r} only applies to precond='mg' "
                f"(got precond={precond!r})"
            )
    if pc.get("mg_smoother") not in (None, "jacobi", "cheb", "symgs"):
        raise ValueError(
            "mg_smoother must be 'jacobi', 'cheb' or 'symgs' "
            f"(got {pc['mg_smoother']!r})"
        )
    if pc.get("mg_coarsen") not in (None, "cell", "vertex"):
        raise ValueError(f"mg_coarsen must be 'cell' or 'vertex' (got {pc['mg_coarsen']!r})")
    return pc

# Nonlinear (SNES-class) options.
NONLINEAR_OPTION_KEYS = {
    "atol": float,  # absolute ||F|| tolerance (-snes_atol)
    "restart": int,  # inner-GMRES restart (-snes_ksp_gmres_restart)
    "max_step": float,  # Newton step-length cap (-snes_linesearch_maxstep)
    "line_search": _as_bool,  # enable/disable backtracking (-snes_linesearch_type)
    "max_backtracks": int,  # backtracking iterations (-snes_linesearch_max_it)
    "damping": float,  # Picard damping factor (-snes_linesearch_damping)
}


def _parse_string(s: str) -> dict:
    """Parse "restart=50 atol=1e-12" / "restart=50,atol=1e-12" /
    PETSc-style "-restart 50 -atol 1e-12" into a raw dict."""
    toks = [t for t in s.replace(",", " ").split() if t]
    out: dict = {}
    i = 0
    while i < len(toks):
        t = toks[i]
        if "=" in t:
            k, v = t.split("=", 1)
            out[k.strip().lstrip("-")] = v.strip()
            i += 1
        elif t.startswith("-"):
            if i + 1 >= len(toks) or toks[i + 1].startswith("-") and not _is_number(toks[i + 1]):
                # flag with no value: treat as boolean true
                out[t.lstrip("-")] = True
                i += 1
            else:
                out[t.lstrip("-")] = toks[i + 1]
                i += 2
        else:
            raise ValueError(
                f"cannot parse solver option token {t!r} (use key=value or "
                f"-key value)"
            )
    return out


def _is_number(s: str) -> bool:
    try:
        float(s)
        return True
    except (TypeError, ValueError):
        return False


def parse_options(
    opts: Union[None, str, Mapping],
    keys: Mapping,
    *,
    where: str = "solve",
) -> dict:
    """Normalize user options into a validated {key: typed value} dict."""
    if opts is None:
        return {}
    raw = _parse_string(opts) if isinstance(opts, str) else dict(opts)
    out = {}
    for k, v in raw.items():
        if k not in keys:
            raise ValueError(
                f"{where}: unknown option {k!r}; valid options: "
                f"{sorted(keys)}"
            )
        try:
            out[k] = keys[k](v)
        except (TypeError, ValueError) as e:
            raise ValueError(f"{where}: bad value for option {k!r}: {v!r} ({e})")
    return out


def env_defaults(kind: str) -> dict:
    """Global defaults from the environment (the PETSc options DB analog).

    kind: "linear" reads NEPTUNE_KSP_OPTIONS, "nonlinear" NEPTUNE_SNES_OPTIONS.
    """
    if kind == "linear":
        var, keys = "NEPTUNE_KSP_OPTIONS", LINEAR_OPTION_KEYS
    else:
        var, keys = "NEPTUNE_SNES_OPTIONS", NONLINEAR_OPTION_KEYS
    s = os.environ.get(var)
    if not s:
        return {}
    return parse_options(s, keys, where=f"${var}")


# which solvers each linear option applies to — used to SCOPE global env
# defaults (PETSc's options DB ignores inapplicable options; a global
# default must not poison unrelated solves). Explicit per-op options stay
# strict: linear_option_kwargs raises on a mismatch.
_LINEAR_OPTION_SOLVERS = {
    "atol": ("cg", "bicgstab", "gmres", "chebyshev"),
    "divtol": ("cg", "bicgstab", "gmres"),
    "restart": ("gmres",),
    "lam_min": ("chebyshev",),
    "lam_max": ("chebyshev",),
    "check_every": ("chebyshev",),
}


def merged_linear_options(
    op_options: Optional[dict], solver: Optional[str] = None
) -> dict:
    out = env_defaults("linear")
    if solver is not None:
        out = {
            k: v
            for k, v in out.items()
            if solver in _LINEAR_OPTION_SOLVERS.get(k, ())
        }
    out.update(op_options or {})
    return out


def linear_option_kwargs(solver: str, opts: Mapping) -> dict:
    """Map validated linear options onto krylov.* keyword arguments."""
    kw = {}
    if "atol" in opts:
        kw["atol"] = opts["atol"]
    if "divtol" in opts:
        if solver == "chebyshev":
            raise ValueError(
                "option 'divtol' does not apply to solver='chebyshev' "
                "(no per-iteration residual test)"
            )
        kw["divtol"] = opts["divtol"]
    if "restart" in opts:
        if solver != "gmres":
            raise ValueError(
                f"option 'restart' only applies to solver='gmres' (got "
                f"{solver!r})"
            )
        kw["restart"] = opts["restart"]
    for k in ("lam_min", "lam_max", "check_every"):
        if k in opts:
            if solver != "chebyshev":
                raise ValueError(
                    f"option {k!r} only applies to solver='chebyshev' (got "
                    f"{solver!r})"
                )
            kw[k] = opts[k]
    return kw


def nonlinear_option_kwargs(method: str, opts: Mapping) -> dict:
    """Map validated nonlinear options onto newton_krylov/picard kwargs."""
    if method == "picard":
        bad = set(opts) - {"damping"}
        if bad:
            raise ValueError(
                f"options {sorted(bad)} do not apply to method='picard' "
                "(only 'damping' does)"
            )
        return {"damping": opts["damping"]} if "damping" in opts else {}
    if "damping" in opts:
        raise ValueError("option 'damping' only applies to method='picard'")
    return {
        k: opts[k]
        for k in ("atol", "restart", "max_step", "line_search", "max_backtracks")
        if k in opts
    }


def merged_nonlinear_options(
    op_options: Optional[dict], method: Optional[str] = None
) -> dict:
    out = env_defaults("nonlinear")
    if method is not None:
        # scope env defaults like the linear path: 'damping' is picard-only,
        # everything else newton-only
        if method == "picard":
            out = {k: v for k, v in out.items() if k == "damping"}
        else:
            out = {k: v for k, v in out.items() if k != "damping"}
    out.update(op_options or {})
    return out
