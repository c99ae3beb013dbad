"""Tiny MILP modeling layer over scipy's HiGHS backend.

A copy of ``saturn_tpu/solver/lp.py``: named variables, linear expressions,
constraints, and a solve with a time limit through ``scipy.optimize.milp``.
Only what the SPASE MILP needs is implemented: binary/integer/continuous
variables, <= / >= / == constraints, minimize.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
from scipy import sparse
from scipy.optimize import Bounds, LinearConstraint, milp


class Expr:
    """Sparse linear expression: sum(coef * var) + const."""

    __slots__ = ("terms", "const")

    def __init__(self, terms: Optional[Dict[int, float]] = None, const: float = 0.0):
        self.terms = dict(terms or {})
        self.const = float(const)

    @staticmethod
    def of(x: Union["Expr", "Var", float, int]) -> "Expr":
        if isinstance(x, Expr):
            return x
        if isinstance(x, Var):
            return Expr({x.idx: 1.0})
        return Expr({}, float(x))

    def __add__(self, other):
        o = Expr.of(other)
        t = dict(self.terms)
        for k, v in o.terms.items():
            t[k] = t.get(k, 0.0) + v
        return Expr(t, self.const + o.const)

    __radd__ = __add__

    def __sub__(self, other):
        return self + (Expr.of(other) * -1.0)

    def __rsub__(self, other):
        return Expr.of(other) + (self * -1.0)

    def __mul__(self, c):
        c = float(c)
        return Expr({k: v * c for k, v in self.terms.items()}, self.const * c)

    __rmul__ = __mul__

    def __neg__(self):
        return self * -1.0

    # comparisons build constraints
    def __le__(self, other):
        return Constraint(self - Expr.of(other), "<=")

    def __ge__(self, other):
        return Constraint(self - Expr.of(other), ">=")

    def __eq__(self, other):  # type: ignore[override]
        return Constraint(self - Expr.of(other), "==")


class Var(Expr):
    """A decision variable; behaves as an Expr with one term."""

    __slots__ = ("idx", "name")

    def __init__(self, idx: int, name: str):
        super().__init__({idx: 1.0})
        self.idx = idx
        self.name = name

    def __hash__(self):
        return self.idx

    def __repr__(self):  # pragma: no cover
        return f"Var({self.name})"


@dataclass
class Constraint:
    expr: Expr  # expr (op) 0
    op: str     # '<=', '>=', '=='


@dataclass
class SolveResult:
    status: str                      # 'optimal' | 'feasible' | 'infeasible' | 'error'
    objective: float
    values: np.ndarray

    def value(self, v: Union[Var, Expr]) -> float:
        e = Expr.of(v)
        return float(
            sum(c * self.values[i] for i, c in e.terms.items()) + e.const
        )

    @property
    def ok(self) -> bool:
        return self.status in ("optimal", "feasible")


class Model:
    """An LP/MILP under construction."""

    def __init__(self, name: str = "model"):
        self.name = name
        self._lb: List[float] = []
        self._ub: List[float] = []
        self._int: List[bool] = []
        self._names: List[str] = []
        self.constraints: List[Constraint] = []
        self._objective: Optional[Expr] = None

    # ------------------------------------------------------------- variables
    def _add_var(self, name, lb, ub, integer) -> Var:
        idx = len(self._lb)
        self._lb.append(lb)
        self._ub.append(ub)
        self._int.append(integer)
        self._names.append(name)
        return Var(idx, name)

    def binary(self, name: str) -> Var:
        return self._add_var(name, 0.0, 1.0, True)

    def integer(self, name: str, lb=0.0, ub=np.inf) -> Var:
        return self._add_var(name, lb, ub, True)

    def continuous(self, name: str, lb=0.0, ub=np.inf) -> Var:
        return self._add_var(name, lb, ub, False)

    # ----------------------------------------------------------- constraints
    def add(self, c: Constraint) -> None:
        if not isinstance(c, Constraint):
            raise TypeError(f"expected Constraint, got {type(c)}")
        self.constraints.append(c)

    def link_when(self, gate, a, b, big_m: float) -> None:
        """Force ``a == b`` (up to tolerance) when the binary ``gate`` is 1:
        the big-M pair ``a - b <= M(1-gate)``, ``b - a <= M(1-gate)``, which
        relaxes away at gate 0 (the SPASE co-location term pins a pair to
        one option and one start with it)."""
        g = Expr.of(gate)
        ea, eb = Expr.of(a), Expr.of(b)
        slack = (Expr.of(1.0) - g) * float(big_m)
        self.add(ea - eb <= slack)
        self.add(eb - ea <= slack)

    def minimize(self, e: Expr) -> None:
        self._objective = Expr.of(e)

    # ----------------------------------------------------------------- solve
    def solve(
        self,
        time_limit: Optional[float] = None,
        gap: float = 1e-4,
    ) -> SolveResult:
        n = len(self._lb)
        if self._objective is None:
            raise ValueError("no objective set")
        c = np.zeros(n)
        for i, v in self._objective.terms.items():
            c[i] = v

        rows, cols, vals = [], [], []
        lo, hi = [], []
        for r, con in enumerate(self.constraints):
            rhs = -con.expr.const
            for i, v in con.expr.terms.items():
                rows.append(r)
                cols.append(i)
                vals.append(v)
            if con.op == "<=":
                lo.append(-np.inf)
                hi.append(rhs)
            elif con.op == ">=":
                lo.append(rhs)
                hi.append(np.inf)
            else:
                lo.append(rhs)
                hi.append(rhs)

        A = sparse.csr_matrix(
            (vals, (rows, cols)), shape=(len(self.constraints), n)
        )
        lc = LinearConstraint(A, np.asarray(lo), np.asarray(hi))
        bounds = Bounds(np.asarray(self._lb), np.asarray(self._ub))
        integrality = np.asarray(self._int, dtype=np.uint8)
        options: Dict[str, float] = {"mip_rel_gap": gap}
        if time_limit is not None:
            options["time_limit"] = float(time_limit)
        res = milp(
            c,
            constraints=[lc],
            bounds=bounds,
            integrality=integrality,
            options=options,
        )
        if res.x is None:
            return SolveResult("infeasible", np.inf, np.zeros(n))
        status = "optimal" if res.status == 0 else "feasible"
        return SolveResult(status, float(res.fun) + self._objective.const, res.x)
