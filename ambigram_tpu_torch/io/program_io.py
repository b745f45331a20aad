"""LP / MPS emission for the BFB fitting program.

Parity target: the reference writes its COIN-OR model as both `.mps`
and `.lp` next to every solve (si->writeMps / si->writeLp,
src/LocalGenomicMap.cpp:4749-4750) — the de-facto debug
and interchange artifact that lets any external MILP solver check the
program differentially. This module restores that artifact for the
epsilon-eliminated in-process program: the emitted file is the SAME
formulation the reference ships to cbc — variables
[patterns | loops | epsilons | bias], objective sum(eps) - bias, bias
fixed by its bounds, elements integer (LGM.cpp:4706-4752) — so an
external `highs model.lp` / `cbc model.mps` run reproduces the
in-process objective.

Variable names: `p_i_j` / `l_i_j` mirror the reference's
`p:i,j` / `l:i,j` variableIdx keys (':'/',' are not legal in LP
identifiers), epsilons are `e<k>`, the bias column is `bias`.

`read_lp` parses the subset this writer emits (used by the roundtrip
test, which feeds the file back through HiGHS via scipy.milp).
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np

from ambigram_tpu_torch.engine.ilp import BfbProgram


def _var_names(prog: BfbProgram) -> List[str]:
    T = len(prog.pairs)
    K = prog.num_vars // (2 * T) if T else 1
    names: List[str] = []
    for k in range(K):
        suffix = "" if K == 1 else "_g%d" % k
        for kind in ("p", "l"):
            for (i, j) in prog.pairs:
                names.append("%s_%d_%d%s" % (kind, int(i), int(j), suffix))
    return names


def _terms(row: np.ndarray, names: List[str]) -> str:
    parts: List[str] = []
    for v in np.flatnonzero(row):
        coef = float(row[v])
        sign = "-" if coef < 0 else "+"
        mag = abs(coef)
        coef_s = ("%g " % mag) if mag != 1.0 else ""
        parts.append("%s %s%s" % (sign, coef_s, names[v]))
    s = " ".join(parts)
    return s[2:] if s.startswith("+ ") else s


def write_lp(prog: BfbProgram, path: str) -> None:
    """Emit the epsilon-lifted MILP in CPLEX LP format."""
    names = _var_names(prog)
    A_res, c_res = prog.residual_system()
    E = A_res.shape[0]
    eps = ["e%d" % k for k in range(E)]
    lines: List[str] = ["\\Problem name: ambigram_bfb", "", "Minimize"]
    obj = " + ".join(eps) if E else "0 bias"
    lines.append(" obj: %s - bias" % obj)
    lines.append("Subject To")
    # residual rows as the reference's +/- epsilon pair
    # (A x + e >= c ; A x - e <= c)
    for r in range(E):
        t = _terms(A_res[r], names)
        lines.append(" res%d_lo: %s + %s >= %g" % (r, t, eps[r], c_res[r]))
        lines.append(" res%d_hi: %s - %s <= %g" % (r, t, eps[r], c_res[r]))
    for m in range(prog.G.shape[0]):
        t = _terms(prog.G[m].astype(np.float64), names)
        lo, hi = float(prog.g_lb[m]), float(prog.g_ub[m])
        if np.isfinite(lo) and np.isfinite(hi) and lo == hi:
            lines.append(" hard%d: %s = %g" % (m, t, lo))
            continue
        if np.isfinite(lo):
            lines.append(" hard%d_lo: %s >= %g" % (m, t, lo))
        if np.isfinite(hi):
            lines.append(" hard%d_hi: %s <= %g" % (m, t, hi))
    lines.append("Bounds")
    for v, name in enumerate(names):
        lines.append(" 0 <= %s <= %g" % (name, float(prog.x_ub[v])))
    for e in eps:
        lines.append(" 0 <= %s" % e)
    lines.append(" bias = %g" % float(prog.bias))
    lines.append("Generals")
    lines.append(" " + " ".join(names))
    lines.append("End")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def write_mps(prog: BfbProgram, path: str) -> None:
    """Emit the same program in fixed MPS format (the reference's other
    artifact, LGM.cpp:4749)."""
    names = _var_names(prog)
    A_res, c_res = prog.residual_system()
    E = A_res.shape[0]
    M = prog.G.shape[0]
    rows: List[str] = []
    # column-major entries: var -> [(row_name, coef)]
    col_entries: Dict[str, List[Tuple[str, float]]] = {n: [] for n in names}
    rhs: List[Tuple[str, float]] = []
    for r in range(E):
        rows.append(" G  RLO%d" % r)
        rows.append(" L  RHI%d" % r)
        for v in np.flatnonzero(A_res[r]):
            col_entries[names[v]].append(("RLO%d" % r, float(A_res[r, v])))
            col_entries[names[v]].append(("RHI%d" % r, float(A_res[r, v])))
        rhs.append(("RLO%d" % r, float(c_res[r])))
        rhs.append(("RHI%d" % r, float(c_res[r])))
    for m in range(M):
        lo, hi = float(prog.g_lb[m]), float(prog.g_ub[m])
        if np.isfinite(lo):
            rows.append(" G  HLO%d" % m)
            rhs.append(("HLO%d" % m, lo))
        if np.isfinite(hi):
            rows.append(" L  HHI%d" % m)
            rhs.append(("HHI%d" % m, hi))
        for v in np.flatnonzero(prog.G[m]):
            coef = float(prog.G[m, v])
            if np.isfinite(lo):
                col_entries[names[v]].append(("HLO%d" % m, coef))
            if np.isfinite(hi):
                col_entries[names[v]].append(("HHI%d" % m, coef))
    out: List[str] = ["NAME          AMBIGRAM_BFB", "ROWS", " N  COST"]
    out += rows
    out.append("COLUMNS")
    out.append("    MARKER                 'MARKER'                 'INTORG'")
    for v, name in enumerate(names):
        for row_name, coef in col_entries[name]:
            out.append("    %-10s %-10s %g" % (name, row_name, coef))
        if not col_entries[name]:
            out.append("    %-10s %-10s %g" % (name, "COST", 0.0))
    out.append("    MARKER                 'MARKER'                 'INTEND'")
    for k in range(E):
        out.append("    %-10s %-10s %g" % ("e%d" % k, "COST", 1.0))
        out.append("    %-10s %-10s %g" % ("e%d" % k, "RLO%d" % k, 1.0))
        out.append("    %-10s %-10s %g" % ("e%d" % k, "RHI%d" % k, -1.0))
    out.append("    %-10s %-10s %g" % ("bias", "COST", -1.0))
    out.append("RHS")
    for row_name, val in rhs:
        out.append("    %-10s %-10s %g" % ("RHS", row_name, val))
    out.append("BOUNDS")
    for v, name in enumerate(names):
        out.append(" UP %-10s %-10s %g" % ("BND", name, float(prog.x_ub[v])))
    out.append(" FX %-10s %-10s %g" % ("BND", "bias", float(prog.bias)))
    out.append("ENDATA")
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")


_TERM_RE = re.compile(r"([+-])\s*(\d+(?:\.\d+)?(?:e-?\d+)?)?\s*([A-Za-z]\w*)")


def read_lp(path: str):
    """Parse the LP subset `write_lp` emits. Returns a dict with keys
    var_names, c (objective), A, lb, ub (row bounds), x_lb, x_ub,
    integrality — directly consumable by scipy.optimize.milp."""
    sections: Dict[str, List[str]] = {}
    cur = None
    for raw in open(path):
        line = raw.strip()
        if not line or line.startswith("\\"):
            continue
        low = line.lower()
        if low in ("minimize", "subject to", "bounds", "generals", "end"):
            cur = low
            sections.setdefault(cur, [])
            continue
        if cur is not None:
            sections[cur].append(line)

    def parse_expr(expr: str) -> Dict[str, float]:
        expr = expr.strip()
        if not expr.startswith(("+", "-")):
            expr = "+ " + expr
        out: Dict[str, float] = {}
        for sign, coef, name in _TERM_RE.findall(expr):
            val = float(coef) if coef else 1.0
            out[name] = out.get(name, 0.0) + (val if sign == "+" else -val)
        return out

    obj_expr = " ".join(sections.get("minimize", []))
    obj_expr = obj_expr.split(":", 1)[-1]
    obj = parse_expr(obj_expr)

    constraints = []  # (coefs, lb, ub)
    var_order: List[str] = []
    seen = set()

    def note_vars(coefs: Dict[str, float]) -> None:
        for n in coefs:
            if n not in seen:
                seen.add(n)
                var_order.append(n)

    note_vars(obj)
    for line in sections.get("subject to", []):
        body = line.split(":", 1)[-1]
        m = re.search(r"(<=|>=|=)\s*(-?\d+(?:\.\d+)?(?:e-?\d+)?)\s*$", body)
        if not m:
            raise ValueError("unparseable constraint: %r" % line)
        op, rhs = m.group(1), float(m.group(2))
        coefs = parse_expr(body[: m.start()])
        note_vars(coefs)
        lo = rhs if op in (">=", "=") else -np.inf
        hi = rhs if op in ("<=", "=") else np.inf
        constraints.append((coefs, lo, hi))

    x_lb: Dict[str, float] = {}
    x_ub: Dict[str, float] = {}
    for line in sections.get("bounds", []):
        m = re.match(
            r"(-?\d+(?:\.\d+)?)\s*<=\s*(\w+)\s*<=\s*(-?\d+(?:\.\d+)?)", line
        )
        if m:
            x_lb[m.group(2)] = float(m.group(1))
            x_ub[m.group(2)] = float(m.group(3))
            continue
        m = re.match(r"(-?\d+(?:\.\d+)?)\s*<=\s*(\w+)\s*$", line)
        if m:
            x_lb[m.group(2)] = float(m.group(1))
            continue
        m = re.match(r"(\w+)\s*=\s*(-?\d+(?:\.\d+)?)", line)
        if m:
            x_lb[m.group(1)] = float(m.group(2))
            x_ub[m.group(1)] = float(m.group(2))
            continue
        raise ValueError("unparseable bound: %r" % line)
    integers = set()
    for line in sections.get("generals", []):
        integers.update(line.split())

    idx = {n: i for i, n in enumerate(var_order)}
    N = len(var_order)
    c = np.zeros(N)
    for n, v in obj.items():
        c[idx[n]] = v
    A = np.zeros((len(constraints), N))
    lb = np.zeros(len(constraints))
    ub = np.zeros(len(constraints))
    for r, (coefs, lo, hi) in enumerate(constraints):
        for n, v in coefs.items():
            A[r, idx[n]] = v
        lb[r], ub[r] = lo, hi
    return {
        "var_names": var_order,
        "c": c,
        "A": A,
        "lb": lb,
        "ub": ub,
        "x_lb": np.array([x_lb.get(n, 0.0) for n in var_order]),
        "x_ub": np.array([x_ub.get(n, np.inf) for n in var_order]),
        "integrality": np.array(
            [1.0 if n in integers else 0.0 for n in var_order]
        ),
    }


def solve_lp_file(path: str, time_limit: float = 60.0):
    """Solve a `write_lp` artifact with HiGHS (scipy.milp). Returns
    (objective_value, x_dict) — the differential-check entry point."""
    from scipy.optimize import Bounds, LinearConstraint, milp

    m = read_lp(path)
    res = milp(
        c=m["c"],
        constraints=LinearConstraint(m["A"], m["lb"], m["ub"]),
        integrality=m["integrality"],
        bounds=Bounds(m["x_lb"], m["x_ub"]),
        options={"time_limit": time_limit},
    )
    if res.status != 0 or res.x is None:
        raise RuntimeError("LP-file solve failed: status %s" % res.status)
    return float(res.fun), dict(zip(m["var_names"], res.x))
