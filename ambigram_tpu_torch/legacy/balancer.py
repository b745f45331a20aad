"""Legacy copy-number balancer (the old `check` op).

Parity target: LocalGenomicMap::balancerILP
(src/LocalGenomicMap.cpp:301-800) + scaleILPCoef
(:286-299). The reference builds the MILP, writes .lp/.mps, and leaves
solving to the external cbc + script/parseILP.py; here the same program
is solved in-process and the balanced copy numbers are written back to
the graph (and optionally a `.balanced.lh` like parseILP.py:27-57).

Variables: [seg CN t_s | junc CN t_j | junc on/off x_j | seg eps | junc eps]
Constraints:
  hap * t_s  +- e_s  >=/<= corrected_coverage_s        (coverage fit)
  t_s - sum_in t_j = 0 ;  t_s - sum_out t_j = 0        (flow at + vertex)
  hap * t_j - (cov_j + 0.05) x_j +- e_j >=/<= 0        (junction fit)
  t_j - M x_j <= 0 ;  t_j - x_j >= 0                   (on/off coupling)
Objective: z-score-scaled coefficients on seg epsilons, min coef on
junc epsilons, max coef on inferred junctions' x (discourage them).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from ambigram_tpu_torch.exceptions import ILPBalancerInfeasibleError
from ambigram_tpu_torch.model.genome import Genome


def scale_ilp_coef(covs: np.ndarray) -> np.ndarray:
    """z-score-like scaling (LGM.cpp:286-299)."""
    covs = np.asarray(covs, dtype=np.float64)
    mean = covs.mean()
    diff = covs - mean + 1
    stdev = np.sqrt((diff**2).mean())
    return np.abs(diff / stdev)


@dataclass
class BalancerResult:
    seg_cn: np.ndarray
    junc_cn: np.ndarray
    junc_on: np.ndarray
    objective: float
    status: str


def _flow_counts(genome: Genome, seg, incoming: bool) -> Dict[int, int]:
    """Junction multiplicities on the positive vertex's in/out edge list
    (LGM.cpp:397-456): first sighting counts 1; repeats add 1 only for
    non-self edges."""
    jidx = {id(j): k for k, j in enumerate(genome.junctions)}
    counts: Dict[int, int] = {}
    edges = seg.pos.edges_as_target if incoming else seg.pos.edges_as_source
    for e in edges:
        k = jidx[id(e.junction)]
        if k not in counts:
            counts[k] = 1
        else:
            if e.target is not e.source:
                counts[k] += 1
    return counts


def balance(
    genome: Genome, max_copy: int = 999999, allow_junction_off: bool = False
) -> BalancerResult:
    """Balance copy numbers. With `allow_junction_off` (an extension
    beyond LGM.cpp:301-800, where every non-inferred junction is forced
    on via x_j >= 1), observed junctions may be switched off at the
    same max-coefficient penalty the reference charges for switching an
    inferred junction ON — real graphs (e.g. the reference's own
    75-segment script/test.lh) can admit no circulation with every SV
    junction active, and the reference's cbc would report infeasible."""
    try:
        from scipy.optimize import Bounds, LinearConstraint, milp
    except ImportError as e:  # pragma: no cover
        raise RuntimeError("balancer requires scipy HiGHS") from e

    segs = genome.segments
    juncs = genome.junctions
    nS, nJ = len(segs), len(juncs)
    num_sj = nS + nJ
    # variables: t_s (nS) | t_j (nJ) | x_j (nJ) | e_s (nS) | e_j (nJ)
    N = num_sj + nJ + num_sj
    hap = genome.haploid_depth
    v_hap = genome.haploid_depth
    v_start = genome.virus_seg_start if genome.virus_seg_start is not None else 1 << 60

    rows: List[np.ndarray] = []
    lbs: List[float] = []
    ubs: List[float] = []

    def add(row, lb, ub):
        rows.append(row)
        lbs.append(lb)
        ubs.append(ub)

    covs = []
    for i, seg in enumerate(segs):
        cov = seg.weight.corrected_coverage
        covs.append(cov)
        h = hap if (i < v_start) else v_hap
        r = np.zeros(N)
        r[i] = h
        r[num_sj + nJ + i] = 1.0
        add(r, cov, np.inf)
        r2 = np.zeros(N)
        r2[i] = h
        r2[num_sj + nJ + i] = -1.0
        add(r2, -np.inf, cov)
        # flow conservation rows
        for incoming in (True, False):
            r3 = np.zeros(N)
            r3[i] = 1.0
            for k, count in _flow_counts(genome, seg, incoming).items():
                r3[nS + k] -= count
            add(r3, 0.0, 0.0)
    for k, junc in enumerate(juncs):
        cov = junc.weight.corrected_coverage
        covs.append(cov)
        covp = cov + 0.05
        r = np.zeros(N)
        r[nS + k] = hap
        r[num_sj + k] = -covp
        r[num_sj + nJ + nS + k] = 1.0
        add(r, 0.0, np.inf)
        r2 = np.zeros(N)
        r2[nS + k] = hap
        r2[num_sj + k] = -covp
        r2[num_sj + nJ + nS + k] = -1.0
        add(r2, -np.inf, 0.0)
        r3 = np.zeros(N)
        r3[nS + k] = 1.0
        r3[num_sj + k] = -max_copy
        add(r3, -np.inf, 0.0)
        r4 = np.zeros(N)
        r4[nS + k] = 1.0
        r4[num_sj + k] = -1.0
        add(r4, 0.0, np.inf)

    coefs = scale_ilp_coef(np.array(covs))
    max_coef = coefs.max()
    min_coef = coefs.min() if coefs.min() > 0 else 0.1

    c = np.zeros(N)
    obj_offset = 0.0
    for k, junc in enumerate(juncs):
        if junc.inferred:
            c[num_sj + k] = max_coef
        elif allow_junction_off:
            # charge max_coef * (1 - x_j) for deactivating an observed
            # junction: same magnitude as activating an inferred one
            c[num_sj + k] = -max_coef
            obj_offset += max_coef
    c[num_sj + nJ : num_sj + nJ + nS] = coefs[:nS]
    c[num_sj + nJ + nS :] = min_coef

    lb = np.zeros(N)
    ub = np.full(N, np.inf)
    for i, seg in enumerate(segs):
        lb[i] = 1.0 if seg.has_lower_bound_limit else 0.0
    for k, junc in enumerate(juncs):
        lb[num_sj + k] = (
            0.0 if (junc.inferred or allow_junction_off) else 1.0
        )
        ub[num_sj + k] = 1.0

    integrality = np.zeros(N)
    integrality[: num_sj + nJ] = 1
    res = milp(
        c=c,
        constraints=LinearConstraint(np.array(rows), np.array(lbs), np.array(ubs)),
        integrality=integrality,
        bounds=Bounds(lb, ub),
    )
    if res.status != 0 or res.x is None:
        if res.status == 2:
            raise ILPBalancerInfeasibleError("balancer ILP infeasible")
        return BalancerResult(
            seg_cn=np.zeros(nS),
            junc_cn=np.zeros(nJ),
            junc_on=np.zeros(nJ),
            objective=0.0,
            status="error",
        )
    x = res.x
    return BalancerResult(
        seg_cn=np.round(x[:nS]).astype(np.int64),
        junc_cn=np.round(x[nS : nS + nJ]).astype(np.int64),
        junc_on=np.round(x[num_sj : num_sj + nJ]).astype(np.int64),
        objective=float(res.fun) + obj_offset,
        status="optimal",
    )


def apply_balance(genome: Genome, result: BalancerResult) -> None:
    """Write balanced copy numbers back (parseILP.py:1-26 equivalent)."""
    for seg, cn in zip(genome.segments, result.seg_cn):
        seg.weight.set_copy_num(float(cn))
    for junc, cn in zip(genome.junctions, result.junc_cn):
        junc.weight.set_copy_num(float(cn))


def write_balanced_lh(
    genome: Genome, path: str, original_lh: Optional[str] = None
) -> None:
    """parseILP.py:27-57 equivalent: emit the graph with balanced CNs.

    When the original LH file is available, its lines are rewritten in
    place with the balanced copy numbers (keeping header keys parseable
    — the reference's writeGraph output uses AVG_SEG_DP, which its own
    parser does not read, so round-tripping requires this route).
    """
    if original_lh is None:
        genome.write_lh(path)
        return
    seg_cn = {seg.id: seg.weight.copy_num for seg in genome.segments}
    junc_cn = {}
    for junc in genome.junctions:
        key = (junc.source.id, junc.source_dir, junc.target.id, junc.target_dir)
        junc_cn[key] = junc.weight.copy_num
    out_lines = []
    with open(original_lh) as f:
        for line in f.read().splitlines():
            tok = line.split()
            if tok and tok[0] == "SEG":
                seg_id = int(tok[1].split(":")[1])
                if seg_id in seg_cn:
                    cn = "%g" % seg_cn[seg_id]
                    if len(tok) >= 4:
                        tok[3] = cn
                    else:  # legacy `SEG H:<id> <depth>`: append CN column
                        tok.append(cn)
                out_lines.append(" ".join(tok))
            elif tok and tok[0] == "JUNC":
                s = tok[1].split(":")
                t = tok[2].split(":")
                key = (int(s[1]), s[2][0], int(t[1]), t[2][0])
                if key in junc_cn:
                    cn = "%g" % junc_cn[key]
                    if len(tok) >= 5:
                        tok[4] = cn
                    else:  # legacy `JUNC a b <depth>`: append CN column
                        tok.append(cn)
                out_lines.append(" ".join(tok))
            else:
                out_lines.append(line)
    # append any junctions inferred during balancing (e.g. the
    # sink->source closure) so the graph stays flow-consistent
    with open(original_lh) as f:
        text = f.read()
    for junc in genome.junctions:
        probe = "JUNC H:%d:%s H:%d:%s" % (
            junc.source.id,
            junc.source_dir,
            junc.target.id,
            junc.target_dir,
        )
        if probe not in text:
            out_lines.append(
                "%s %g %g %s %s"
                % (
                    probe,
                    junc.weight.coverage,
                    junc.weight.copy_num,
                    "I" if junc.inferred else "U",
                    "B" if junc.has_lower_bound_limit else "U",
                )
            )
    with open(path, "w") as f:
        f.write("\n".join(out_lines) + "\n")
