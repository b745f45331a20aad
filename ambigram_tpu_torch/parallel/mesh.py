"""Multi-device batching: case stacking, the case x model mesh, the
sharded search step and the stacked case-sharded solve.

Port of ambigram_tpu/parallel/mesh.py. The mesh has two axes:

- "case":  independent cases are data parallel; case slot c holds its
           share of the stacked cases on the devices of mesh row c;
- "model": the rows of the scoring product are split into row shards,
           one per device of the row, and a candidate's score is the sum
           of its shards' partial scores (JAX's psum over "model").

JAX places the shards with `shard_map`; here a `Mesh` is a small 2-D
array of torch devices and the step walks it in Python, launching K1
(`score_rows`) on each row shard on that shard's device. The mesh need
not hold distinct devices: a logical mesh repeats one card
(`make_mesh(devices=["cuda:0"] * 4)`), as the JAX tests run on virtual
CPU devices, and on a CPU host a mesh of the labels
`torch.device("cpu", i)` shows which shard went where while the data
lands on the CPU (torch drops a CPU index). The search draws every
random number from numpy with the JAX package's seeds and order, and the
step is greedy and deterministic (first-minimum argmin, strict
improvement only), so on integer-target programs the port's
`solve_cases_sharded` returns the JAX package's `best_x` bitwise. JAX's
compile cache has no counterpart here.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ambigram_tpu_torch.engine.ilp import BfbProgram
from ambigram_tpu_torch.solver.score import _BIG, ScoringTensors, _expand_f32, score_rows, scoring_tensors

# K1's int8 path takes rows in multiples of 64: each row shard is padded
# to that with rows of weight 0 and open bounds, which add nothing
_SHARD_ROW_ALIGN = 64
# the candidates of one chunk of the dense move set, f32: the step builds
# and scores [cases, pop, chunk, Vp] at a time and keeps the running first
# minimum across chunks, so its temporaries stay near this size per card
STEP_CHUNK_BYTES = 512 << 20


def _pad_rows(x: np.ndarray, rows: int, fill: float = 0.0, dtype=np.float32) -> np.ndarray:
    out = np.full((rows,) + x.shape[1:], fill, dtype=dtype)
    out[: x.shape[0]] = x
    return out


def stack_cases(progs: Sequence[BfbProgram], device="cpu") -> ScoringTensors:
    """Stack the programs into one set whose leaves carry a leading case
    axis, padded to the widest variables and the most rows across cases.
    Padding rows carry w = 0, open bounds and zero H rows, so they add
    nothing to any score.

    When every case's rows are int8-exact (they are for all current
    builders) only the stacked int8 representation is uploaded and the
    f32 one is expanded on `device`; otherwise each case's f32
    representation is assembled on the host and stacked."""
    pad_v = max(128, max(((p.num_vars + 127) // 128) * 128 for p in progs))
    sts = [scoring_tensors(p, "cpu", pad_vars=pad_v, need_f32=False) for p in progs]
    int8_ok = all(st.int8_ok for st in sts)
    if not int8_ok:
        sts = [scoring_tensors(p, "cpu", pad_vars=pad_v) for p in progs]
    pad_r = max(st.H8.shape[0] for st in sts)

    def stack(name: str, fill: float = 0.0, dtype=np.float32) -> torch.Tensor:
        arrs = [_pad_rows(getattr(st, name).numpy(), pad_r, fill, dtype) for st in sts]
        return torch.as_tensor(np.stack(arrs)).to(device)

    H8 = stack("H8", dtype=np.int8)
    lb_raw = stack("lb_raw", -_BIG)
    ub_raw = stack("ub_raw", _BIG)
    w = stack("w")
    if int8_ok:
        H, lb, ub = _expand_f32(H8, lb_raw, ub_raw, w)
    else:
        H, lb, ub = stack("H"), stack("lb", -_BIG), stack("ub", _BIG)
    return ScoringTensors(
        H=H,
        lb=lb,
        ub=ub,
        x_ub=torch.as_tensor(np.stack([st.x_ub.numpy() for st in sts])).to(device),
        H8=H8,
        lb_raw=lb_raw,
        ub_raw=ub_raw,
        w=w,
        num_vars=pad_v,
        num_residual_rows=max(st.num_residual_rows for st in sts),
        int8_ok=int8_ok,
        x_ub_max=max(st.x_ub_max for st in sts),
    )


# ---------------------------------------------------------------- the mesh


@dataclass(frozen=True)
class Mesh:
    """A [case, model] grid of torch devices (JAX's `Mesh` with the axes
    ("case", "model")). `devices` is a 2-D numpy object array."""

    devices: np.ndarray
    axis_names: Tuple[str, str] = field(default=("case", "model"))

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.devices.shape)

    def flat(self) -> List[torch.device]:
        """The devices in row-major order, repeats kept."""
        return list(self.devices.flatten())


def visible_devices() -> List[torch.device]:
    """Every visible card; raises without one (the port never falls back
    to the CPU: a CPU mesh is asked for by its labels)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("no CUDA device is available: pass devices= (cpu labels on a CPU host)")
    return [torch.device("cuda", i) for i in range(n)]


def cpu_devices(n: int) -> List[torch.device]:
    """n CPU labels cpu:0 .. cpu:n-1 for a mesh on a CPU host."""
    return [torch.device("cpu", i) for i in range(n)]


def make_mesh(
    n_devices: Optional[int] = None, case_axis: Optional[int] = None, devices: Optional[Sequence] = None
) -> Mesh:
    """A case x model mesh over `devices` (default: every visible card),
    or their first `n_devices`, with JAX's case-axis rule: an even count
    n > 1 gives (n // 2, 2), any other (n, 1). So 8 devices give (4, 2),
    4 give (2, 2), 2 give (1, 2) and 1 gives (1, 1). `devices` may repeat
    a device: ["cuda:0"] * 4 is a logical (2, 2) mesh on one card."""
    devs = visible_devices() if devices is None else [torch.device(d) for d in devices]
    if n_devices is not None:
        if not 1 <= n_devices <= len(devs):
            raise ValueError("%d devices asked for, %d given" % (n_devices, len(devs)))
        devs = devs[:n_devices]
    n = len(devs)
    if n == 0:
        raise ValueError("a mesh needs at least one device")
    if case_axis is None:
        case_axis = n // 2 if (n % 2 == 0 and n > 1) else n
    if case_axis < 1 or n % case_axis:
        raise ValueError("case axis %d does not divide %d devices" % (case_axis, n))
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(case_axis, n // case_axis))


# ------------------------------------------------- row shards and the step


@dataclass
class ShardedCases:
    """A case-stacked set placed on a mesh: `shards[c][m]` holds the rows
    of model shard m of case slot c's cases ([cases per slot, rows, Vp],
    rows padded to a multiple of 64 with w = 0) on mesh.devices[c, m];
    `x_ub[c]` the slot's variable bounds on its first device."""

    mesh: Mesh
    shards: List[List[ScoringTensors]]
    x_ub: List[torch.Tensor]

    @property
    def num_vars(self) -> int:
        return int(self.x_ub[0].shape[-1])

    def put(self, X: np.ndarray) -> List[torch.Tensor]:
        """Candidates X [cases, pop, Vp] split over the case slots, each
        slot's part on its first device."""
        per = X.shape[0] // len(self.x_ub)
        return [
            torch.as_tensor(np.ascontiguousarray(X[c * per : (c + 1) * per])).to(self.x_ub[c].device)
            for c in range(len(self.x_ub))
        ]

    @staticmethod
    def gather(parts: Sequence[torch.Tensor]) -> np.ndarray:
        """The slots' parts back on the host, in case order."""
        return np.concatenate([p.cpu().numpy() for p in parts], axis=0)


def shard_cases(st: ScoringTensors, mesh: Mesh) -> ShardedCases:
    """Place a case-stacked set (`stack_cases`) on the mesh as `shard_map`
    places P("case", "model") rows: case slot c takes the c-th block of
    cases, model shard m the m-th block of rows. The number of cases must
    divide into the case slots and the rows into the model shards."""
    n_case, n_model = mesh.shape
    cases, rows, vp = st.H8.shape
    if cases % n_case or rows % n_model:
        raise ValueError("%d cases x %d rows do not divide over a %s mesh" % (cases, rows, mesh.shape))
    per, rows_m = cases // n_case, rows // n_model
    rows_p = -(-rows_m // _SHARD_ROW_ALIGN) * _SHARD_ROW_ALIGN
    shards, x_ubs = [], []
    for c in range(n_case):
        cs = slice(c * per, (c + 1) * per)
        row = []
        for m in range(n_model):
            rs = slice(m * rows_m, (m + 1) * rows_m)
            dev = mesh.devices[c, m]

            def part(t: torch.Tensor, fill: float) -> torch.Tensor:
                out = torch.full((per, rows_p) + tuple(t.shape[2:]), fill, dtype=t.dtype)
                out[:, :rows_m] = t[cs, rs]
                return out.to(dev)

            H8, w = part(st.H8, 0), part(st.w, 0.0)
            lb_raw, ub_raw = part(st.lb_raw, -_BIG), part(st.ub_raw, _BIG)
            if st.int8_ok:
                H, lb, ub = _expand_f32(H8, lb_raw, ub_raw, w)
            else:
                H, lb, ub = part(st.H, 0.0), part(st.lb, -_BIG), part(st.ub, _BIG)
            row.append(
                ScoringTensors(
                    H=H,
                    lb=lb,
                    ub=ub,
                    x_ub=st.x_ub[cs].to(dev),
                    H8=H8,
                    lb_raw=lb_raw,
                    ub_raw=ub_raw,
                    w=w,
                    num_vars=st.num_vars,
                    num_residual_rows=st.num_residual_rows,
                    int8_ok=st.int8_ok,
                    x_ub_max=st.x_ub_max,
                )
            )
        shards.append(row)
        x_ubs.append(row[0].x_ub)
    return ShardedCases(mesh=mesh, shards=shards, x_ub=x_ubs)


def _local_score(shard: ScoringTensors, X: torch.Tensor) -> torch.Tensor:
    """Partial scores [cases, B] of candidates X [cases, B, Vp] against
    one row shard: K1 (`score_rows`) on the shard's device, on its int8
    path where `k1_planes` allows it and on its f32 path otherwise (JAX's
    f32 branch); K1's plain version on the CPU. The caller sums the
    shards (the psum over "model")."""
    return score_rows(shard, X.contiguous())[0]


def _psum(row: List[ScoringTensors], X_by_dev: dict) -> torch.Tensor:
    """Sum of the row's partial scores, on its first device, in shard
    order 0..m-1."""
    total = None
    for shard in row:
        part = _local_score(shard, X_by_dev[shard.H8.device])
        total = part if total is None else total + part.to(total.device)
    return total


def _replicas(row: List[ScoringTensors], X: torch.Tensor) -> dict:
    """X on every distinct device of the row (JAX replicates the pool over
    the model axis)."""
    out = {}
    for shard in row:
        dev = shard.H8.device
        if dev not in out:
            out[dev] = X if X.device == dev else X.to(dev)
    return out


def _move_of(k: torch.Tensor, vp: int):
    """(variable, sign) of move k of the dense set [0; I; -I] ([2 Vp + 1,
    Vp]): the null move (variable 0, sign 0), then +1 on each variable,
    then -1 on each."""
    var = torch.where(k <= vp, k - 1, k - 1 - vp).clamp(min=0)
    sign = torch.where(k == 0, 0.0, torch.where(k <= vp, 1.0, -1.0))
    return var, sign


def _move_chunk(k0: int, k1: int, vp: int, device) -> torch.Tensor:
    """Rows k0..k1-1 of the dense move set."""
    var, sign = _move_of(torch.arange(k0, k1, device=device), vp)
    moves = torch.zeros((k1 - k0, vp), dtype=torch.float32, device=device)
    moves[torch.arange(k1 - k0, device=device), var] = sign
    return moves


def _clip(x: torch.Tensor, x_ub: torch.Tensor) -> torch.Tensor:
    return torch.minimum(torch.clamp(x, min=0.0), x_ub)


def sharded_step(mesh: Mesh):
    """The case x model search step on `mesh` (JAX's `sharded_step`):
    `step(cases, X) -> (X', scores')` for a `ShardedCases` placed on the
    mesh and candidate pools X (one [cases per slot, pop, Vp] tensor per
    case slot, from `cases.put`).

    For every case it forms the candidates clip(X + move, 0, x_ub) of
    each member and each move of the dense set [0; I; -I] over Vp (padded
    variables have x_ub 0, so their moves clip to the null move), scores
    them on every row shard's device, sums the shards in shard order on
    the slot's first device, takes the first-minimum argmin over the
    moves and applies a member's best move only where it strictly
    improves that member's score. The move set has 2 Vp + 1 rows, so it
    is built and scored in chunks of moves (at most STEP_CHUNK_BYTES of
    f32 candidates per slot), carrying the running first minimum across
    chunks: a later chunk replaces it only with a strictly smaller
    score."""

    def step(cases: ShardedCases, X: Sequence[torch.Tensor]):
        if cases.mesh is not mesh and not np.array_equal(cases.mesh.devices, mesh.devices):
            raise ValueError("the cases were placed on another mesh")
        vp = cases.num_vars
        n_moves = 2 * vp + 1
        X_out, s_out = [], []
        for row, x_ub, Xc in zip(cases.shards, cases.x_ub, X):
            G, B, _ = Xc.shape
            chunk = max(1, min(n_moves, STEP_CHUNK_BYTES // max(1, 4 * G * B * vp)))
            reps = _replicas(row, Xc)
            bounds = {shard.H8.device: shard.x_ub for shard in row}
            base = _psum(row, reps)
            best = idx = None
            for k0 in range(0, n_moves, chunk):
                k1 = min(n_moves, k0 + chunk)
                cand = {}
                for dev, Xd in reps.items():
                    moves = _move_chunk(k0, k1, vp, dev)
                    cand[dev] = _clip(Xd[:, :, None, :] + moves, bounds[dev][:, None, None, :]).view(
                        G, B * (k1 - k0), vp
                    )
                total = _psum(row, cand).view(G, B, k1 - k0)
                del cand
                i_c = torch.argmin(total, dim=2)  # the first minimum
                s_c = torch.gather(total, 2, i_c[..., None])[..., 0]
                i_c = i_c + k0
                if best is None:
                    best, idx = s_c, i_c
                else:
                    better = s_c < best
                    best = torch.where(better, s_c, best)
                    idx = torch.where(better, i_c, idx)
            var, sign = _move_of(idx, vp)
            delta = torch.zeros_like(Xc).scatter_(2, var[..., None], sign[..., None])
            chosen = _clip(Xc + delta, x_ub[:, None, :])
            better = best < base
            X_out.append(torch.where(better[..., None], chosen, Xc))
            s_out.append(torch.where(better, best, base))
        return X_out, s_out

    return step


def solve_cases_sharded(
    progs: Sequence[BfbProgram],
    mesh: Optional[Mesh] = None,
    pop: Optional[int] = None,
    steps: Optional[int] = None,
    rounds: Optional[int] = None,
    seed: int = 0,
) -> List[np.ndarray]:
    """Solve a batch of cases data-parallel across the mesh; returns the
    best integer candidate per case. Each round runs greedy best-move
    steps on the mesh, then restarts every member from the per-case best
    with random kicks (the basin-hopping pattern of the device search,
    fanned over the case axis).

    The random draws (numpy, `seed`), the padding of the case list to a
    multiple of the case axis and the budgets are the JAX package's, line
    for line: AMBIGRAM_SHARD_POP / _STEPS / _ROUNDS (32 / 48 / 4) when an
    argument is None. A "step" is one greedy best-move application, not a
    descent sweep, so these knobs are apart from AMBIGRAM_SEARCH_*.
    `mesh=None` takes every visible card (`make_mesh()`)."""
    if pop is None:
        pop = int(os.environ.get("AMBIGRAM_SHARD_POP", 32))
    if steps is None:
        steps = int(os.environ.get("AMBIGRAM_SHARD_STEPS", 48))
    if rounds is None:
        rounds = int(os.environ.get("AMBIGRAM_SHARD_ROUNDS", 4))
    if mesh is None:
        mesh = make_mesh()
    case_dim = mesh.shape[0]
    C = len(progs)
    Cp = ((C + case_dim - 1) // case_dim) * case_dim
    padded = list(progs) + [progs[-1]] * (Cp - C)
    st = stack_cases(padded)
    V = st.H.shape[-1]
    rng = np.random.default_rng(seed)
    x_ub = st.x_ub.numpy()
    # diverse seeds: member 0 zero, rest sparse random loop starts
    X = np.zeros((Cp, pop, V), dtype=np.float32)
    T = len(progs[0].pairs) if progs else 0
    for ci in range(Cp):
        for b in range(1, pop):
            k = rng.integers(1, 4)
            idx = rng.integers(0, max(T, 1), size=k)
            X[ci, b, T + idx] = rng.integers(1, 3, size=k)
        X[ci] = np.minimum(X[ci], x_ub[ci])
    step = sharded_step(mesh)
    cases = shard_cases(st, mesh)
    del st
    best_x = np.zeros((Cp, V), dtype=np.float32)
    best_s = np.full(Cp, np.inf)
    Xj = cases.put(X)
    for r in range(rounds):
        scores = None
        for _ in range(steps):
            Xj, scores = step(cases, Xj)
        Xn = cases.gather(Xj)
        Sn = cases.gather(scores)
        for ci in range(Cp):
            b = int(np.argmin(Sn[ci]))
            if Sn[ci, b] < best_s[ci]:
                best_s[ci] = Sn[ci, b]
                best_x[ci] = Xn[ci, b]
        if r + 1 < rounds:
            # kick: restart members from the per-case best, bumping only
            # real (unpadded) variables
            kick = np.zeros((Cp, pop, V), dtype=np.float32)
            for ci in range(Cp):
                nv = padded[ci].num_vars
                for b in range(1, pop):
                    k = int(rng.integers(2, 6))
                    idx = rng.integers(0, nv, size=k)
                    kick[ci, b, idx] += rng.choice([-2, -1, 1, 2], size=k)
            Xn = np.clip(best_x[:, None, :] + kick, 0.0, x_ub[:, None, :])
            Xj = cases.put(Xn)
    out = []
    for i in range(C):
        out.append(np.round(best_x[i, : progs[i].num_vars]).astype(np.int64))
    return out
