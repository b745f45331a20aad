"""Scoring tensors and the batched candidate scorer, in PyTorch.

Port of ambigram_tpu/solver/score.py. A candidate x = [patterns | loops]
scores as the sum of two hinges over the unified rows H = [A; PENALTY*G]:

    score(x) = sum_r max(H[r].x - ub[r], 0) + max(lb[r] - H[r].x, 0)

Every entry of H and of a candidate is a small integer or a multiple of
0.5 and every partial sum of a row value stays below 2^24, so hx = x.H^T
is exact in f32 in any order and the port agrees with the JAX package
bitwise on H, the bounds and hx. A score is exact too while the targets
are integers (the 0.5 lattice) and it stays below 2^23. Noisy cases have
fractional targets: their hinges round, and two sums of the same hinges
in different orders may differ in the last bit (about 1e-7 relative).

`score_rows` is the wrapper of K1, the hand-written CUDA kernel
(csrc/score_rows.cu) that replaces the Pallas `_score_kernel`: on the
int8 tensor cores when the program's rows are int8-exact (`k1_planes`),
otherwise in f32 FFMA on the CUDA cores, the Pallas kernel's own
arithmetic (a register-tiled product whose block shape follows B). `chained_score` is the wrapper of K2
(csrc/chained_score.cu, wgmma), which replaces the Pallas
`_chained_kernel` of the benchmark chain. On a CUDA tensor each launches
its kernel or raises; its plain PyTorch version (`score_rows_plain`,
`chained_score_plain`) serves CPU tensors only. `score_rows_int8_plain`
mirrors the arithmetic of K1's int8 path on the CPU.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import math
import threading
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ambigram_tpu_torch.engine.ilp import BfbProgram

PENALTY = 1024.0  # dominates any achievable residual for in-range programs
_BIG = 3.0e38  # finite stand-in for +-inf bounds

_LEAVES = ("H", "lb", "ub", "x_ub", "H8", "lb_raw", "ub_raw", "w")

# guards the kernels' launch counts: the batch pipeline's round-robin
# searches launch K1 from several threads at once, and += is a
# read-modify-write
_COUNT_LOCK = threading.Lock()


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class ScoringTensors:
    """Padded tensors for one fitting program (layout of the JAX
    package's ScoringTensors).

    f32: H [Rows, Vp] unified rows (residual rows of A with lb = ub = c,
    then hard rows of G prescaled by PENALTY), lb/ub [Rows] row bounds.
    int8: H8 [Rows, Vp] the same rows with FBI rows doubled, G unscaled;
    lb_raw/ub_raw the matching unscaled bounds; w [Rows] hinge weights
    (1 / 0.5 / PENALTY, 0 on padding) applied after the hinge.
    x_ub [Vp] variable upper bounds (0 on padding lanes)."""

    H: torch.Tensor
    lb: torch.Tensor
    ub: torch.Tensor
    x_ub: torch.Tensor
    H8: torch.Tensor
    lb_raw: torch.Tensor
    ub_raw: torch.Tensor
    w: torch.Tensor
    num_vars: int
    num_residual_rows: int
    int8_ok: bool
    x_ub_max: float
    # H.T made contiguous, built on first use by `columns()`: the sweeps
    # gather columns of H, which are rows of HT
    _HT: Optional[torch.Tensor] = dataclasses.field(default=None, repr=False)
    # max |H8|, read on first use by `int8_hx_exact()`
    _h8_absmax: Optional[int] = dataclasses.field(default=None, repr=False)

    @property
    def use_int8(self) -> bool:
        """int8 scoring is exact only while candidates stay within int8;
        the search clips to x_ub, so that bound decides."""
        return self.int8_ok and self.x_ub_max <= 127.0

    def h8_absmax(self) -> int:
        """max |H8| (read from the tensor once, then cached)."""
        if self._h8_absmax is None:
            h = self.H8.to(torch.int16).abs()
            self._h8_absmax = int(h.max()) if h.numel() else 0
        return self._h8_absmax

    def int8_hx_exact(self) -> bool:
        """Whether every partial sum of an int8 row value x.H8[r], for
        candidates in [0, 127], stays below 2^24: then an f32 product of
        the int8 values is exact and equals the int32 one. Builders emit
        |H8| <= 2, so this holds for any Vp below about 33k."""
        return self.h8_absmax() * 127 * self.H8.shape[-1] < 2**24

    def columns(self) -> torch.Tensor:
        """H.T as a contiguous [..., Vp, Rows] tensor (cached)."""
        if self._HT is None:
            self._HT = self.H.transpose(-1, -2).contiguous()
        return self._HT

    def to(self, device) -> "ScoringTensors":
        moved = {name: getattr(self, name).to(device) for name in _LEAVES}
        return dataclasses.replace(self, _HT=None, **moved)

    def case(self, g: int) -> "ScoringTensors":
        """Case g of a case-stacked set (`parallel.mesh.stack_cases`:
        every leaf has a leading case axis) as a single-case set."""
        return dataclasses.replace(self, _HT=None, **{name: getattr(self, name)[g] for name in _LEAVES})

    @classmethod
    def from_numpy(
        cls,
        *,
        num_vars: int,
        num_residual_rows: int,
        int8_ok: bool,
        x_ub_max: float,
        device="cpu",
        **arrays: np.ndarray,
    ) -> "ScoringTensors":
        """Build from host arrays, e.g. the leaves of a JAX
        ScoringTensors (`np.asarray` of each) and its static fields, so
        both packages score identical tensors."""
        missing = set(_LEAVES) - set(arrays)
        extra = set(arrays) - set(_LEAVES)
        if missing or extra:
            raise ValueError("leaves missing %s, unknown %s" % (sorted(missing), sorted(extra)))
        return cls(
            **{k: torch.as_tensor(np.array(arrays[k]), device=device) for k in _LEAVES},
            num_vars=int(num_vars),
            num_residual_rows=int(num_residual_rows),
            int8_ok=bool(int8_ok),
            x_ub_max=float(x_ub_max),
        )


def _expand_f32(H8, lb_raw, ub_raw, w):
    """The prescaled f32 representation from the int8 one, on the
    tensors' device: H = w * H8 row-wise (exact: w in {1, 0.5, PENALTY}
    and entries are small integers), bounds = w * raw bounds clamped to
    +-BIG (w * +-BIG overflows f32 to +-inf on PENALTY rows; the clamp
    restores the finite convention). Padding rows (w == 0) keep open
    bounds, so any hx lands inside [-BIG, BIG] with zero hinge.

    Leading case axes broadcast through, so one call also expands a
    case-stacked set (the JAX package's vmapped `_expand_f32_cases`)."""
    H = w[..., None] * H8.to(torch.float32)
    lb = torch.clamp(w * lb_raw, min=-_BIG)
    ub = torch.clamp(w * ub_raw, max=_BIG)
    pad = w == 0.0
    lb = torch.where(pad, -_BIG, lb)
    ub = torch.where(pad, _BIG, ub)
    return H, lb, ub


def scoring_tensors(
    prog: BfbProgram,
    device="cpu",
    pad_vars: Optional[int] = None,
    need_f32: bool = True,
) -> ScoringTensors:
    """Assemble the scoring tensors of `prog` on `device`.

    The int8 representation is built on the host first. When it is exact
    (int8_ok: every current builder emits {+-1, +-2, 0.5*2} entries) only
    it crosses to the device and the f32 representation is expanded
    there (`_expand_f32`); otherwise the f32 representation is assembled
    on the host.

    `pad_vars` pads the variables to that width instead of the next
    multiple of 128. need_f32=False skips the f32 representation when
    the int8 one is exact and leaves 1-row f32 placeholders: for
    `stack_cases`, which expands the stacked int8 set itself."""
    V = prog.num_vars
    Vp = pad_vars if pad_vars is not None else _round_up(max(V, 128), 128)
    # residual rows: [seg | fbi | coupling]
    R0 = prog.A_seg.shape[0] + prog.A_fbi.shape[0]
    P = prog.num_coupling
    R = R0 + P
    M = prog.G.shape[0]
    rows = R + M
    Rp = _round_up(max(rows, 256), 256)
    x_ub = np.zeros(Vp, dtype=np.float32)
    x_ub[:V] = prog.x_ub
    x_ub_max = float(prog.x_ub.max()) if V else 0.0

    # int8 representation: double the FBI rows so the 0.5 coefficients
    # become integers, keep G unscaled, weight the hinges instead;
    # coupling rows are +-1 already (weight 1, target 0)
    n_seg = prog.A_seg.shape[0]
    A_int = np.concatenate([prog.A_seg, 2.0 * prog.A_fbi], axis=0)
    c_int = np.concatenate([prog.c_seg, 2.0 * prog.c_fbi])
    H8 = np.zeros((Rp, Vp), dtype=np.int8)
    a8 = A_int.astype(np.int8)
    int8_ok = bool(np.array_equal(a8.astype(np.float64), A_int))
    del A_int
    H8[:R0, :V] = a8
    if P:
        rr = R0 + np.arange(P)
        H8[rr, prog.coupling[:, 0]] = 1
        H8[rr, prog.coupling[:, 1]] = -1
    lb_raw = np.full(Rp, -_BIG, dtype=np.float32)
    ub_raw = np.full(Rp, _BIG, dtype=np.float32)
    lb_raw[:R0] = c_int
    ub_raw[:R0] = c_int
    lb_raw[R0:R] = 0.0
    ub_raw[R0:R] = 0.0
    w = np.zeros(Rp, dtype=np.float32)
    w[:n_seg] = 1.0
    w[n_seg:R0] = 0.5
    w[R0:R] = 1.0
    if M:
        if prog.G.dtype == np.int8:
            g8 = prog.G
        else:
            g8 = prog.G.astype(np.int8)
            int8_ok = int8_ok and bool(np.array_equal(g8.astype(np.float64), prog.G))
        H8[R : R + M, :V] = g8
        lb_raw[R : R + M] = np.maximum(prog.g_lb, -_BIG)
        ub_raw[R : R + M] = np.minimum(prog.g_ub, _BIG)
        w[R : R + M] = PENALTY

    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a).to(device)

    H8t, lbr, ubr, wt = dev(H8), dev(lb_raw), dev(ub_raw), dev(w)
    if int8_ok and not need_f32:
        H = dev(np.zeros((1, Vp), dtype=np.float32))
        lb, ub = dev(np.zeros(1, dtype=np.float32)), dev(np.zeros(1, dtype=np.float32))
    elif int8_ok:
        H, lb, ub = _expand_f32(H8t, lbr, ubr, wt)
    else:
        # host f32 assembly (fractional-coefficient programs)
        A_np = np.concatenate([prog.A_seg, prog.A_fbi], axis=0)
        c_np = np.concatenate([prog.c_seg, prog.c_fbi], axis=0)
        Hn = np.zeros((Rp, Vp), dtype=np.float32)
        lbn = np.full(Rp, -_BIG, dtype=np.float32)
        ubn = np.full(Rp, _BIG, dtype=np.float32)
        Hn[:R0, :V] = A_np
        lbn[:R0] = c_np
        ubn[:R0] = c_np
        if P:
            rr = R0 + np.arange(P)
            Hn[rr, prog.coupling[:, 0]] = 1.0
            Hn[rr, prog.coupling[:, 1]] = -1.0
            lbn[R0:R] = 0.0
            ubn[R0:R] = 0.0
        if M:
            Hn[R : R + M, :V] = PENALTY * prog.G
            lbn[R : R + M] = np.maximum(PENALTY * prog.g_lb, -_BIG)
            ubn[R : R + M] = np.minimum(PENALTY * prog.g_ub, _BIG)
        H, lb, ub = dev(Hn), dev(lbn), dev(ubn)
    return ScoringTensors(
        H=H,
        lb=lb,
        ub=ub,
        x_ub=dev(x_ub),
        H8=H8t,
        lb_raw=lbr,
        ub_raw=ubr,
        w=wt,
        num_vars=V,
        num_residual_rows=R,
        int8_ok=int8_ok,
        x_ub_max=x_ub_max,
    )


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in full f32. TF32 would round the exact integer products,
    so CUDA tensors require it off, torch's default; this raises rather
    than flip the process-wide flag."""
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matmul is enabled; the exact f32 scorer needs it off")
    return a @ b


def score_from_hx(st: ScoringTensors, hx: torch.Tensor) -> torch.Tensor:
    """Hinge score given precomputed row values hx = x @ H.T."""
    over = torch.clamp(hx - st.ub, min=0.0)
    under = torch.clamp(st.lb - hx, min=0.0)
    return over.sum(dim=-1) + under.sum(dim=-1)


def score_batch(st: ScoringTensors, x: torch.Tensor) -> torch.Tensor:
    """Plain scorer of candidates x [..., Vp] (f32, integer-valued, in
    [0, x_ub]): residual + PENALTY * violation, shape [...].

    On the int8 representation when the program and candidate box permit
    (weights after the hinge), otherwise on the f32 one; both give the
    same scores. The int8 row values are one f32 product of the
    candidates, truncated as the int8 cast truncates them, with H8 cast
    to f32: every product and partial sum is an integer below 2^24
    (`int8_hx_exact`, checked), so it equals the int32-accumulated
    product bitwise, on any device (torch has no integer matmul on
    CUDA). The weighted hinge terms (f32, as in the JAX package) are
    summed in f64 and the sum rounded once to f32: for integer targets
    the f64 sum is exact, so the score does not depend on the order of
    the sum even above 2^24, where f32 sums in different orders differ
    (K2 computes the same value). Below 2^24 it equals any f32 sum."""
    if st.use_int8:
        if not st.int8_hx_exact():
            raise ValueError("int8 row values can reach 2^24: an f32 product would round")
        hx = matmul_f32(torch.trunc(x), st.H8.to(torch.float32).t())
        over = torch.clamp(hx - st.ub_raw, min=0.0)
        under = torch.clamp(st.lb_raw - hx, min=0.0)
        return torch.sum(st.w * (over + under), dim=-1, dtype=torch.float64).to(torch.float32)
    return score_from_hx(st, matmul_f32(x, st.H.t()))


def k1_planes(st: ScoringTensors) -> int:
    """How K1 reads `st`: 1 or 2 u8 planes of the candidates on the int8
    path, 0 for the f32 path. The int8 path needs rows that are
    int8-exact (then H = w * H8 row-wise, w in {0, 0.5, 1, 1024}), Rows
    and Vp in multiples of 64, candidates below 2^16 (the box x_ub) and
    every row value below 2^24: ceil(x_ub_max) * max|H8| * Vp < 2^24,
    so hx_int converts to f32 exactly and hx = w * hx_int is bitwise the
    f32 product of H. Decided from the representation before launch.

    The bound is the box's, not the rows': the big leg's recipe (seed
    300 + S, noise 0.05) passes it at S=96 (0.916 of 2^24) but not at
    S=120 (4.2) or S=128 (2.59, also without noise), the first recipe
    cases that take the f32 path. Their rows' own bound, max_r
    sum_k |H8[r, k]| * x_ub[k], is 0.652 of 2^24 at S=128, so every
    partial sum of an S=128 row value is exact in f32 and the f32 path
    is bitwise there; at S=120 it is 1.055, so row values can pass 2^24
    and every f32 summation order rounds them differently."""
    if not st.int8_ok:
        return 0
    rows, vp = st.H8.shape[-2:]
    x_max = math.ceil(st.x_ub_max)
    if rows % 64 or vp % 64 or x_max >= 2**16:
        return 0
    if x_max * st.h8_absmax() * vp >= 2**24:
        return 0
    return 1 if x_max < 2**8 else 2


def score_rows_plain(
    st: ScoringTensors, X: torch.Tensor, want_hx: bool = False
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K1's plain PyTorch version: (scores [B], hx [B, Rows] or None).
    With a leading case axis (a `stack_cases` set, X [G, B, Vp]) it is
    the loop over the cases: ([G, B], [G, B, Rows] or None)."""
    if X.dim() == 3:
        outs = [score_rows_plain(st.case(g), X[g], want_hx) for g in range(X.shape[0])]
        scores = torch.stack([s for s, _ in outs])
        return scores, (torch.stack([h for _, h in outs]) if want_hx else None)
    hx = matmul_f32(X, st.H.t())
    return score_from_hx(st, hx), (hx if want_hx else None)


def score_rows_int8_plain(
    st: ScoringTensors, X: torch.Tensor, want_hx: bool = False
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The arithmetic of K1's int8 path in plain PyTorch, on the CPU
    (torch has no int32 matmul on CUDA): the candidates truncated to u8
    planes (the low byte, and the high byte when `k1_planes` says 2),
    each plane's int32 product with H8, hx = w * float(256 hi + lo), then
    the f32 hinges of `score_from_hx`. Bitwise equal to
    `score_rows_plain` wherever `k1_planes` is not 0."""
    planes = k1_planes(st)
    if not planes:
        raise ValueError("the rows are not int8-exact for K1's int8 path (k1_planes is 0)")
    if X.dim() == 3:
        outs = [score_rows_int8_plain(st.case(g), X[g], want_hx) for g in range(X.shape[0])]
        scores = torch.stack([s for s, _ in outs])
        return scores, (torch.stack([h for _, h in outs]) if want_hx else None)
    xi = torch.trunc(X).to(torch.int32)
    H8t = st.H8.to(torch.int32).t()
    hx_int = torch.zeros((X.shape[0], H8t.shape[1]), dtype=torch.int32, device=X.device)
    for p in range(planes):
        hx_int += (256**p) * torch.matmul((xi >> (8 * p)) & 255, H8t)
    hx = st.w * hx_int.to(torch.float32)
    return score_from_hx(st, hx), (hx if want_hx else None)


_K1_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_K1_I8_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _k1_library() -> ctypes.CDLL:
    from ambigram_tpu_torch import kernels

    lib = kernels.load("score_rows")
    if lib.score_rows_launch.argtypes is None:
        lib.score_rows_launch.argtypes = _K1_ARGTYPES
        lib.score_rows_launch.restype = ctypes.c_int
        lib.score_rows_f32_scratch_bytes.argtypes = [ctypes.c_int] * 4
        lib.score_rows_f32_scratch_bytes.restype = ctypes.c_longlong
        lib.score_rows_i8_launch.argtypes = _K1_I8_ARGTYPES
        lib.score_rows_i8_launch.restype = ctypes.c_int
        lib.score_rows_i8_scratch_bytes.argtypes = [ctypes.c_int] * 5
        lib.score_rows_i8_scratch_bytes.restype = ctypes.c_longlong
        lib.score_rows_error_string.argtypes = [ctypes.c_int]
        lib.score_rows_error_string.restype = ctypes.c_char_p
    return lib


def score_rows(
    st: ScoringTensors, X: torch.Tensor, want_hx: bool = False
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Score candidates X [B, Vp] against all rows: (scores [B], hx
    [B, Rows] or None). The function of the Pallas `_score_kernel`
    (ambigram_tpu/solver/score.py), plus the hx it forms on the way.
    A case-stacked set (`stack_cases`: H [G, Rows, Vp], lb/ub [G, Rows])
    takes X [G, B, Vp] and scores every case in one launch: ([G, B],
    [G, B, Rows] or None), bitwise equal to G single-case calls.

    CUDA tensors launch K1 (csrc/score_rows.cu) and raise on any fault:
    its int8 tensor-core path (H8 and w) when `k1_planes(st)` allows it,
    else its f32 path (H). X must hold the search's candidates: integers
    in [0, x_ub]. CPU tensors take the plain version.
    `score_rows.launches` counts the kernel's launches, and
    `score_rows.int8_launches` and `score_rows.f32_launches` each path's
    (under a lock: several threads may launch at once)."""
    H, lb, ub = st.H, st.lb, st.ub
    if X.dim() not in (2, 3) or H.dim() != X.dim() or X.shape[-1] != H.shape[-1] or (
        X.dim() == 3 and X.shape[0] != H.shape[0]
    ):
        raise ValueError("X %s does not match H %s" % (tuple(X.shape), tuple(H.shape)))
    tensors = (H, lb, ub, X)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("score_rows takes float32 tensors")
    if lb.shape != H.shape[:-1] or ub.shape != H.shape[:-1]:
        raise ValueError("lb/ub must be [Rows] ([G, Rows] with a case axis)")
    if any(t.device != X.device for t in tensors):
        raise ValueError("H, lb, ub and X must be on one device")
    if X.device.type == "cpu":
        return score_rows_plain(st, X, want_hx)
    if X.device.type != "cuda":
        raise ValueError("score_rows runs on cpu or cuda, not %s" % X.device)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("score_rows needs contiguous tensors")
    lib = _k1_library()
    cases = X.shape[0] if X.dim() == 3 else 1
    B, Vp = X.shape[-2:]
    rows = H.shape[-2]
    lead = X.shape[:-1]
    scores = torch.empty(lead, dtype=torch.float32, device=X.device)
    hx = torch.empty(lead + (rows,), dtype=torch.float32, device=X.device) if want_hx else None
    if B == 0 or cases == 0:
        return scores, hx
    planes = k1_planes(st)
    dev = X.device
    if planes and (
        st.H8.shape != H.shape
        or st.w.shape != lb.shape
        or st.H8.device != dev
        or st.w.device != dev
        or not (st.H8.is_contiguous() and st.w.is_contiguous())
    ):
        raise ValueError("H8 and w must match H and lb, contiguous, on X's device")
    with torch.cuda.device(dev) if dev.index != torch.cuda.current_device() else contextlib.nullcontext():
        stream = torch.cuda.current_stream().cuda_stream
        if planes:
            scratch = torch.empty(
                lib.score_rows_i8_scratch_bytes(cases, B, rows, Vp, planes), dtype=torch.uint8, device=dev
            )
            err = lib.score_rows_i8_launch(
                st.H8.data_ptr(),
                st.w.data_ptr(),
                lb.data_ptr(),
                ub.data_ptr(),
                X.data_ptr(),
                scratch.data_ptr(),
                hx.data_ptr() if hx is not None else None,
                scores.data_ptr(),
                cases,
                B,
                rows,
                Vp,
                planes,
                stream,
            )
        else:
            scratch = torch.empty(
                lib.score_rows_f32_scratch_bytes(cases, B, rows, Vp), dtype=torch.uint8, device=dev
            )
            err = lib.score_rows_launch(
                H.data_ptr(),
                lb.data_ptr(),
                ub.data_ptr(),
                X.data_ptr(),
                scratch.data_ptr(),
                hx.data_ptr() if hx is not None else None,
                scores.data_ptr(),
                cases,
                B,
                rows,
                Vp,
                stream,
            )
    if err != 0:
        raise RuntimeError(
            "score_rows kernel launch failed: %s (cudaError %d)"
            % (lib.score_rows_error_string(err).decode(), err)
        )
    _count_k1_launch(planes)
    return scores, hx


def _count_k1_launch(planes: int) -> None:
    """Add one launch of K1 on its int8 path (planes > 0) or its f32
    path to `score_rows`'s counts."""
    with _COUNT_LOCK:
        score_rows.launches += 1
        if planes:
            score_rows.int8_launches += 1
        else:
            score_rows.f32_launches += 1


score_rows.launches = 0
score_rows.int8_launches = 0
score_rows.f32_launches = 0


# ------------------------------------------------- the benchmark chain (K2)

_HEAD = 128  # lanes the chain mutates


def chained_mutate(X: torch.Tensor, s: torch.Tensor, i: int, x_ub: torch.Tensor) -> torch.Tensor:
    """The benchmark chain's data-dependent mutation (the JAX package's
    `chained_mutate`): lane j < 128 of candidate b gains 1 where
    ((s[b] + j) + i) mod 7 < 1, then is clipped to x_ub[j] (no lower
    clip). The order of the f32 adds is the JAX one: at s ~ 5e7 each
    add rounds, and another order would flip bumps. The operand is
    never negative, so fmod is the floor modulo of `%`."""
    lane = torch.arange(_HEAD, dtype=torch.float32, device=X.device)
    t = (s[:, None] + lane) + float(i)
    bump = (torch.fmod(t, 7.0) < 1.0).to(X.dtype)
    head = torch.minimum(X[:, :_HEAD] + bump, x_ub[:_HEAD])
    return torch.cat([head, X[:, _HEAD:]], dim=1)


def chained_score_plain(
    st: ScoringTensors, X: torch.Tensor, iters: int, want_x: bool = False
):
    """K2's plain PyTorch version: the loop of the JAX bench's `chained`
    (`iters` rounds of int8 `score_batch`, `chained_mutate`, acc += sum
    of the scores). Returns the f32 checksum as a 0-d tensor, and the
    final candidates too when `want_x`."""
    acc = torch.zeros((), dtype=torch.float32, device=X.device)
    for i in range(iters):
        s = score_batch(st, X)
        X = chained_mutate(X, s, i, st.x_ub)
        acc = acc + torch.sum(s)
    return (acc, X) if want_x else acc


_K2_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _k2_library() -> ctypes.CDLL:
    from ambigram_tpu_torch import kernels

    lib = kernels.load("chained_score")
    if lib.chained_score_launch.argtypes is None:
        lib.chained_score_launch.argtypes = _K2_ARGTYPES
        lib.chained_score_launch.restype = ctypes.c_int
        lib.chained_score_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.chained_score_smem_bytes.restype = ctypes.c_int
        lib.chained_score_error_string.argtypes = [ctypes.c_int]
        lib.chained_score_error_string.restype = ctypes.c_char_p
    return lib


K2_BLOCK_B = (64, 128)  # candidates per CTA the kernel is built for (1 or 2 consumer warpgroups)
K2_MAX_SMEM = 232448  # shared memory one H100 block may use


def chained_score(
    st: ScoringTensors, X: torch.Tensor, iters: int, block_b: int = 128, want_x: bool = False
):
    """The benchmark chain on candidates X [B, Vp] for `iters` rounds:
    the function of the Pallas `_chained_kernel` (ambigram_tpu/solver/
    score.py). Returns the f32 checksum (0-d), and the final candidates
    too when `want_x`.

    CUDA tensors launch K2 (csrc/chained_score.cu): one CTA per
    `block_b` candidates, so B must be a multiple of it; Vp a multiple
    of 128 and Rows of 256, as `scoring_tensors` pads them. The kernel
    reads H8 [Rows, Vp] as it is, through a TMA tensor map; the wrapper
    packs the row bounds as (lb_raw, ub_raw, w, 0) per row and hands
    over the 128 head lanes of X as a [B, 128] buffer the kernel updates.
    CPU tensors take the plain version. `chained_score.launches` counts
    the kernel's launches."""
    if not st.use_int8:
        raise ValueError("the chain runs on the int8 representation (use_int8 is False)")
    if X.dim() != 2 or X.shape[1] != st.H8.shape[1] or X.dtype != torch.float32:
        raise ValueError("X must be float32 [B, %d], got %s %s" % (st.H8.shape[1], X.dtype, tuple(X.shape)))
    B, Vp = X.shape
    rows = st.H8.shape[0]
    if block_b not in K2_BLOCK_B:
        raise ValueError("block_b must be one of %s" % (K2_BLOCK_B,))
    if B % block_b:
        raise ValueError(
            "batch %d must be divisible by block_b %d (the grid would drop the remainder)" % (B, block_b)
        )
    if Vp % 128 or rows % 256:
        raise ValueError("Vp %d must be a multiple of 128 and Rows %d of 256" % (Vp, rows))
    if not st.int8_hx_exact():
        raise ValueError("int8 row values can reach 2^24: their f32 conversion would round")
    leaves = (st.H8, st.lb_raw, st.ub_raw, st.w, st.x_ub)
    if any(t.device != X.device for t in leaves):
        raise ValueError("the scoring tensors and X must be on one device")
    if X.device.type == "cpu":
        return chained_score_plain(st, X, iters, want_x)
    if X.device.type != "cuda":
        raise ValueError("chained_score runs on cpu or cuda, not %s" % X.device)
    if not X.is_contiguous() or X.data_ptr() % 16:
        raise ValueError("chained_score needs a contiguous, 16-byte aligned X")
    lib = _k2_library()
    smem = lib.chained_score_smem_bytes(block_b, Vp)
    if smem > K2_MAX_SMEM:
        raise ValueError(
            "block_b %d at Vp %d needs %d bytes of shared memory (max %d)" % (block_b, Vp, smem, K2_MAX_SMEM)
        )
    H8 = st.H8.contiguous()
    bounds = torch.stack([st.lb_raw, st.ub_raw, st.w, torch.zeros_like(st.w)], dim=1).contiguous()
    x_ub = st.x_ub.contiguous()
    head = X[:, :_HEAD].clone(memory_format=torch.contiguous_format)  # the kernel updates it
    blocks = torch.empty(B // block_b, dtype=torch.float32, device=X.device)
    checksum = torch.zeros((), dtype=torch.float32, device=X.device)
    if B == 0:
        return (checksum, X.clone()) if want_x else checksum
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        err = lib.chained_score_launch(
            H8.data_ptr(),
            bounds.data_ptr(),
            x_ub.data_ptr(),
            X.data_ptr(),
            head.data_ptr(),
            blocks.data_ptr(),
            checksum.data_ptr(),
            B,
            rows,
            Vp,
            iters,
            block_b,
            stream,
        )
    if err != 0:
        raise RuntimeError(
            "chained_score kernel launch failed: %s (error %d)" % (lib.chained_score_error_string(err).decode(), err)
        )
    with _COUNT_LOCK:
        chained_score.launches += 1
    if want_x:
        return checksum, torch.cat([head, X[:, _HEAD:]], dim=1)
    return checksum


chained_score.launches = 0


def reset_launch_counts() -> None:
    """Set every kernel's launch counts to 0."""
    with _COUNT_LOCK:
        score_rows.launches = score_rows.int8_launches = score_rows.f32_launches = 0
        chained_score.launches = 0
