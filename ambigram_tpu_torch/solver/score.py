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
(csrc/score_rows.cu) that replaces the Pallas `_score_kernel`. On a CUDA
tensor it launches the kernel or raises; its plain PyTorch version,
`score_rows_plain`, serves CPU tensors only.
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ambigram_tpu.engine.ilp import BfbProgram

PENALTY = 1024.0  # dominates any achievable residual for in-range programs
_BIG = 3.0e38  # finite stand-in for +-inf bounds

_LEAVES = ("H", "lb", "ub", "x_ub", "H8", "lb_raw", "ub_raw", "w")


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

    @property
    def use_int8(self) -> bool:
        """int8 scoring is exact only while candidates stay within int8;
        the search clips to x_ub, so that bound decides."""
        return self.int8_ok and self.x_ub_max <= 127.0

    def columns(self) -> torch.Tensor:
        """H.T as a contiguous [Vp, Rows] tensor (cached)."""
        if self._HT is None:
            self._HT = self.H.t().contiguous()
        return self._HT

    def to(self, device) -> "ScoringTensors":
        moved = {name: getattr(self, name).to(device) for name in _LEAVES}
        return dataclasses.replace(self, _HT=None, **moved)

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
    bounds, so any hx lands inside [-BIG, BIG] with zero hinge."""
    H = w[:, None] * H8.to(torch.float32)
    lb = torch.clamp(w * lb_raw, min=-_BIG)
    ub = torch.clamp(w * ub_raw, max=_BIG)
    pad = w == 0.0
    lb = torch.where(pad, -_BIG, lb)
    ub = torch.where(pad, _BIG, ub)
    return H, lb, ub


def scoring_tensors(prog: BfbProgram, device="cpu") -> ScoringTensors:
    """Assemble the scoring tensors of `prog` on `device`.

    The int8 representation is built on the host first. When it is exact
    (int8_ok: every current builder emits {+-1, +-2, 0.5*2} entries) only
    it crosses to the device and the f32 representation is expanded
    there (`_expand_f32`); otherwise the f32 representation is assembled
    on the host."""
    V = prog.num_vars
    Vp = _round_up(max(V, 128), 128)
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
    if int8_ok:
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
    (an exact integer product with an int32 accumulator, weights after
    the hinge), otherwise on the f32 one; both give the same scores.
    The int32 product runs on CPU tensors only: torch has no integer
    matmul on CUDA, and the device path scores through `score_rows`."""
    if st.use_int8:
        hx = torch.matmul(
            x.to(torch.int8).to(torch.int32), st.H8.to(torch.int32).t()
        ).to(torch.float32)
        over = torch.clamp(hx - st.ub_raw, min=0.0)
        under = torch.clamp(st.lb_raw - hx, min=0.0)
        return torch.sum(st.w * (over + under), dim=-1)
    return score_from_hx(st, matmul_f32(x, st.H.t()))


def score_rows_plain(
    st: ScoringTensors, X: torch.Tensor, want_hx: bool = False
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K1's plain PyTorch version: (scores [B], hx [B, Rows] or None)."""
    hx = matmul_f32(X, st.H.t())
    return score_from_hx(st, hx), (hx if want_hx else None)


_K1_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _k1_library() -> ctypes.CDLL:
    from ambigram_tpu_torch import kernels

    lib = kernels.load("score_rows")
    if lib.score_rows_launch.argtypes is None:
        lib.score_rows_launch.argtypes = _K1_ARGTYPES
        lib.score_rows_launch.restype = ctypes.c_int
        lib.score_rows_num_tiles.argtypes = [ctypes.c_int]
        lib.score_rows_num_tiles.restype = ctypes.c_int
        lib.score_rows_error_string.argtypes = [ctypes.c_int]
        lib.score_rows_error_string.restype = ctypes.c_char_p
    return lib


def score_rows(
    st: ScoringTensors, X: torch.Tensor, want_hx: bool = False
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Score candidates X [B, Vp] against all rows: (scores [B], hx
    [B, Rows] or None). The function of the Pallas `_score_kernel`
    (ambigram_tpu/solver/score.py), plus the hx it forms on the way.

    CUDA tensors launch K1 (csrc/score_rows.cu) and raise on any fault;
    CPU tensors take the plain version. `score_rows.launches` counts the
    kernel's launches."""
    H, lb, ub = st.H, st.lb, st.ub
    if X.dim() != 2 or H.dim() != 2 or X.shape[1] != H.shape[1]:
        raise ValueError("X %s does not match H %s" % (tuple(X.shape), tuple(H.shape)))
    tensors = (H, lb, ub, X)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("score_rows takes float32 tensors")
    if lb.shape != (H.shape[0],) or ub.shape != (H.shape[0],):
        raise ValueError("lb/ub must be [Rows]")
    if any(t.device != X.device for t in tensors):
        raise ValueError("H, lb, ub and X must be on one device")
    if X.device.type == "cpu":
        return score_rows_plain(st, X, want_hx)
    if X.device.type != "cuda":
        raise ValueError("score_rows runs on cpu or cuda, not %s" % X.device)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("score_rows needs contiguous tensors")
    lib = _k1_library()
    B, Vp = X.shape
    rows = H.shape[0]
    scores = torch.empty(B, dtype=torch.float32, device=X.device)
    hx = torch.empty((B, rows), dtype=torch.float32, device=X.device) if want_hx else None
    if B == 0:
        return scores, hx
    partial = torch.empty(
        (lib.score_rows_num_tiles(rows), B), dtype=torch.float32, device=X.device
    )
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        err = lib.score_rows_launch(
            H.data_ptr(),
            lb.data_ptr(),
            ub.data_ptr(),
            X.data_ptr(),
            hx.data_ptr() if hx is not None else None,
            partial.data_ptr(),
            scores.data_ptr(),
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
    score_rows.launches += 1
    return scores, hx


score_rows.launches = 0
