"""Case stacking: several fitting programs as one leading-case-axis set.

Port of `stack_cases` (ambigram_tpu/parallel/mesh.py). The case-stacked
batch search (`solver.search.solve_device_batch`) scores a whole
same-shape group with one launch per step. The mesh, the sharded step
and `solve_cases_sharded` come with multi-GPU support; on one card the
batch path never reaches them.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ambigram_tpu.engine.ilp import BfbProgram
from ambigram_tpu_torch.solver.score import _BIG, ScoringTensors, _expand_f32, scoring_tensors


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
