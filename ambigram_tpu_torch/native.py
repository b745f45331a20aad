"""ctypes bridge to the native (C++) runtime components.

Copy of ambigram_tpu/native.py. Components under the repo's native/:
- bfb_replay.cpp      lazy order-enumeration + path replay (the host
                      hot loop; reference LGM.cpp:3380-3697)
- bnb_solver.cpp      the exact branch-and-bound (solver/native_bnb.py)

Where the copy differs: it builds the repo's native/*.cpp with g++ into
ambigram_tpu_torch/_build/ (never into native/build/), each library
under a temporary name first and then renamed into place, so processes
that build it at once never load a half-written file. Everything
degrades gracefully to the pure-Python implementations when a
toolchain is unavailable.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_NATIVE_DIR = os.path.join(os.path.dirname(_PKG_DIR), "native")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_LOCK = threading.Lock()
_LIBS: Dict[str, Optional[ctypes.CDLL]] = {}


def _build_lib(name: str) -> Optional[ctypes.CDLL]:
    src = os.path.join(_NATIVE_DIR, name + ".cpp")
    if not os.path.exists(src):
        return None
    os.makedirs(_BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(_BUILD_DIR, "lib%s.so" % name)
    try:
        if not os.path.exists(lib_path) or os.path.getmtime(lib_path) < os.path.getmtime(src):
            tmp = "%s.%d.tmp" % (lib_path, os.getpid())
            subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, src],
                check=True,
                capture_output=True,
            )
            os.replace(tmp, lib_path)
        return ctypes.CDLL(lib_path)
    except Exception:
        return None


def _get_lib(name: str) -> Optional[ctypes.CDLL]:
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = _build_lib(name)
        return _LIBS[name]


def replay_available() -> bool:
    return _get_lib("bfb_replay") is not None


def bnb_available() -> bool:
    return _get_lib("bnb_solver") is not None


def native_bnb(
    H: np.ndarray,
    lb: np.ndarray,
    ub: np.ndarray,
    n_res: int,
    x_ub: np.ndarray,
    order: np.ndarray,
    warm_x: Optional[np.ndarray] = None,
    warm_eps: float = 1e300,
    node_cap: int = 20_000_000,
    time_limit_s: float = 0.0,
):
    """Run the native exact branch-and-bound. time_limit_s <= 0 means no
    wall-clock limit. Returns (x, eps, proven_optimal, nodes) or None
    when unavailable."""
    lib = _get_lib("bnb_solver")
    if lib is None:
        return None
    n_rows, V = H.shape
    H64 = np.ascontiguousarray(H, dtype=np.float64)
    lb64 = np.ascontiguousarray(lb, dtype=np.float64)
    ub64 = np.ascontiguousarray(ub, dtype=np.float64)
    xub32 = np.ascontiguousarray(x_ub, dtype=np.int32)
    ord32 = np.ascontiguousarray(order, dtype=np.int32)
    warm32 = (
        np.ascontiguousarray(warm_x, dtype=np.int32)
        if warm_x is not None
        else np.zeros(V, dtype=np.int32)
    )
    out_x = np.zeros(V, dtype=np.int32)
    out_eps = ctypes.c_double(0.0)
    out_nodes = ctypes.c_longlong(0)
    fn = lib.bfb_bnb
    fn.restype = ctypes.c_int

    def dptr(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))

    def iptr(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))

    rc = fn(
        ctypes.c_int(n_rows),
        ctypes.c_int(n_res),
        ctypes.c_int(V),
        dptr(H64),
        dptr(lb64),
        dptr(ub64),
        iptr(xub32),
        iptr(ord32),
        iptr(warm32) if warm_x is not None else None,
        ctypes.c_double(warm_eps),
        ctypes.c_longlong(node_cap),
        ctypes.c_double(time_limit_s),
        iptr(out_x),
        ctypes.byref(out_eps),
        ctypes.byref(out_nodes),
    )
    if rc < 0:
        return None
    return out_x.astype(np.int64), float(out_eps.value), rc == 1, int(out_nodes.value)


def native_bfb_replay(
    adj: List[List[int]],
    node2pat: List[List[int]],
    node2loop: List[List[int]],
    inversions: Dict[int, Tuple[int, int]],
    is_reversed: bool = False,
    max_replays: Optional[int] = None,
) -> Optional[List[Tuple[int, int]]]:
    """Run the native replay. inversions: seg_id -> (junction source id,
    junction target id). Returns [(seg_id, dir +1/-1), ...], [] when no
    order succeeds, or None when the native lib is unavailable.

    `max_replays` bounds the order enumeration PER orientation pass
    (forward and the reverse retry each get the full budget), and a
    derived WORK budget (64 splice-traffic units per budgeted replay,
    native/bfb_replay.cpp) bounds actual time even when large-CN
    incumbents make individual replays expensive. The default comes
    from AMBIGRAM_MAX_REPLAYS (1e6 ≈ a few seconds of C time per
    pass). 0 = unbounded — the reference's exact behavior
    (LGM.cpp:3380-3409 enumerates every topological order), which on a
    wide DAG whose orders ALL fail to replay is a factorial-time hang:
    a noisy S=32 heuristic solution was observed to burn 30+
    CPU-minutes here. Bounded-budget runs that exhaust without success
    return [] (no path), exactly like the reference's no-order-worked
    outcome."""
    lib = _get_lib("bfb_replay")
    if lib is None:
        return None
    if max_replays is None:
        max_replays = int(os.environ.get("AMBIGRAM_MAX_REPLAYS", 1_000_000))
    n = len(adj)
    if n == 0:
        return []
    adj_off = np.zeros(n + 1, dtype=np.int32)
    flat: List[int] = []
    for i, nbrs in enumerate(adj):
        flat.extend(nbrs)
        adj_off[i + 1] = len(flat)
    adj_flat = np.asarray(flat, dtype=np.int32) if flat else np.zeros(1, dtype=np.int32)
    pat = np.full((n, 3), -1, dtype=np.int32)
    loop = np.full((n, 3), -1, dtype=np.int32)
    for i in range(n):
        if node2pat[i]:
            pat[i] = node2pat[i]
        if node2loop[i]:
            loop[i] = node2loop[i]
    keys = sorted(inversions)
    inv_key = np.asarray(keys, dtype=np.int32) if keys else np.zeros(1, dtype=np.int32)
    inv_src = np.asarray([inversions[k][0] for k in keys], dtype=np.int32) if keys else np.zeros(1, dtype=np.int32)
    inv_tgt = np.asarray([inversions[k][1] for k in keys], dtype=np.int32) if keys else np.zeros(1, dtype=np.int32)

    fn = lib.bfb_replay
    fn.restype = ctypes.c_int

    def ptr(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))

    # capacity retry (16x) instead of falling back to the Python
    # enumerator: re-enumerating at Python speed just to re-find a path
    # the native engine already found but could not emit is the slowest
    # possible outcome. Beyond the retried buffer (~8M steps) the
    # "path" is a degenerate incumbent nobody can consume — emit none.
    exhausted = ctypes.c_int(0)
    for cap in (1 << 20, 1 << 24):
        out = np.zeros(cap, dtype=np.int32)
        res = fn(
            ctypes.c_int(n),
            ptr(adj_off),
            ptr(adj_flat),
            ptr(np.ascontiguousarray(pat)),
            ptr(np.ascontiguousarray(loop)),
            ctypes.c_int(len(keys)),
            ptr(inv_key),
            ptr(inv_src),
            ptr(inv_tgt),
            ctypes.c_int(1 if is_reversed else 0),
            ctypes.c_longlong(max_replays),
            ptr(out),
            ctypes.c_int(cap),
            ctypes.byref(exhausted),
        )
        if res > 0:
            return [(int(out[2 * k]), int(out[2 * k + 1])) for k in range(res)]
        if res == 0:
            # a bounded "no path" must be distinguishable from a proven
            # one: the reference enumerates unboundedly (LGM.cpp:3380),
            # so a budget-exhausted miss is a behavior divergence worth
            # surfacing (raise AMBIGRAM_MAX_REPLAYS / set 0 to match)
            if exhausted.value:
                _warn_budget(
                    "bfb_replay: order budget exhausted (AMBIGRAM_MAX_REPLAYS="
                    "%d) before any order replayed — 'no path' is bounded, "
                    "not proven" % max_replays
                )
            return []
    _warn_budget(
        "bfb_replay: successful path exceeds the %d-step output buffer; "
        "dropping it (degenerate large-CN incumbent)" % (1 << 23)
    )
    return []


def _warn_budget(msg: str) -> None:
    import sys

    print("[ambigram_tpu] WARNING: %s" % msg, file=sys.stderr)
