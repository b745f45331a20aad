"""Pattern / loop enumeration as index math.

The reference enumerates all ordered pairs (i <= j) inside a segment
interval twice (once as "patterns", once as "loops") via a recursive
`combinations` helper (src/LocalGenomicMap.cpp:3254-3264) and keys them
with strings "p:i,j" / "l:i,j" in a std::map (localhap.cpp:122-133).

Here the pair set is a static index space:

    pairs[t] = (i, j)   for t in [0, T),  T = n*(n+1)/2

in the exact enumeration order of the reference (lexicographic in
(i, j)), so variable t < T is pattern t and variable T + t is loop t —
identical to the reference's `variableIdx` assignment.

The std::map *iteration* order (lexicographic in the key string, which
differs from numeric order once ids reach 10) is load-bearing for DAG
node numbering; `sorted_key_order` reproduces it.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def enumerate_pairs(start: int, end: int) -> np.ndarray:
    """All (i, j), start <= i <= j <= end, in reference enumeration order."""
    pairs = [(i, j) for i in range(start, end + 1) for j in range(i, end + 1)]
    return np.array(pairs, dtype=np.int32).reshape(-1, 2)


def pair_count(start: int, end: int) -> int:
    n = end - start + 1
    return n * (n + 1) // 2


def pair_index(start: int, end: int, i: int, j: int) -> int:
    """Index of pair (i, j) in `enumerate_pairs(start, end)` order."""
    n = end - start + 1
    a = i - start
    b = j - start
    # pairs with first element < a: sum_{k<a} (n - k)
    return a * n - a * (a - 1) // 2 + (b - a)


def variable_keys(pairs: np.ndarray) -> List[str]:
    """String keys in variable-index order: all "p:i,j" then all "l:i,j"."""
    p = ["p:%d,%d" % (i, j) for i, j in pairs]
    l = ["l:%d,%d" % (i, j) for i, j in pairs]
    return p + l


def sorted_key_order(pairs: np.ndarray) -> List[Tuple[str, int]]:
    """(key, variable_index) pairs in std::map<string> iteration order.

    Matches the C++ lexicographic string ordering of
    `map<string,int> variableIdx` — e.g. "l:1,10" sorts before "l:1,2",
    and every "l:*" key sorts before every "p:*" key.
    """
    keys = variable_keys(pairs)
    order = sorted(range(len(keys)), key=lambda t: keys[t])
    return [(keys[t], t) for t in order]
