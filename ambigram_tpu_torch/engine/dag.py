"""BFB DAG construction and all-topological-orders enumeration.

Parity targets:
- LocalGenomicMap::constructDAG (src/LocalGenomicMap.cpp:3276-3378)
- compareLoops                 (src/LocalGenomicMap.cpp:3266-3274)
- LocalGenomicMap::allTopologicalOrders (src/LocalGenomicMap.cpp:3380-3409)

Two reference quirks are deliberately reproduced:

1. Node order. Nodes are the positive-CN variables in std::map<string>
   iteration order (lexicographic over "l:i,j"/"p:i,j" key strings) —
   see `ambigram_tpu_torch.engine.enumerate.sorted_key_order`.

2. The node2loop sort. The reference sorts the *parallel* node2loop
   array with a comparator that treats any comparison involving an
   empty slot (a pattern's placeholder) as "equivalent". That violates
   strict weak ordering, so the result is implementation-defined; we
   reproduce libstdc++'s std::sort (introsort: insertion sort at <= 16
   elements, median-of-3 quicksort above) so loop entries end up at
   exactly the indices the reference produces, including the case where
   a loop lands on an index that also holds a pattern.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

_S_THRESHOLD = 16


def _unguarded_linear_insert(a: list, last: int, comp) -> None:
    val = a[last]
    nxt = last - 1
    while comp(val, a[nxt]):
        a[nxt + 1] = a[nxt]
        last = nxt
        nxt -= 1
    a[last] = val


def _insertion_sort(a: list, first: int, last: int, comp) -> None:
    if first == last:
        return
    for i in range(first + 1, last):
        if comp(a[i], a[first]):
            val = a[i]
            a[first + 1 : i + 1] = a[first:i]
            a[first] = val
        else:
            _unguarded_linear_insert(a, i, comp)


def _move_median_to_first(a: list, result: int, x: int, y: int, z: int, comp) -> None:
    if comp(a[x], a[y]):
        if comp(a[y], a[z]):
            a[result], a[y] = a[y], a[result]
        elif comp(a[x], a[z]):
            a[result], a[z] = a[z], a[result]
        else:
            a[result], a[x] = a[x], a[result]
    elif comp(a[x], a[z]):
        a[result], a[x] = a[x], a[result]
    elif comp(a[y], a[z]):
        a[result], a[z] = a[z], a[result]
    else:
        a[result], a[y] = a[y], a[result]


def _unguarded_partition(a: list, first: int, last: int, pivot: int, comp) -> int:
    while True:
        while comp(a[first], a[pivot]):
            first += 1
        last -= 1
        while comp(a[pivot], a[last]):
            last -= 1
        if not (first < last):
            return first
        a[first], a[last] = a[last], a[first]
        first += 1


def _introsort_loop(a: list, first: int, last: int, depth_limit: int, comp) -> None:
    while last - first > _S_THRESHOLD:
        if depth_limit == 0:
            # libstdc++ falls back to heapsort here; with this domain's
            # comparator and node counts the limit is unreachable in
            # practice, so a plain sorted() by the same comparator keys
            # is used as a defined fallback.
            a[first:last] = sorted(a[first:last], key=_HeapFallbackKey(comp))
            return
        depth_limit -= 1
        mid = first + (last - first) // 2
        _move_median_to_first(a, first, first + 1, mid, last - 1, comp)
        cut = _unguarded_partition(a, first + 1, last, first, comp)
        _introsort_loop(a, cut, last, depth_limit, comp)
        last = cut


class _HeapFallbackKey:
    def __init__(self, comp):
        self.comp = comp

    def __call__(self, item):
        outer = self

        class K:
            def __init__(self, obj):
                self.obj = obj

            def __lt__(self, other):
                return outer.comp(self.obj, other.obj)

        return K(item)


def libstdcxx_sort(a: list, comp: Callable) -> None:
    """std::sort(first, last, comp) with libstdc++'s introsort algorithm."""
    n = len(a)
    if n == 0:
        return
    lg = 0
    m = n
    while m > 1:
        m >>= 1
        lg += 1
    _introsort_loop(a, 0, n, 2 * lg, comp)
    if n > _S_THRESHOLD:
        _insertion_sort(a, 0, _S_THRESHOLD, comp)
        for i in range(_S_THRESHOLD, n):
            _unguarded_linear_insert(a, i, comp)
    else:
        _insertion_sort(a, 0, n, comp)


def compare_loops(a: Sequence[int], b: Sequence[int]) -> bool:
    diff1 = diff2 = 0
    if len(a) > 0 and len(b) > 0:
        diff1 = abs(a[0] - a[1])
        diff2 = abs(b[0] - b[1])
    return diff1 > diff2


def construct_dag(
    sorted_entries: List[Tuple[str, int]],
    element_cn: Sequence[int],
) -> Tuple[List[List[int]], List[List[int]], List[List[int]]]:
    """Build the BFB DAG over positive-CN patterns/loops.

    sorted_entries: (key, variable_index) pairs in std::map iteration
    order (from `sorted_key_order`). element_cn: solved integer CN per
    variable index. Returns (adj, node2pat, node2loop) where node k's
    payload is [i, j, cn] in whichever of node2pat/node2loop is
    non-empty (possibly both, due to the sort quirk).
    """
    adj: List[List[int]] = []
    parents: List[List[int]] = []
    node2pat: List[List[int]] = []
    node2loop: List[List[int]] = []
    for key, var in sorted_entries:
        cn = int(element_cn[var])
        if cn > 0:
            adj.append([])
            parents.append([])
            body = key[2:]
            comma = body.index(",")
            temp = [int(body[:comma]), int(body[comma + 1 :]), cn]
            if key[0] == "p":
                node2pat.append(temp)
                node2loop.append([])
            else:
                node2loop.append(temp)
                node2pat.append([])
    libstdcxx_sort(node2loop, compare_loops)

    n = len(adj)
    for i in range(n):
        if node2pat[i]:
            for j in range(n):
                if node2pat[j] and (
                    node2pat[i][0] == node2pat[j][0] or node2pat[i][1] == node2pat[j][1]
                ):
                    diff1 = node2pat[i][0] - node2pat[i][1]
                    diff2 = node2pat[j][0] - node2pat[j][1]
                    if abs(diff1) > abs(diff2):
                        adj[i].append(j)
                        parents[j].append(i)
            for j in range(n):
                if node2loop[j] and (
                    node2pat[i][0] == node2loop[j][0] or node2pat[i][1] == node2loop[j][1]
                ):
                    diff1 = node2pat[i][0] - node2pat[i][1]
                    diff2 = node2loop[j][0] - node2loop[j][1]
                    if abs(diff1) > abs(diff2):
                        adj[i].append(j)
                        parents[j].append(i)
    for i in range(n):
        if node2loop[i]:
            for j in range(n):
                if j in parents[i]:
                    continue
                if node2pat[j] and (
                    node2loop[i][0] == node2pat[j][0] or node2loop[i][1] == node2pat[j][1]
                ):
                    diff1 = node2loop[i][0] - node2loop[i][1]
                    diff2 = node2pat[j][0] - node2pat[j][1]
                    if abs(diff1) > abs(diff2):
                        adj[i].append(j)
                        parents[j].append(i)
                    else:
                        for parent in parents[i]:
                            if j in adj[parent]:
                                adj[i].append(j)
                                parents[j].append(i)
                                break
            for j in range(n):
                if node2loop[j] and (
                    node2loop[i][0] == node2loop[j][0] or node2loop[i][1] == node2loop[j][1]
                ):
                    diff1 = node2loop[i][0] - node2loop[i][1]
                    diff2 = node2loop[j][0] - node2loop[j][1]
                    if abs(diff1) > abs(diff2):
                        adj[i].append(j)
                        parents[j].append(i)
    return adj, node2pat, node2loop


def find_cycle(adj: List[List[int]]) -> List[int]:
    """Nodes of ONE directed cycle (DFS back-edge trace), [] when the
    graph is acyclic. The shared-parent edge rule (LGM.cpp:3353-3361)
    is not span-monotone, so solved CN vectors can yield cyclic graphs
    with zero topological orders; the replay-retry sweep
    (engine.pipeline._retry_replay_on_face) cuts the returned node set
    out of the next face solve."""
    n = len(adj)
    color = [0] * n  # 0 white, 1 on stack, 2 done
    parent = [-1] * n
    cycle: List[int] = []

    def dfs(u: int) -> bool:
        color[u] = 1
        for v in adj[u]:
            if color[v] == 1:
                # back edge u -> v: walk the stack from u up to v
                cyc = [u]
                w = u
                while w != v:
                    w = parent[w]
                    cyc.append(w)
                cycle.extend(cyc)
                return True
            if color[v] == 0:
                parent[v] = u
                if dfs(v):
                    return True
        color[u] = 2
        return False

    for s in range(n):
        if color[s] == 0 and dfs(s):
            return cycle
    return []


def iter_topological_orders(adj: List[List[int]]):
    """Lazily yield every topological order of the DAG, in the
    reference's recursive backtracking order (smallest eligible node
    index first, LGM.cpp:3380-3409). O(width) memory instead of the
    factorial order list — wide DAGs (many independent loops) are the
    pathological case this exists for."""
    n = len(adj)
    indeg = [0] * n
    for i in range(n):
        for j in adj[i]:
            indeg[j] += 1
    visited = [False] * n
    res: List[int] = []

    def rec():
        if len(res) == n:
            yield list(res)
        for i in range(n):
            if indeg[i] == 0 and not visited[i]:
                for j in adj[i]:
                    indeg[j] -= 1
                res.append(i)
                visited[i] = True
                yield from rec()
                visited[i] = False
                res.pop()
                for j in adj[i]:
                    indeg[j] += 1

    yield from rec()


def all_topological_orders(
    adj: List[List[int]], max_orders: int = 0
) -> List[List[int]]:
    """Materialized form of `iter_topological_orders`.

    max_orders == 0 means unbounded (reference behavior); a positive
    value caps enumeration for pathological DAGs.
    """
    import itertools

    it = iter_topological_orders(adj)
    if max_orders:
        return list(itertools.islice(it, max_orders))
    return list(it)
