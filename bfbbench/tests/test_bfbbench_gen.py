"""The frozen case generator: the same cases for the same seed, and the
same cases as the program's own generator gives today."""

import numpy as np
import pytest

from bfbbench import gen


def test_same_seed_same_cases():
    a = gen.simulate_bfb_case(seed=2**31 + 7, n_segments=48, rounds=5, noise=0.05)
    b = gen.simulate_bfb_case(seed=2**31 + 7, n_segments=48, rounds=5, noise=0.05)
    c = gen.simulate_bfb_case(seed=2**31 + 8, n_segments=48, rounds=5, noise=0.05)
    assert a.lh_text == b.lh_text and a.truth_path == b.truth_path
    assert a.lh_text != c.lh_text
    s1 = gen.simulate_sc_case(seed=5, n_clones=3, n_segments=32, topology="star")
    s2 = gen.simulate_sc_case(seed=5, n_clones=3, n_segments=32, topology="star")
    assert [x.lh_text for x in s1.cases] == [x.lh_text for x in s2.cases]


@pytest.mark.parametrize("seed", range(0, 40, 3))
def test_matches_the_programs_generator(seed):
    simulate = pytest.importorskip("ambigram_tpu_torch.scripts.simulate")
    for topology in ("chain", "star"):
        ours = gen.simulate_sc_case(seed=seed, n_clones=3, n_segments=32, topology=topology)
        theirs = simulate.simulate_sc_case(seed=seed, n_clones=3, n_segments=32, topology=topology)
        assert [c.lh_text for c in ours.cases] == [c.lh_text for c in theirs.cases]
    ours = gen.simulate_bfb_case(seed=seed, n_segments=48, rounds=5, coverage=30.0, noise=0.05)
    theirs = simulate.simulate_bfb_case(seed=seed, n_segments=48, rounds=5, coverage=30.0, mode="process", noise=0.05)
    assert ours.lh_text == theirs.lh_text and ours.truth_string == theirs.truth_string


def test_chain_to_path_is_the_programs_replay():
    simulate = pytest.importorskip("ambigram_tpu_torch.scripts.simulate")
    rng = np.random.default_rng(11)
    for _ in range(200):
        chain = gen.random_nested_chain(rng, int(rng.integers(2, 20)))
        chain = gen.mutate_nested_chain(rng, chain, chain[0][1])
        assert gen.chain_to_path(chain) == simulate.chain_to_path(chain)
