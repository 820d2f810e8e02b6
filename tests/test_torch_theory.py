"""The port's ``core.theory`` against the reference's: pure Python floats,
so every function equals the reference's exactly over a grid of problem
constants."""
import itertools

import pytest

from repro.core import theory as jtheory
from repro_torch.core import theory

GRID = list(itertools.product(
    (0.5, 4.0),            # L
    (0.1, 1.0),            # mu
    (0.0, 2.5),            # sigma_sq
    (0.0, 0.3),            # gamma
    (1.0, 7.0),            # g_sq
    (3.0, 40.0),           # f0 (kappa * f0 - f_star may be negative)
    (0.0, 1.5),            # f_star
    (1, 16)))              # n_clients


def _pair(c):
    return theory.ProblemConstants(*c), jtheory.ProblemConstants(*c)


@pytest.mark.parametrize("eta", [0.01, 0.3])
def test_theorem1_bound_equals_reference(eta):
    for c in GRID:
        pc, jpc = _pair(c)
        assert pc.kappa == jpc.kappa
        for ks in ([4], [8, 6, 5, 4], list(range(16, 0, -1))):
            assert theory.theorem1_bound(pc, eta, ks) == \
                jtheory.theorem1_bound(jpc, eta, ks)


@pytest.mark.parametrize("eta", [0.01, 0.3])
def test_optimal_k_equals_reference(eta):
    for c in GRID:
        pc, jpc = _pair(c)
        for f_cur, comm, horizon in ((2.0, 1.5, 100.0), (30.0, 0.2, 7.0)):
            assert theory.optimal_k(pc, eta, f_cur, comm, horizon) == \
                jtheory.optimal_k(jpc, eta, f_cur, comm, horizon)
        for rounds in (1, 50, 1000):
            assert theory.optimal_k_rounds(pc, eta, rounds) == \
                jtheory.optimal_k_rounds(jpc, eta, rounds)


@pytest.mark.parametrize("k", [1, 8, 50])
def test_optimal_eta_equals_reference(k):
    for c in GRID:
        pc, jpc = _pair(c)
        for f_cur, comm, beta, horizon in ((2.0, 1.5, 0.1, 100.0),
                                           (30.0, 0.2, 0.05, 7.0)):
            assert theory.optimal_eta(pc, k, f_cur, comm, beta, horizon) == \
                jtheory.optimal_eta(jpc, k, f_cur, comm, beta, horizon)
        for rounds in (1, 50, 1000):
            assert theory.optimal_eta_rounds(pc, k, rounds) == \
                jtheory.optimal_eta_rounds(jpc, k, rounds)


def test_theory_is_exported_from_core():
    from repro_torch import core
    assert core.theory is theory and "theory" in core.__all__
