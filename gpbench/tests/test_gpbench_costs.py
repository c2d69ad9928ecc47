"""The frozen cost functions against hand-worked numbers."""

import pytest

from gpbench import costs


def test_nll_bound_matches_the_kernel_table():
    # PERF.md's kernel table: (8, 512) ARD SE D = 4, 0.010872 with W and
    # 0.005530 value only; (5, 480) masked J = 2, 0.005588 / 0.002837
    assert costs.nll_bound_ms(8, 512, 1, 4, False, True) == (pytest.approx(0.010872, abs=1e-6),
                                                             "operations")
    assert costs.nll_bound_ms(8, 512, 1, 4, False, False)[0] == pytest.approx(0.005530, abs=1e-6)
    assert costs.nll_bound_ms(5, 480, 2, 2, True, True)[0] == pytest.approx(0.005588, abs=1e-6)
    assert costs.nll_bound_ms(5, 480, 2, 2, True, False)[0] == pytest.approx(0.002837, abs=1e-6)


def test_nll_bound_by_hand():
    # B = 1, N = 4, J = JD = 1, with W: 64/3 + 64/3 + 16 + 8 + 10·4 operations
    flops = 64 / 3 + 64 / 3 + 16 + 8 + 40
    assert costs.nll_bound_ms(1, 4, 1, 1, False, True)[0] == pytest.approx(
        1e3 * max(flops / 67e12, 4 * (10 + 4 + 4 + 1 + 4 + 16) / 3.35e12))


def test_panel_bound_matches_the_kernel_table():
    assert costs.panel_bound_ms(875) == (pytest.approx(0.000248, abs=1e-6), "bytes")
    assert costs.panel_bound_ms(768, 5)[0] == pytest.approx(0.001077, abs=1e-6)


def test_nll_flops_by_hand():
    # N = 4, J = JD = 1: value 64/3 + 16 + 12 + 40; the gradient adds
    # 2·64/3 + 48 + 2·16·2 + 4
    assert costs.nll_flops(1, 4, 1, 1, False) == pytest.approx(64 / 3 + 16 + 12 + 40)
    assert costs.nll_flops(3, 4, 1, 1, True) == pytest.approx(
        3 * (64 / 3 + 16 + 12 + 40 + 128 / 3 + 48 + 64 + 4))
