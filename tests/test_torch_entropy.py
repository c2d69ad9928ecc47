"""Port parity: the entropy diagnostics (ops/entropy.py) and
`DataHandler.calculate_entropy` against the JAX package's, in float64 on
seeded series: every measure at rtol 1e-12, the printed lines equal."""

import numpy as np
import pytest

from portfoliooptgp_tpu.data.handler import DataHandler as JHandler
from portfoliooptgp_tpu.ops import entropy as jentropy
from portfoliooptgp_tpu_torch.data.handler import DataHandler as THandler
from portfoliooptgp_tpu_torch.ops import entropy as tentropy

DATES = dict(train_start_date="2024-01-02", train_end_date="2024-03-29",
             test_start_date="2024-04-01", test_end_date="2024-04-05")


def _series(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "walk":
        return 100 * np.cumprod(1 + 0.01 * rng.normal(size=400))
    if kind == "ties":  # repeated values: stable argsort order decides the pattern
        return np.round(rng.normal(size=300), 1)
    return np.full(50, 3.0)  # constant: zero variance weights


@pytest.mark.parametrize("kind", ["walk", "ties", "constant"])
@pytest.mark.parametrize("name,kw", [
    ("PE", dict(order=3, delay=1)), ("PE", dict(order=4, delay=2, normalize=False)),
    ("WPE", dict(order=3, delay=1)), ("RPE", dict(order=5, delay=1)),
    ("DE", dict(order=3, classes=3, delay=1)), ("DE", dict(order=2, classes=6, delay=3)),
    ("RDE", dict(order=3, classes=4, delay=1)), ("RWDE", dict(order=3, classes=3, delay=1)),
    ("all_measures", dict())])
def test_torch_entropy_measure_matches_jax(name, kw, kind):
    x = _series(kind, 11)
    want = getattr(jentropy, name)(x, **kw)
    got = getattr(tentropy, name)(x, **kw)
    if name == "all_measures":
        assert list(got) == list(want)
        got, want = list(got.values()), list(want.values())
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_torch_entropy_too_short_raises():
    with pytest.raises(ValueError):
        tentropy.PE(np.arange(3.0), order=4)


def test_torch_calculate_entropy_prints_jax_lines(capsys):
    x = _series("walk", 5)
    want = JHandler(**DATES).calculate_entropy(x)
    jout = capsys.readouterr().out
    got = THandler(**DATES, device="cpu").calculate_entropy(x)
    tout = capsys.readouterr().out
    assert tout == jout and tout.startswith("Entropy results:\nDE: ")
    assert got == want
