"""Port parity: the native CSV loader (`portfoliooptgp_tpu_torch/native.py`,
built by g++ from `csrc/csv_loader.cc`) and the rest of the data layer
(`loader.read_eod_csv`/`read_intraday_csv`, `transforms.denormalize*`,
`data/wrangle.py`, `DataHandler.process_2D_X`/`fetch_and_save_data`)
against the JAX package's, on the files `make_market` writes and on small
hand-made ones. The loader parses as the JAX package's does: equal to it,
dates exactly and prices within rtol 1e-15 of pandas. The network fetch
runs against a `requests` stub in `sys.modules`."""

import glob
import os
import subprocess
import sys
import types

import numpy as np
import pandas as pd
import pytest
import torch

from benchmarks.bench_portfolio_e2e import ASSETS, DATES, make_market
from portfoliooptgp_tpu import native as jnative
from portfoliooptgp_tpu.data import loader as jloader
from portfoliooptgp_tpu.data import transforms as jtransforms
from portfoliooptgp_tpu.data import wrangle as jwrangle
from portfoliooptgp_tpu.data.handler import DataHandler as JHandler
from portfoliooptgp_tpu_torch import native
from portfoliooptgp_tpu_torch.data import loader as tloader
from portfoliooptgp_tpu_torch.data import transforms as ttransforms
from portfoliooptgp_tpu_torch.data import wrangle as twrangle
from portfoliooptgp_tpu_torch.data.handler import DataHandler as THandler

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COLUMNS = ("open", "high", "low", "close", "adjusted_close", "volume")


@pytest.fixture(scope="module")
def market(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("market"))
    make_market(root)
    return root


def _eod_files(root):
    return sorted(glob.glob(os.path.join(root, "Stocks", "*", "*_us_d.csv")))


def test_torch_native_load_eod_matches_jax_and_pandas(market):
    paths = _eod_files(market)
    assert len(paths) == len(ASSETS) + 2
    many = native.load_eod_many(paths, n_threads=3)
    for path, got_many in zip(paths, many):
        got, want = native.load_eod(path), jnative.load_eod(path)
        frame = pd.read_csv(path)
        days = (pd.to_datetime(frame["date"]) - pd.Timestamp("1970-01-01")).dt.days
        np.testing.assert_array_equal(got["dates"], want["dates"])
        np.testing.assert_array_equal(got["dates"], days.to_numpy())
        for name in COLUMNS:
            np.testing.assert_array_equal(got[name], want[name])
            np.testing.assert_array_equal(got_many[name], got[name])
            np.testing.assert_allclose(got[name], frame[name].to_numpy(float), rtol=1e-15,
                                       atol=0)


@pytest.mark.parametrize("use_native", [None, True, False])
def test_torch_read_eod_csv_matches_jax(market, use_native):
    path = _eod_files(market)[0]
    window = ("2024-03-01", "2024-04-30")
    want = jloader.read_eod_csv(path, *window, use_native=True)
    got = tloader.read_eod_csv(path, *window, use_native=use_native)
    assert len(got) == 43 and got["date"].iloc[0] == pd.Timestamp("2024-03-01")
    pd.testing.assert_frame_equal(got, want, check_exact=use_native is not False,
                                  rtol=1e-15, check_dtype=False)


def test_torch_read_eod_csv_without_the_library(market, monkeypatch):
    """A loader that does not build: the default warns and parses with
    pandas, `use_native=True` raises."""
    def broken():
        raise RuntimeError("g++ failed to build the CSV loader: stub")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    monkeypatch.setattr(native, "build", broken)
    path = _eod_files(market)[0]
    with pytest.warns(UserWarning, match="pandas parses instead"):
        df = tloader.read_eod_csv(path)
    assert not native.available() and len(df) == 87
    with pytest.raises(RuntimeError, match="unavailable"):
        tloader.read_eod_csv(path, use_native=True)


def test_torch_native_builds_in_two_processes_at_once(market, tmp_path):
    """Two processes building the loader into one empty directory at the
    same moment both load a whole library and parse the file."""
    path = _eod_files(market)[0]
    code = ("import sys; from portfoliooptgp_tpu_torch import native; "
            "print(native.load_eod(sys.argv[1])['close'][:3].tolist())")
    env = dict(os.environ, PORTFOLIOOPTGP_BUILD_DIR=str(tmp_path / "build"),
               PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code, path], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    want = str(jnative.load_eod(path)["close"][:3].tolist())
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == want
    assert [os.path.basename(f) for f in os.listdir(tmp_path / "build")] == [
        os.path.basename(native.library_path())]


def test_torch_read_intraday_csv_matches_jax(tmp_path, rng):
    paths = []
    for day in ("2024-03-05", "2024-03-04"):  # given out of time order
        stamps = pd.date_range(f"{day} 09:30", periods=30, freq="min")
        close = 100 + np.cumsum(rng.normal(size=30))
        pd.DataFrame({"DateTime": stamps.strftime("%Y-%m-%d %H:%M:%S"), "Open": close - 0.1,
                      "High": close + 0.2, "Low": close - 0.3, "Close": close,
                      "Type": "trade", "Volume": rng.integers(1, 1000, 30)}).to_csv(
            tmp_path / f"{day}.csv", index=False)
        paths.append(str(tmp_path / f"{day}.csv"))
    for arg in (paths, paths[0]):
        pd.testing.assert_frame_equal(tloader.read_intraday_csv(arg),
                                      jloader.read_intraday_csv(arg))


def test_torch_denormalize_matches_jax(rng):
    z = rng.normal(size=(7, 1))
    _, mean, std = jtransforms.zscore(rng.normal(3.0, 2.0, 50))
    np.testing.assert_array_equal(ttransforms.denormalize(z, mean, std),
                                  jtransforms.denormalize(z, mean, std))
    np.testing.assert_array_equal(ttransforms.denormalize_variance(z ** 2, std),
                                  jtransforms.denormalize_variance(z ** 2, std))
    np.testing.assert_array_equal(ttransforms.denormalize(list(z[:, 0]), mean, std),
                                  jtransforms.denormalize(list(z[:, 0]), mean, std))
    t = torch.tensor(z)
    got = ttransforms.denormalize(t, mean, std)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), jtransforms.denormalize(z, mean, std))
    np.testing.assert_array_equal(ttransforms.denormalize_variance(t ** 2, std).numpy(),
                                  jtransforms.denormalize_variance(z ** 2, std))


def test_torch_wrangle_matches_jax(tmp_path, rng):
    dates = pd.bdate_range("2024-01-02", periods=20)[::-1]
    close = 1000 + np.cumsum(rng.normal(size=20))
    quote = tmp_path / "quote.csv"
    pd.DataFrame({"Date": dates.strftime("%m/%d/%Y"),
                  "Price": [f"{c:,.2f}" for c in close],
                  "Open": [f"{c - 1:,.2f}" for c in close],
                  "High": [f"{c + 2:,.2f}" for c in close],
                  "Low": [f"{c - 3:,.2f}" for c in close],
                  "Vol.": ["1.2K"] * 19 + [""], "Change %": ["0.10%"] * 20}).to_csv(
        quote, index=False)
    got = twrangle.convert_quote_csv(str(quote), str(tmp_path / "t.csv"))
    want = jwrangle.convert_quote_csv(str(quote), str(tmp_path / "j.csv"))
    pd.testing.assert_frame_equal(got, want)
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text()

    index = tmp_path / "index.csv"
    pd.DataFrame({"Date": dates.strftime("%Y-%m-%d"), "Open": close, "High": close + 1,
                  "Low": close - 1, "Close": [f"{c:,.2f}" for c in close],
                  "Adj Close": close, "Volume": 5}).to_csv(index, index=False)
    got = twrangle.remap_index_csv(str(index), str(tmp_path / "ti.csv"))
    want = jwrangle.remap_index_csv(str(index), str(tmp_path / "ji.csv"))
    pd.testing.assert_frame_equal(got, want)
    assert got["date"].is_monotonic_increasing

    a = pd.DataFrame({"date": pd.date_range("2024-01-01", periods=14).astype(str),
                      "close": np.arange(14.0)})
    b = pd.DataFrame({"date": pd.bdate_range("2024-01-01", periods=10).astype(str),
                      "close": np.arange(10.0)})[::-1]
    for got, want in zip(twrangle.align_by_dates(a, b), jwrangle.align_by_dates(a, b)):
        pd.testing.assert_frame_equal(got, want)


def test_torch_process_2D_X_matches_jax(market):
    jh = JHandler(data_root=market, **DATES)
    th = THandler(data_root=market, device="cpu", dtype=torch.float64, **DATES)
    for kw in (dict(), dict(predict_Y="return", start_date="2024-02-15")):
        want = jh.process_2D_X("BRVO", **kw)
        got = th.process_2D_X("BRVO", **kw)
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-13, atol=1e-15)
        pd.testing.assert_series_equal(got[2], want[2])
        np.testing.assert_allclose(got[3] + got[4], want[3] + want[4], rtol=1e-13)


class _Response:
    def __init__(self, records):
        self.records = records

    def raise_for_status(self):
        pass

    def json(self):
        return self.records


@pytest.fixture
def requests_stub(monkeypatch, market):
    """A `requests` module whose `get` serves ALFA's bars and records each
    URL; API_TOKEN set."""
    frame = pd.read_csv(_eod_files(market)[0])
    urls = []

    def get(url, timeout):
        urls.append((url, timeout))
        return _Response(frame.to_dict("records"))

    monkeypatch.setitem(sys.modules, "requests", types.SimpleNamespace(get=get))
    monkeypatch.setenv("API_TOKEN", "demo-token")
    return urls


def test_torch_fetch_and_save_data_matches_jax(tmp_path, requests_stub, monkeypatch):
    files = {}
    for name, cls in (("jax", JHandler), ("port", THandler)):
        root = tmp_path / name
        cls(data_root=str(root), **DATES).fetch_and_save_data("ZETA", "d", "2024-02-01",
                                                              "2024-05-31")
        files[name] = (root / "Stocks" / "ZETA" / "ZETA_us_d.csv").read_text()
    assert files["port"] == files["jax"] and files["port"].startswith("date,open,")
    assert requests_stub[0] == requests_stub[1] == (
        "https://eodhd.com/api/eod/ZETA.US?period=d&api_token=demo-token&fmt=json"
        "&from=2024-02-01&to=2024-05-31", 30)
    THandler(data_root=str(tmp_path / "btc"), **DATES).fetch_and_save_data(
        "BTC", "w", "2024-02-01", "2024-05-31")
    assert requests_stub[-1][0].startswith("https://eodhd.com/api/eod/BTC-USD.CC?period=w&")
    monkeypatch.delenv("API_TOKEN")
    with pytest.raises(RuntimeError, match="API_TOKEN"):
        THandler(data_root=str(tmp_path), **DATES).fetch_and_save_data("ZETA", "d", "a", "b")


def test_torch_process_data_fetch_and_entropy_match_jax(tmp_path, requests_stub, capsys):
    """process_data(isFetch=True, compute_entropy=True): the fetched file is
    read back, the entropy lines printed, and X and Y are JAX's."""
    out = {}
    for name, handler in (
            ("jax", JHandler(data_root=str(tmp_path / "j"), **DATES)),
            ("port", THandler(data_root=str(tmp_path / "t"), device="cpu",
                              dtype=torch.float64, **DATES))):
        X, Y, dates, ys, xs = handler.process_data("Stocks", "ZETA", isFetch=True,
                                                   compute_entropy=True)
        out[name] = (np.asarray(X), np.asarray(Y), ys, xs, capsys.readouterr().out)
    got, want = out["port"], out["jax"]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose(got[2] + got[3], want[2] + want[3], rtol=1e-13)
    assert got[4] == want[4] and "Entropy results:" in got[4] and "RWDE: " in got[4]
