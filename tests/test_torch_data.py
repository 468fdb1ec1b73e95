"""The port's pandas-free CSV pipeline, configuration copy and import boundary,
against mcport.

``mcport_torch.data.load_universe`` must give mcport's names exactly and its
prices, returns and annualised moments to 1e-12 on the fixtures for every
period; every field the port copied from ``mcport.config`` keeps mcport's
default; and no source of the port (nor ``chip_smoke.py``, the profiling
tool or the cuda tests, which run on a machine without jax) imports
``mcport`` or ``jax`` — checked on the sources' syntax trees, without
importing them.
"""

import ast
import dataclasses
import glob
from pathlib import Path

import numpy as np
import pytest

import mcport.config as ref_config
from mcport.data import load_universe as ref_load
from mcport.data.csv_loader import read_csv_file as ref_read
from mcport_torch import config as port_config
from mcport_torch.data import load_universe, read_csv_file

ROOT = Path(__file__).resolve().parent.parent
FIELDS = ("prices", "stats_rets", "port_rets", "mean_ann", "cov_ann")


def _close(a, b, tol=1e-12) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return (a.shape == b.shape and np.array_equal(np.isnan(a), np.isnan(b))
            and bool(np.all(np.abs(np.nan_to_num(a) - np.nan_to_num(b))
                            <= tol * np.maximum(1.0, np.abs(np.nan_to_num(b))))))


@pytest.mark.parametrize("files", ["*Historical*.csv", "* 7 Years Weekly.csv"])
@pytest.mark.parametrize("period", ["M", "Q", "W", "D"])
def test_load_universe_matches_mcport(fixtures_dir, files, period):
    paths = sorted(glob.glob(str(fixtures_dir / files)))
    assert len(paths) >= 2
    got = load_universe(paths, port_config.DataConfig(period=period))
    want = ref_load(paths=paths, config=ref_config.DataConfig(period=period))
    assert got.names == want.names
    assert (got.ann_factor, got.resample_rule) == (want.ann_factor, want.resample_rule)
    for f in FIELDS:
        assert _close(getattr(got, f), getattr(want, f)), f


def test_each_fixture_alone_matches_mcport(fixtures_dir):
    for path in sorted(glob.glob(str(fixtures_dir / "*.csv"))):
        got = load_universe([path], port_config.DataConfig(period="W"))
        want = ref_load(paths=[path], config=ref_config.DataConfig(period="W"))
        assert got.names == want.names and _close(got.prices, want.prices), path


@pytest.mark.parametrize("text", [
    # a preamble before the header, thousands separators, an NA row, an
    # unparseable price and a column order with "Close" before "Price"
    "Exported,by,a,tool\nDate,Open,Close,Price\n01/05/2024,1,\"1,200.5\",3\n"
    "01/04/2024,1,NA,3\n01/03/2024,1,abc,3\n01/02/2024,2,\"1,100\",4\n",
    # ISO dates, and no price-named column: the first non-date column
    "when,x\n2024-01-03,5\n2024-01-02,6\n2024-01-01,7\n",
    # a header found on the third row, with the date column second
    "junk,1\nmore,junk\nvalue,DATE\n10,03/01/2024\n11,03/02/2024\n12,03/05/2024\n",
])
def test_read_csv_file_matches_mcport(tmp_path, text):
    path = tmp_path / "asset.csv"
    path.write_text(text)
    cfg = port_config.DataConfig()
    try:
        want = ref_read(path, ref_config.DataConfig())
    except ValueError:
        with pytest.raises(ValueError):
            read_csv_file(path, cfg)
        return
    dates, prices = read_csv_file(path, cfg)
    assert [d.isoformat() for d in dates] == [d.date().isoformat() for d in want["Date"]]
    np.testing.assert_array_equal(prices, want["Price"].to_numpy(np.float64))


def test_read_csv_file_rejects_a_file_without_dates(tmp_path):
    path = tmp_path / "bad.csv"
    path.write_text("a,b\n1,2\n3,4\n")
    with pytest.raises(ValueError, match="date"):
        read_csv_file(path)
    with pytest.raises(ValueError):
        ref_read(path)


@pytest.mark.parametrize("name", ["DataConfig", "SimulationConfig", "GBMConfig",
                                  "SketchConfig", "Config"])
def test_config_defaults_match_mcport(name):
    port, ref = getattr(port_config, name), getattr(ref_config, name)
    ref_fields = {f.name: f for f in dataclasses.fields(ref)}
    for f in dataclasses.fields(port):
        assert f.name in ref_fields, f.name
        r = ref_fields[f.name]
        if f.default is not dataclasses.MISSING:
            assert f.default == r.default, f.name
        else:   # a nested section: compare the defaults field by field
            got, want = f.default_factory(), r.default_factory()
            for g in dataclasses.fields(got):
                assert getattr(got, g.name) == getattr(want, g.name), (f.name, g.name)
    for code in ("M", "ME", "Q", "QE", "W", "D", "m"):
        assert port_config.period_info(code) == ref_config.period_info(code)


def _sources():
    yield from sorted((ROOT / "mcport_torch").rglob("*.py"))
    for rel in ("chip_smoke.py", "tools/profile_gbm_risk.py", "tests/test_torch_cuda.py"):
        yield ROOT / rel


def test_port_sources_import_no_mcport_or_jax():
    bad = []
    for path in _sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [] if node.level else [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}:{node.lineno} {n}" for n in names
                    if n.split(".")[0] in ("mcport", "jax")]
    assert not bad, bad
    assert (ROOT / "mcport_torch" / "data.py") in list(_sources())
