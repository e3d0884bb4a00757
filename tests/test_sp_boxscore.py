"""Direct coverage for two small host-side surfaces: the historical
(schema-A weekly) SP+ loaders — reference _load_sp/_lookup_sp
fast_monte_carlo_cfb.py:174-201 — and the box-score formatter
(print_boxscore, :1525-1567)."""
import numpy as np
import pandas as pd
import pytest

from fast_monte_carlo.boxscore import (
    format_boxscore, format_team_line, mean_boxscore,
)
from fast_monte_carlo.data import (
    build_team_context, lookup_sp_historical,
)
from fast_monte_carlo.stats import N_TEAM_STATS, TS


@pytest.fixture()
def hist_csv(tmp_path):
    df = pd.DataFrame({
        "team": ["Tigers", "Tigers", "Tigers", "Bears"],
        "RATING": [10.0, 12.0, 14.0, -3.0],
        "OFFENSE": [30.0, 31.0, 32.0, 22.0],
        "DEFENSE": [20.0, 19.0, 18.0, 25.0],
        "year": [2023, 2023, 2023, 2023],
        "week": [1, 5, 9, 5],
        "conference": ["SEC"] * 4,
    })
    p = tmp_path / "sp_hist.csv"
    df.to_csv(p, index=False)
    return str(p)


def test_sp_historical_at_or_before_week(hist_csv):
    # week 6 -> the week-5 row (latest at-or-before), case-insensitive team
    assert lookup_sp_historical("tigers", 2023, 6, hist_csv) == (12.0, 31.0, 19.0)
    # week past the last entry -> week-9 row
    assert lookup_sp_historical("Tigers", 2023, 12, hist_csv)[0] == 14.0
    # week BEFORE any entry -> reference fallback: latest in that year
    assert lookup_sp_historical("Bears", 2023, 0, hist_csv) == (-3.0, 22.0, 25.0)


def test_sp_historical_missing_team_raises(hist_csv):
    with pytest.raises(ValueError, match="SP\\+ not found"):
        lookup_sp_historical("Wolves", 2023, 6, hist_csv)
    with pytest.raises(ValueError, match="SP\\+ not found"):
        lookup_sp_historical("Tigers", 2024, 6, hist_csv)


def test_build_team_context_historical(hist_csv):
    tc = build_team_context("Tigers", 2023, 6, sp_hist_path=hist_csv)
    assert (tc.sp_rating, tc.sp_offense, tc.sp_defense) == (12.0, 31.0, 19.0)
    assert tc.name == "Tigers"


def _stats(**kw):
    s = np.zeros(N_TEAM_STATS)
    for k, v in kw.items():
        s[TS[k]] = v
    return s


def test_format_team_line_fields():
    s = _stats(points=31, pass_att=40, comp=25, pass_yds=287.5, pass_td=2,
               INT=1, sacks=3, rush_att=30, rush_yds=120.0, rush_td=2,
               FG=1, FGA=2, punts=4, rz_trips=5, rz_TD=3,
               fourth_go=2, fourth_conv=1)
    line = format_team_line("Tigers", s)
    assert "Tigers: 31 pts" in line
    assert "Pass 25/40 (62%)" in line            # 62.5 -> .0f
    assert "287.5 yds (YPA 7.2)" in line
    assert "TD 2, INT 1, Sacks 3" in line
    assert "Rush 30 for 120.0 yds (YPC 4.0)" in line
    assert "FG 1/2, Punts 4" in line
    assert "RZ 3/5 TD" in line and "4th 1/2" in line


def test_format_team_line_zero_attempts_no_div0():
    line = format_team_line("Empty", _stats())
    assert "Pass 0/0 (0%)" in line and "YPA 0.0" in line and "YPC 0.0" in line


def test_mean_boxscore_averages_batch():
    a = np.stack([np.stack([_stats(points=10), _stats(points=0)]),
                  np.stack([_stats(points=20), _stats(points=6)])])
    out = mean_boxscore(("A", "B"), a)
    assert out.splitlines()[0].startswith("A: 15 pts")
    assert out.splitlines()[1].startswith("B: 3 pts")
    assert format_boxscore(("A", "B"), a[0]).count("\n") == 1
