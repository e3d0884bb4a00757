"""SP+ rating table loaders.

Host-side (pandas) cold path.  Mirrors the behavior of the reference's two
loaders:

* ``load_sp_flex`` / ``lookup_sp_flex``: schema-flexible single-week tables
  (reference fast_monte_carlo_cfb.py:1576-1644).  Schema A is
  ``team,RATING,OFFENSE,DEFENSE[,year,week,...]``; schema B is the 2025 sheet
  with ``'Current SP+'/'Past SP+'`` name columns and
  ``Rating/Offense Rating/Defense Rating`` value columns.
* ``load_sp_historical`` / ``lookup_sp_historical``: multi-year weekly table
  with latest-at-or-before-week selection (reference :174-201).

Team lookup is case/punctuation-insensitive with a guarded substring
fallback, as in the reference (:1625-1644).
"""
from __future__ import annotations

import re
from functools import lru_cache
from typing import Tuple

import pandas as pd

_SCHEMA_A = {"team", "RATING", "OFFENSE", "DEFENSE"}
_SCHEMA_B = {"Current SP+", "Past SP+", "Rating", "Offense Rating", "Defense Rating"}


def norm_team(name: str) -> str:
    """Lowercase and strip non-alphanumerics (reference :1573-1574)."""
    return re.sub(r"[^a-z0-9]+", "", str(name).lower())


@lru_cache(maxsize=32)
def load_sp_flex(sp_path: str) -> pd.DataFrame:
    """Load an SP+ sheet into normalized columns team/RATING/OFFENSE/DEFENSE.
    ``"seeded:<int>"`` selects the seeded 137-team schema-B sheet."""
    from ..seeded import seed_of, seeded_sp_sheet

    seed = seed_of(sp_path)
    raw = pd.read_csv(sp_path) if seed is None else seeded_sp_sheet(seed)
    cols = set(raw.columns)

    if _SCHEMA_A.issubset(cols):
        sp = raw[["team", "RATING", "OFFENSE", "DEFENSE"]].copy()
    elif _SCHEMA_B.issubset(cols):
        parts = []
        for name_col in ("Current SP+", "Past SP+"):
            part = raw[[name_col, "Rating", "Offense Rating", "Defense Rating"]]
            part = part.rename(columns={
                name_col: "team",
                "Rating": "RATING",
                "Offense Rating": "OFFENSE",
                "Defense Rating": "DEFENSE",
            })
            parts.append(part)
        sp = pd.concat(parts, ignore_index=True).dropna(subset=["team"])
        sp = sp.drop_duplicates(subset=["team"], keep="first")
    else:
        raise ValueError(
            f"{sp_path} matches neither SP+ schema: need either "
            f"{sorted(_SCHEMA_A)} (schema A) or {sorted(_SCHEMA_B)} "
            f"(schema B); the sheet has {sorted(cols)}"
        )

    sp["team"] = sp["team"].astype(str).str.strip()
    for c in ("RATING", "OFFENSE", "DEFENSE"):
        sp[c] = sp[c].astype(float)
    sp["norm_team"] = sp["team"].map(norm_team)
    return sp


def lookup_sp_flex(team: str, sp_df: pd.DataFrame) -> Tuple[float, float, float]:
    """Return (RATING, OFFENSE, DEFENSE), fuzzy-matching the team name.

    Match strategies run in order of strictness — normalized equality,
    case-insensitive equality, then case-insensitive substring — and the
    first hit wins.  Which teams resolve is contract (the reference
    resolves the same set, :1625-1644); the strategy list is ours."""
    low = team.lower()
    strategies = (
        lambda: sp_df["norm_team"] == norm_team(team),
        lambda: sp_df["team"].str.lower() == low,
        lambda: sp_df["team"].str.lower().str.contains(low, regex=False),
    )
    for match in strategies:
        hit = sp_df[match()]
        if not hit.empty:
            row = hit.iloc[0]
            return (float(row["RATING"]), float(row["OFFENSE"]),
                    float(row["DEFENSE"]))
    raise ValueError(
        f"no SP+ row matches team {team!r} (tried normalized, exact, and "
        "substring matches)")


@lru_cache(maxsize=8)
def load_sp_historical(path: str) -> pd.DataFrame:
    """Multi-year weekly SP+ table: team,RATING,OFFENSE,DEFENSE,year,week."""
    sp = pd.read_csv(path)
    keep = [c for c in ("team", "RATING", "OFFENSE", "DEFENSE", "year", "week", "conference")
            if c in sp.columns]
    sp = sp[keep].copy()
    sp["team"] = sp["team"].astype(str)
    sp["year"] = sp["year"].astype(int)
    sp["week"] = sp["week"].astype(int)
    return sp


def lookup_sp_historical(team: str, year: int, week: int, path: str) -> Tuple[float, float, float]:
    """Latest entry at-or-before `week` in `year` (reference :190-201)."""
    sp = load_sp_historical(path)
    mask = (sp["year"] == year) & (sp["team"].str.lower() == team.lower())
    df = sp[mask & (sp["week"] <= week)]
    if df.empty:
        df = sp[mask]
        if df.empty:
            raise ValueError(f"SP+ not found for team={team}, year={year}.")
    row = df.sort_values("week").iloc[-1]
    return float(row["RATING"]), float(row["OFFENSE"]), float(row["DEFENSE"])
