"""Team context: SP+ ratings + per-role player tables, in dense padded form.

The reference keeps pandas DataFrames inside its ``TeamContext``
(fast_monte_carlo_cfb.py:255-271) and samples player names per play with
``RNG.choice`` on the share column (:625-635).  Here the same information is
pre-packed into fixed-width arrays (``RoleTable``) so the device engine can
sample players with a single inverse-CDF draw against a padded cumulative
share vector, and credit stats into fixed player slots.

Slot layout per role (K = config.engine.player_slots, default 8):
  names[k]   player name ('' for padding)
  share[k]   sampling share (padding gets 0)
  tracked[k] whether per-player stats accrue for this slot (reference keeps
             stats only for names in the focus track sets, :1062-1063)
  is_other[k] synthetic ``__Other__`` remainder slot: sampled like any other
             player, fed to models as Unknown (:1066), never tracked.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Set

import numpy as np
import pandas as pd

import os

from .sp import load_sp_flex, lookup_sp_flex, lookup_sp_historical
from .usage import (
    _FALLBACK_FILES, OTHER_SENTINEL, UNKNOWN, ROLE_NAME_COLS,
    build_focus_usage_tables, usage_for_team,
)


@dataclass
class RoleTable:
    names: List[str]
    share: np.ndarray       # (K,) float64, sums to 1 over real slots
    tracked: np.ndarray     # (K,) bool
    is_other: np.ndarray    # (K,) bool

    @property
    def k(self) -> int:
        return len(self.names)

    @property
    def cum_share(self) -> np.ndarray:
        return np.cumsum(self.share)

    @staticmethod
    def from_share_frame(df: pd.DataFrame, name_col: str, track: Set[str], k: int) -> "RoleTable":
        df = df.sort_values("share", ascending=False, kind="stable")
        names = [str(n) for n in df[name_col].tolist()][:k]
        shares = [float(s) for s in df["share"].tolist()][:k]
        total = sum(shares)
        if total > 0:
            shares = [s / total for s in shares]
        pad = k - len(names)
        names += [""] * pad
        shares += [0.0] * pad
        tracked = np.array([(n in track) and n not in ("", OTHER_SENTINEL) for n in names])
        is_other = np.array([n == OTHER_SENTINEL for n in names])
        return RoleTable(
            names=names,
            share=np.asarray(shares, dtype=np.float64),
            tracked=tracked,
            is_other=is_other,
        )

    def sample_name(self, u: float) -> str:
        idx = int(np.searchsorted(self.cum_share, u, side="right"))
        idx = min(idx, self.k - 1)
        return self.names[idx]

    def model_name(self, slot: int) -> str:
        """Name as fed to the ML models: __Other__ maps to Unknown (:1066)."""
        n = self.names[slot]
        return UNKNOWN if (n == OTHER_SENTINEL or n == "") else n


@dataclass
class TeamContext:
    name: str
    year: int
    week: int
    sp_rating: float
    sp_offense: float
    sp_defense: float
    qb: RoleTable
    rush: RoleTable
    target: RoleTable

    @property
    def any_tracking(self) -> bool:
        return bool(self.qb.tracked.any() or self.rush.tracked.any() or self.target.tracked.any())


def _build(team: str, year: int, week: int, rating: float, off: float, deff: float,
           focus_usage: dict, usage_dir: str, player_slots: int) -> TeamContext:
    qb_df, ru_df, tg_df, tp, tr, trec = usage_for_team(team, year, focus_usage, usage_dir)
    return TeamContext(
        name=team, year=year, week=week,
        sp_rating=rating, sp_offense=off, sp_defense=deff,
        qb=RoleTable.from_share_frame(qb_df, ROLE_NAME_COLS["pass"], tp, player_slots),
        rush=RoleTable.from_share_frame(ru_df, ROLE_NAME_COLS["rush"], tr, player_slots),
        target=RoleTable.from_share_frame(tg_df, ROLE_NAME_COLS["rec"], trec, player_slots),
    )


# In-process memos for the warm slate path: a 60-matchup slate builds 120
# contexts per API call (and would re-parse the focus CSV for each) in
# host pandas.  Keys are CONTENT (team + looked-up
# SP+ numbers + file fingerprints), never object identity, so rebuilt
# sp_df frames and edited files behave correctly.  Returned TeamContexts
# are shared and treated as immutable everywhere (the engine packs them
# into arrays).
_CONTEXT_MEMO: dict = {}
_FOCUS_MEMO: dict = {}


def _file_fp(path) -> tuple:
    """(path, mtime_ns, size) — stat-based staleness fingerprint."""
    try:
        st = os.stat(path)
        return (str(path), st.st_mtime_ns, st.st_size)
    except OSError:
        return (str(path), None, None)


def _focus_tables_cached(focus_csv: str) -> dict:
    fp = _file_fp(focus_csv)
    hit = _FOCUS_MEMO.get(fp)
    if hit is None:
        hit = _FOCUS_MEMO[fp] = build_focus_usage_tables(focus_csv)
    return hit


def _sp_fp(sp_df: pd.DataFrame) -> int:
    """Content fingerprint of an SP+ frame, computed once and stashed in
    df.attrs so memo hits skip the pandas fuzzy lookup entirely (the
    lookup, not the dict probe, dominated the warm path).  In-place
    mutation of a frame after its first use would go unseen — no code
    path here mutates loaded SP+ frames."""
    fp = sp_df.attrs.get("_fmc_content_fp")
    if fp is None:
        fp = hash((tuple(map(str, sp_df.columns)),
                   int(pd.util.hash_pandas_object(sp_df, index=False).sum())))
        sp_df.attrs["_fmc_content_fp"] = fp
    return fp


def build_team_context_from_sp_flex(
    team: str,
    year: int,
    week: int,
    sp_df: Optional[pd.DataFrame] = None,
    *,
    sp_path: Optional[str] = None,
    focus_csv: Optional[str] = None,
    usage_dir: str = ".",
    player_slots: int = 8,
) -> TeamContext:
    """Context from a flex-schema SP+ sheet (reference :1646-1659)."""
    if sp_df is None:
        if sp_path is None:
            raise ValueError("provide sp_df or sp_path")
        sp_df = load_sp_flex(sp_path)
    key = (team, year, week, _sp_fp(sp_df),
           _file_fp(focus_csv) if focus_csv else None,
           tuple(_file_fp(os.path.join(usage_dir, f))
                 for f in _FALLBACK_FILES.values()),
           player_slots)
    hit = _CONTEXT_MEMO.get(key)
    if hit is not None:
        return hit
    rating, off, deff = lookup_sp_flex(team, sp_df)
    focus = _focus_tables_cached(focus_csv) if focus_csv else {}
    ctx = _build(team, year, week, rating, off, deff, focus, usage_dir,
                 player_slots)
    _CONTEXT_MEMO[key] = ctx
    return ctx


def build_team_context(
    team: str,
    year: int,
    week: int,
    *,
    sp_hist_path: str,
    focus_csv: Optional[str] = None,
    usage_dir: str = ".",
    player_slots: int = 8,
) -> TeamContext:
    """Context from the historical weekly SP+ table (reference :609-622)."""
    rating, off, deff = lookup_sp_historical(team, year, week, sp_hist_path)
    focus = build_focus_usage_tables(focus_csv) if focus_csv else {}
    return _build(team, year, week, rating, off, deff, focus, usage_dir, player_slots)
