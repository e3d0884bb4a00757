"""Betting edge analytics: spread/total/moneyline and player-prop markets.

Full math parity with the reference's edge_finder.py (cited per function),
operating either on saved sim files (filesystem-decoupled, like the
reference) or directly on in-memory frames / device summaries.

PARITY INTENT: this module's output dict schemas, rounding, sort orders,
and report format strings deliberately track edge_finder.py closely — they
ARE the component's observable behavior (downstream workflows parse the
dicts, and the readable reports are the product a bettor eyeballs), and the
odds math is forced (American-odds/EV identities).  The deviations are
where behavior was wrong or host-bound: the packed-dict players-CSV repair
drops the reference's `testings.csv` side effect (edge_finder.py:165),
projected-score printing handles a zero margin, and the *_from_device
variants consume on-device reductions instead of pandas files.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import pandas as pd

STAT_ALIASES = {
    "pass_yards": "pass_yds",
    "rush_yards": "rush_yds",
    "rec_yards": "rec_yds",
}


def _norm_team(s: str) -> str:
    return re.sub(r"[^a-z0-9]+", "", str(s).lower())


# ---------------------------------------------------------------------------
# odds math (edge_finder.py:70-119)
# ---------------------------------------------------------------------------

def prob_to_american(p: float) -> int:
    """Fair (no-vig) American odds for probability p (edge_finder.py:70-75)."""
    p = float(np.clip(p, 1e-6, 1 - 1e-6))
    if p >= 0.5:
        return int(round(-100 * p / (1 - p)))
    return int(round(100 * (1 - p) / p))


def breakeven_minus110() -> float:
    return 110.0 / 210.0


def ev_per_100_at_minus110(p_win: float, p_push: float = 0.0) -> float:
    """EV per $100 risk at -110; pushes return the stake (edge_finder.py:81-89)."""
    win_profit = 100.0 * (100.0 / 110.0)
    return p_win * win_profit - (1.0 - p_win - p_push) * 100.0


def american_implied_prob(price: int) -> float:
    return (-price) / ((-price) + 100) if price < 0 else 100 / (price + 100)


def ev_per_100(p_win: float, price: int) -> float:
    profit = 100 * (100 / (-price)) if price < 0 else 100 * (price / 100)
    return p_win * profit - (1 - p_win) * 100


def kelly_fraction(p_win: float, price: int = -110,
                   p_push: float = 0.0) -> float:
    """Full-Kelly stake fraction for a two-outcome bet at American odds,
    push-aware: maximizing E[log bankroll] over outcomes {win: +b, push:
    0, lose: -1} gives f* = (p_win*b - p_lose) / (b * (p_win + p_lose))
    with b the profit per unit stake (pushes return the stake, so they
    drop out of the optimum except through p_lose = 1 - p_win - p_push).
    Floored at 0 (never bet a negative edge).  The reference reports EV
    only (edge_finder.py:81-119) and leaves sizing to the reader; scale
    by your fractional-Kelly multiplier (half/quarter) per risk taste."""
    p_win, p_push = float(p_win), float(p_push)
    p_lose = max(0.0, 1.0 - p_win - p_push)
    b = (100.0 / -price) if price < 0 else (price / 100.0)
    denom = b * (p_win + p_lose)
    if denom <= 0:
        return 0.0
    return max(0.0, (p_win * b - p_lose) / denom)


def best_side_ev(p_over: float, price: int = -110) -> dict:
    """Pick the better of Over/Under at the same price (edge_finder.py:109-119)."""
    ev_over = ev_per_100(p_over, price)
    ev_under = ev_per_100(1 - p_over, price)
    ip = american_implied_prob(price)
    if ev_over >= ev_under:
        return {"side": "Over", "ev": ev_over, "edge": p_over - ip}
    return {"side": "Under", "ev": ev_under, "edge": (1 - p_over) - ip}


def infer_role_from_stat(stat: str) -> str:
    stat = stat.lower()
    if stat.startswith("pass_"):
        return "QB"
    if stat.startswith("rush_"):
        return "Rusher"
    return "Receiver"


# ---------------------------------------------------------------------------
# saved-file discovery & loading (edge_finder.py:22-66, 124-166)
# ---------------------------------------------------------------------------

def find_saved_files(csv_base: Optional[str] = None, team_a: Optional[str] = None,
                     team_b: Optional[str] = None, directory: str = "."
                     ) -> Tuple[Path, Optional[Path]]:
    d = Path(directory)

    def _maybe(stem: str) -> Optional[Path]:
        for ext in (".parquet", ".csv"):
            p = d / f"{stem}{ext}"
            if p.exists():
                return p
        return None

    if csv_base:
        stem = csv_base
        for suffix in (".csv", ".parquet"):
            if stem.endswith(suffix):
                stem = stem[: -len(suffix)]
        scores = _maybe(f"scores_{csv_base}") or _maybe(f"scores_{stem}")
        if scores is None:
            raise FileNotFoundError(f"Could not find scores_{csv_base} (.csv/.parquet)")
        players = _maybe(f"players_{csv_base}") or _maybe(f"players_{stem}")
        return scores, players

    if team_a is None:
        raise ValueError("Provide csv_base or team names for fuzzy search.")
    na = _norm_team(team_a)
    nb = _norm_team(team_b) if team_b else ""
    for p in sorted(d.glob("scores_*.csv")) + sorted(d.glob("scores_*.parquet")):
        low = p.name.lower()
        if na in low and nb in low:
            stem = p.name.rsplit(".", 1)[0]
            return p, _maybe(stem.replace("scores_", "players_"))
    raise FileNotFoundError("No matching scores_* file for those teams.")


def load_table(path: Path) -> pd.DataFrame:
    if str(path).lower().endswith(".parquet"):
        return pd.read_parquet(path)
    return pd.read_csv(path)


def load_players_table(players_path: Path) -> pd.DataFrame:
    """Reads players_* files; also repairs the reference's packed
    column-of-dict-strings format (edge_finder.py:131-166, minus that
    function's stray testings.csv side-effect write)."""
    df = load_table(Path(players_path))
    if len(df.columns) and all(str(c).isdigit() for c in df.columns):
        rows = []
        for c in df.columns:
            for v in df[c].dropna():
                try:
                    d = ast.literal_eval(v)
                    if isinstance(d, dict):
                        rows.append(d)
                except Exception:
                    continue
        if rows:
            df = pd.DataFrame(rows)
    df.columns = [str(c) for c in df.columns]
    for col in ("pass_yds", "rush_yds", "rec_yds", "pass_td", "rush_td", "rec_td",
                "tgt", "rec", "pass_att", "pass_comp", "sacks"):
        if col in df.columns:
            df[col] = pd.to_numeric(df[col], errors="coerce")
    df["team_low"] = df["team"].astype(str).str.lower()
    df["player_low"] = df["player"].astype(str).str.lower()
    return df


# ---------------------------------------------------------------------------
# the distribution core
# ---------------------------------------------------------------------------

class Dist:
    """Empirical distribution of one scalar market quantity.

    The single reduction core for every market in this module: margins,
    totals, and player-prop stats all become a Dist — built either from
    raw per-trial samples (the saved-file path) or from an integer-support
    histogram reduced on device (parallel.aggregate summaries) — and every
    market dict is then a formatting of the same five queries
    (over/under/push probability, mean, median).  The reference writes
    each market's numpy longhand instead (edge_finder.py:168-336); only
    the query *semantics* are parity-bound, so the structure here is
    shared rather than repeated.

    Representation notes (kept observable-identical to the pre-core code):
      * samples: median is np.median (midpoint interpolation), push is
        |x - line| <= 1e-9;
      * histogram: median is the CDF-crossing support point, push uses
        np.isclose's default tolerance on the integer support, and mean
        is the count-weighted support mean.
    """

    def __init__(self, values: Optional[np.ndarray] = None,
                 counts: Optional[np.ndarray] = None,
                 support: Optional[np.ndarray] = None):
        if (values is None) == (counts is None):
            raise ValueError("Dist takes either values or counts+support")
        if counts is not None and support is None:
            raise ValueError("Dist(counts=...) requires support")
        self.values = None if values is None else np.asarray(values, float)
        self.counts = None if counts is None else np.asarray(counts, float)
        self.support = None if support is None else np.asarray(support, float)

    @classmethod
    def from_values(cls, values) -> "Dist":
        return cls(values=np.asarray(values, float))

    @classmethod
    def from_hist(cls, counts, support) -> "Dist":
        return cls(counts=counts, support=np.asarray(support, float))

    @property
    def n(self) -> float:
        return float(self.values.size if self.values is not None
                     else self.counts.sum())

    def over(self, line: float) -> float:
        if self.values is not None:
            return float(np.mean(self.values > line))
        return float(self.counts[self.support > line].sum() / self.n)

    def under(self, line: float) -> float:
        if self.values is not None:
            return float(np.mean(self.values < line))
        return float(self.counts[self.support < line].sum() / self.n)

    def push(self, line: float) -> float:
        if self.values is not None:
            return float(np.mean(np.isclose(self.values, line, atol=1e-9)))
        return float(self.counts[np.isclose(self.support, line)].sum() / self.n)

    def mean(self) -> float:
        if self.values is not None:
            return float(np.mean(self.values))
        return float((self.counts * self.support).sum() / self.n)

    def median(self) -> float:
        if self.values is not None:
            return float(np.median(self.values))
        return float(self.support[np.searchsorted(np.cumsum(self.counts),
                                                  self.n / 2.0)])

    def pct(self, q: float) -> float:
        if self.values is not None:
            return float(np.percentile(self.values, q))
        cum = np.cumsum(self.counts)
        return float(self.support[np.searchsorted(cum, self.n * q / 100.0)])

    def affine(self, shift: float = 0.0, scale: float = 1.0) -> "Dist":
        """Calibration-corrected copy: x -> mean + scale*(x - mean) + shift
        (shift moves the location; scale widens/narrows dispersion about
        the mean).  Opt-in backtest-driven correction (round 5, VERDICT r4
        #8): every market query then prices off the corrected Dist — the
        histogram path transforms the SUPPORT, so counts (and n) are
        untouched and push semantics keep np.isclose on the (now possibly
        non-integer) support.  Identity parameters return self."""
        if shift == 0.0 and scale == 1.0:
            return self
        m = self.mean()
        if self.values is not None:
            return Dist(values=m + scale * (self.values - m) + shift)
        return Dist(counts=self.counts,
                    support=m + scale * (self.support - m) + shift)


@dataclass(frozen=True)
class MarketCalibration:
    """Opt-in affine backtest correction for the two game markets
    (round 5, VERDICT r4 #8): shifts move the location, scales widen
    dispersion about the mean — applied to the margin/total Dist before
    any query, so the main line, ladders, and moneyline stay mutually
    consistent.  Fit from real finals with `backtest.fit_calibration`
    (e.g. the 2025 31-game study measured totals running ~+15 hot:
    benchmarks/BACKTEST_2025_WK03.md); OFF by default everywhere."""
    margin_shift: float = 0.0
    margin_scale: float = 1.0
    total_shift: float = 0.0
    total_scale: float = 1.0

    def margin(self, d: Dist) -> Dist:
        return d.affine(self.margin_shift, self.margin_scale)

    def total(self, d: Dist) -> Dist:
        return d.affine(self.total_shift, self.total_scale)


def _ou_market(dist: Dist, line: float, *, head: Dict, over_key: str,
               under_key: str, digits: int, loc_prefix: str) -> Dict:
    """One two-sided market dict off a Dist: probabilities, fair prices,
    and location stats under the caller's key scheme (spread uses
    cover/notcover + margin names, totals and props use over/under)."""
    p_over, p_under, p_push = dist.over(line), dist.under(line), dist.push(line)
    return {
        **head, "samples": int(dist.n),
        f"p_{over_key}": round(p_over, digits),
        f"p_{under_key}": round(p_under, digits),
        "push_rate": round(p_push, digits),
        f"american_{over_key}": prob_to_american(p_over),
        f"american_{under_key}": prob_to_american(p_under),
        f"mean{loc_prefix}": dist.mean(),
        f"median{loc_prefix}": dist.median(),
    }


# ---------------------------------------------------------------------------
# markets (math parity: edge_finder.py:168-336; structure: Dist core)
# ---------------------------------------------------------------------------

def _player_stat_dist(csv_base: Optional[str], team: str, player: str,
                      stat: str, *, role: Optional[str] = None,
                      directory: str = ".",
                      players_df: Optional[pd.DataFrame] = None):
    """The (Dist, resolved stat column, resolved role) of one player's
    simulated stat from a players table — the shared sample lookup behind
    player_prop_odds and the prop ladder."""
    if players_df is None:
        _, players_path = find_saved_files(csv_base, team_a=team, directory=directory)
        if players_path is None or not players_path.exists():
            raise FileNotFoundError(
                "no players_* file to scan props from — rerun the sim with "
                "collect_players=True")
        players_df = load_players_table(Path(players_path))

    stat_col = STAT_ALIASES.get(stat, stat)
    if stat_col not in players_df.columns:
        raise ValueError(
            f"players table has no '{stat_col}' column (requested stat "
            f"{stat!r})")
    role = role or infer_role_from_stat(stat_col)
    if "team_low" not in players_df:
        players_df = players_df.assign(
            team_low=players_df["team"].astype(str).str.lower(),
            player_low=players_df["player"].astype(str).str.lower())
    rows = players_df.loc[(players_df["team_low"] == team.lower())
                          & (players_df["player_low"] == player.lower())
                          & (players_df["role"] == role)]
    if rows.empty:
        raise ValueError(f"{player} ({role}) never appears for {team} in the "
                         "players table")
    samples = pd.to_numeric(rows[stat_col], errors="coerce").dropna().to_numpy()
    if samples.size == 0:
        raise ValueError(f"{player}'s {stat_col} column holds no numeric "
                         "samples")
    return Dist.from_values(samples), stat_col, role


def player_prop_odds(csv_base: Optional[str], team: str, player: str, stat: str,
                     line: float, *, role: Optional[str] = None,
                     directory: str = ".",
                     players_df: Optional[pd.DataFrame] = None) -> Dict:
    d, stat_col, role = _player_stat_dist(
        csv_base, team, player, stat, role=role, directory=directory,
        players_df=players_df)
    market = _ou_market(
        d, float(line), digits=4, over_key="over", under_key="under",
        loc_prefix="",
        head={"team": team, "player": player, "role": role, "stat": stat_col,
              "line": float(line)})
    pick = best_side_ev(d.over(line), price=-110)
    market.update({
        "p75": d.pct(75), "p90": d.pct(90),
        "best_side": pick["side"], "edge": round(pick["edge"] * 100, 2),
        "ev_per_$100": round(pick["ev"], 2),
    })
    # key order parity with the pre-core schema (mean/median before p75)
    order = ["team", "player", "role", "stat", "line", "samples",
             "p_over", "p_under", "push_rate", "american_over",
             "american_under", "mean", "median", "p75", "p90",
             "best_side", "edge", "ev_per_$100"]
    return {k: market[k] for k in order}


def _team_rows(sims: pd.DataFrame, team: str, opp: str) -> pd.DataFrame:
    return sims[(sims["team"].astype(str).str.lower() == team.lower())
                & (sims["opp"].astype(str).str.lower() == opp.lower())]


def _margin_dist(sims: pd.DataFrame, team: str, opp: str) -> Optional[Dist]:
    rows = _team_rows(sims, team, opp)
    if rows.empty:
        return None
    return Dist.from_values((rows["pts"] - rows["opp_pts"]).to_numpy())


def moneyline_from_sims(csv_base: Optional[str], team: str, opp: str,
                        directory: str = ".",
                        sims: Optional[pd.DataFrame] = None) -> Dict:
    if sims is None:
        scores_path, _ = find_saved_files(csv_base, team_a=team, team_b=opp,
                                          directory=directory)
        sims = load_table(scores_path)

    dists = (_margin_dist(sims, team, opp), _margin_dist(sims, opp, team))
    p_team, p_opp = (float("nan") if d is None else d.over(0.0) for d in dists)
    if not np.isfinite(p_team) and np.isfinite(p_opp):
        p_team = min(max(1.0 - p_opp, 0.0), 1.0)
    if not np.isfinite(p_opp) and np.isfinite(p_team):
        p_opp = min(max(1.0 - p_team, 0.0), 1.0)
    return {
        "team": {"name": team, "p_win": round(p_team, 6),
                 "ml_fair": prob_to_american(p_team)},
        "opp": {"name": opp, "p_win": round(p_opp, 6),
                "ml_fair": prob_to_american(p_opp)},
    }


def _spread_market(margins: Dist, team: str, opp: str, spread: float) -> Dict:
    """Cover iff margin > -spread, push at equality (edge_finder.py:308-313)."""
    return _ou_market(
        margins, -float(spread), digits=6, over_key="cover",
        under_key="notcover", loc_prefix="_margin",
        head={"team": team, "opp": opp, "spread": float(spread)})


def _total_market(totals: Dist, team: str, opp: str, total: float) -> Dict:
    return _ou_market(
        totals, float(total), digits=6, over_key="over", under_key="under",
        loc_prefix="_total",
        head={"team": team, "opp": opp, "total": float(total)})


def game_market_odds(csv_base: Optional[str], team: str, opp: str, *,
                     spread: Optional[float] = None, total: Optional[float] = None,
                     directory: str = ".",
                     sims: Optional[pd.DataFrame] = None) -> Dict:
    """Spread cover P and total over/under P from saved or in-memory sims
    (math parity edge_finder.py:283-336, computed through the Dist core)."""
    if sims is None:
        scores_path, _ = find_saved_files(csv_base, team_a=team, team_b=opp,
                                          directory=directory)
        sims = load_table(scores_path)
    sims = _team_rows(sims, team, opp)
    if sims.empty:
        raise ValueError(
            f"scores data holds no rows from {team}'s perspective vs {opp}")

    out: Dict = {}
    if spread is not None:
        margins = Dist.from_values((sims["pts"] - sims["opp_pts"]).to_numpy())
        out["spread"] = _spread_market(margins, team, opp, spread)
    if total is not None:
        totals = Dist.from_values((sims["pts"] + sims["opp_pts"]).to_numpy())
        out["total"] = _total_market(totals, team, opp, total)
    if not out:
        raise ValueError("nothing to price: pass spread= and/or total=")
    return out


def scan_props_for_matchup(csv_base: Optional[str], team_a: str, team_b: str,
                           prop_sheet_path: str, directory: str = ".",
                           min_abs_edge_pct: float = 2.0,
                           players_df: Optional[pd.DataFrame] = None) -> pd.DataFrame:
    """Scan a prop sheet for both teams; keep |edge| >= threshold
    (edge_finder.py:340-390)."""
    props = pd.read_csv(prop_sheet_path)
    props["team_low"] = props["team"].astype(str).str.lower()
    keep = props[props["team_low"].isin({team_a.lower(), team_b.lower()})]
    results = []
    for _, r in keep.iterrows():
        stat_col = STAT_ALIASES.get(str(r["stat"]), str(r["stat"]))
        try:
            out = player_prop_odds(
                csv_base, r["team"], r["player"], stat_col, float(r["yards"]),
                directory=directory, players_df=players_df)
            results.append({
                "team": r["team"], "player": r["player"], "stat": stat_col,
                "line": float(r["yards"]), "best_side": out["best_side"],
                "p_over": out["p_over"], "p_under": out["p_under"],
                "edge_pct": out["edge"], "ev_$100": out["ev_per_$100"],
                "mean": out["mean"], "median": out["median"],
                "samples": out["samples"],
            })
        except Exception:
            continue
    if not results:
        return pd.DataFrame()
    df = pd.DataFrame(results)
    df["abs_edge"] = df["edge_pct"].abs()
    df = df.sort_values(["abs_edge", "ev_$100"], ascending=[False, False])
    return df[df["abs_edge"] >= min_abs_edge_pct].drop(columns=["abs_edge"])


_STAT_TO_ROLE_COL = {
    # stat column -> (role name, pstats column index)
    "pass_yds": ("pass", 2), "pass_td": ("pass", 3), "pass_att": ("pass", 0),
    "pass_comp": ("pass", 1), "INT": ("pass", 4), "sacks": ("pass", 5),
    "rush_yds": ("rush", 2), "rush_td": ("rush", 3), "rush_att": ("rush", 0),
    "rec_yds": ("rec", 2), "rec_td": ("rec", 3), "rec": ("rec", 1),
    "tgt": ("rec", 0),
}


def _resolve_stat_target(tc, player, stat, *, strict: bool):
    """Resolve one (player, stat) naming on a team context to pstats
    coordinates: (role, slot, col, canonical stat name).  THE shared core
    of the prop scan and parlay prop legs, so a roster/stat-layout change
    can never make them resolve the same player differently.  strict=False
    returns None on anything unresolvable (the reference's skip-on-error
    scan semantics, edge_finder.py:380-382); strict=True raises — a
    silently dropped parlay leg would price a different ticket."""
    from .stats import ROLE_PASS, ROLE_REC, ROLE_RUSH

    role_idx = {"pass": ROLE_PASS, "rush": ROLE_RUSH, "rec": ROLE_REC}
    stat_col = STAT_ALIASES.get(str(stat), str(stat))
    rc = _STAT_TO_ROLE_COL.get(stat_col)
    if rc is None:
        if strict:
            raise ValueError(f"unknown prop stat {stat!r}")
        return None
    role_name, col = rc
    table = {"pass": tc.qb, "rush": tc.rush, "rec": tc.target}[role_name]
    want = str(player).lower()
    slot = next((k for k, nm in enumerate(table.names)
                 if str(nm).lower() == want and table.tracked[k]), None)
    if slot is None:
        if strict:
            raise ValueError(
                f"player {player!r} is not tracked for {tc.name}; "
                "parlay legs need a tracked player")
        return None
    return role_idx[role_name], slot, col, stat_col


def resolve_prop_rows(team_a_ctx, team_b_ctx, props: pd.DataFrame):
    """Map a prop sheet's rows onto one matchup's pstats coordinates.

    Returns (indices, meta): indices = (side, role, slot, col, line) int32/
    f32 arrays PADDED to a multiple of 8 rows (by repeating the first row)
    so reduce_props_device compiles once per padded size and is reused
    across a slate's matchups; meta is the unpadded row list — hosts slice
    reductions to len(meta).  Rows naming an untracked player, a team not
    in this matchup, or an unknown stat are skipped (reference behavior:
    skip-on-error, edge_finder.py:380-382)."""
    sides = {_norm_team(team_a_ctx.name): (0, team_a_ctx),
             _norm_team(team_b_ctx.name): (1, team_b_ctx)}

    rows, meta = [], []
    for _, r in props.iterrows():
        key = _norm_team(r["team"])
        if key not in sides:
            continue
        side, tc = sides[key]
        hit = _resolve_stat_target(tc, r["player"], r["stat"], strict=False)
        if hit is None:
            continue
        role, slot, col, stat_col = hit
        rows.append((side, role, slot, col, float(r["yards"])))
        meta.append({"team": r["team"], "player": r["player"],
                     "stat": stat_col, "line": float(r["yards"])})
    if not rows:
        return None, []
    pad = (-len(rows)) % 8
    rows = rows + [rows[0]] * pad
    idx = np.asarray(rows, dtype=np.float32)
    side_i, role_i, slot_i, col_i = (
        idx[:, j].astype(np.int32) for j in range(4))
    return (side_i, role_i, slot_i, col_i, idx[:, 4]), meta


@lru_cache(maxsize=1)
def _reduce_props_jit():
    import jax
    import jax.numpy as jnp

    @jax.jit
    def reduce_props(pstats, side_i, role_i, slot_i, col_i, lines):
        vals = pstats[:, side_i, role_i, slot_i, col_i]     # (B, P)
        # reference semantics (edge_finder.py:182-205 over players-file
        # rows): a player only has a row in sims where they recorded ANY
        # stat, so prop probabilities condition on that activity
        act = (pstats[:, side_i, role_i, slot_i, :] != 0).any(axis=-1)
        cnt = jnp.maximum(1.0, act.sum(axis=0).astype(jnp.float32))
        masked = jnp.where(act, vals, jnp.nan)
        return {
            "p_over": ((vals > lines[None, :]) & act).sum(axis=0) / cnt,
            "p_under": ((vals < lines[None, :]) & act).sum(axis=0) / cnt,
            "push": ((jnp.abs(vals - lines[None, :]) <= 1e-9) & act
                     ).sum(axis=0) / cnt,
            "mean": jnp.where(act, vals, 0.0).sum(axis=0) / cnt,
            "median": jnp.nanpercentile(masked, 50.0, axis=0),
            "p75": jnp.nanpercentile(masked, 75.0, axis=0),
            "p90": jnp.nanpercentile(masked, 90.0, axis=0),
            "n_active": cnt,
        }

    return reduce_props


def reduce_props_device(pstats, indices):
    """One jitted pass turning (B, ...) pstats into per-prop scalars; the
    returned dict stays DEVICE-resident so slate drivers can enqueue every
    matchup's reduction before any host transfer."""
    return _reduce_props_jit()(pstats, *indices)


def prop_table_from_reductions(meta, red, min_abs_edge_pct: float = 2.0
                               ) -> pd.DataFrame:
    """Finalize host-side reductions (np arrays, padded len >= len(meta))
    into the scan_props_for_matchup output schema + edge/EV columns."""
    results = []
    for i, m in enumerate(meta):
        p_over = float(red["p_over"][i])
        rec = best_side_ev(p_over, price=-110)
        results.append({
            **m, "best_side": rec["side"],
            "p_over": round(p_over, 4),
            "p_under": round(float(red["p_under"][i]), 4),
            "edge_pct": round(rec["edge"] * 100, 2),
            "ev_$100": round(rec["ev"], 2),
            "mean": float(red["mean"][i]), "median": float(red["median"][i]),
            "p75": float(red["p75"][i]), "p90": float(red["p90"][i]),
            "samples": int(red["n_active"][i]),
        })
    df = pd.DataFrame(results)
    df["abs_edge"] = df["edge_pct"].abs()
    df = df.sort_values(["abs_edge", "ev_$100"], ascending=[False, False])
    return df[df["abs_edge"] >= min_abs_edge_pct].drop(columns=["abs_edge"])


def scan_props_device(out, team_a_ctx, team_b_ctx, prop_sheet_path: str,
                      min_abs_edge_pct: float = 2.0) -> pd.DataFrame:
    """Prop scan over DEVICE-resident player stats: same math and output
    schema as scan_props_for_matchup (edge_finder.py:340-390), but the
    per-prop reductions (P(over/under/push), mean/median/p75/p90) run on the
    accelerator in one jitted pass over the GameState's pstats — no player
    parquet round-trip, no pandas row explosion.

    `out` is a GameState with collect_players=True; prop rows that name an
    untracked player or unknown stat are skipped (reference behavior:
    skip-on-error, edge_finder.py:380-382)."""
    indices, meta = resolve_prop_rows(team_a_ctx, team_b_ctx,
                                      pd.read_csv(prop_sheet_path))
    if not meta:
        return pd.DataFrame()
    from .utils.transfer import fetch_tree
    red = fetch_tree(reduce_props_device(out.pstats, indices))
    return prop_table_from_reductions(meta, red, min_abs_edge_pct)


# ---------------------------------------------------------------------------
# same-game parlay pricing (joint per-trial distribution)
#
# No reference counterpart: edge_finder.py prices every market from its own
# MARGINAL distribution (spread :308-313, total :321-332, props :168-231),
# so a multi-leg ticket inside one game — where the legs are correlated
# through the shared game script — cannot be priced there at all.  The
# device engine holds the full joint (score, player-stat) sample per trial,
# so joint settlement is one reduction over the trial axis.
# ---------------------------------------------------------------------------

_SRC_MARGIN, _SRC_TOTAL, _SRC_PSTAT = 0, 1, 2


def resolve_parlay_legs(team_a_ctx, team_b_ctx, legs):
    """Validate and encode same-game-parlay legs for one matchup.

    Each leg is a dict:

    * ``{"kind": "spread", "team": <name>, "line": -3.5}`` — wins iff the
      team's margin > -line (cover semantics of _spread_market /
      edge_finder.py:308-313); push at equality.
    * ``{"kind": "moneyline", "team": <name>}`` — wins iff the team's
      margin > 0; a tie is a push (void), as in moneyline_from_sims.
    * ``{"kind": "total", "side": "over"|"under", "line": 55.5}``.
    * ``{"kind": "prop", "team": <name>, "player": <name>, "stat": <stat>,
      "side": "over"|"under", "line": 249.5}`` — stat names accept the
      prop-sheet aliases (STAT_ALIASES).

    Returns (arrays, meta): arrays = (src, side, role, slot, col, sgn, drn,
    thr) for the jitted reduction; meta = human-readable leg labels.
    Unlike resolve_prop_rows (which keeps the reference's skip-on-error
    scan semantics), an unresolvable leg raises ValueError — a parlay with
    a silently dropped leg would price a different ticket."""
    sides = {_norm_team(team_a_ctx.name): (0, team_a_ctx, 1.0),
             _norm_team(team_b_ctx.name): (1, team_b_ctx, -1.0)}

    def _side(leg):
        key = _norm_team(str(leg["team"]))
        if key not in sides:
            raise ValueError(
                f"parlay leg team {leg['team']!r} is not in this matchup "
                f"({team_a_ctx.name} vs {team_b_ctx.name})")
        return sides[key]

    def _drn(leg):
        side = str(leg.get("side", "")).strip().lower()
        if side not in ("over", "under"):
            raise ValueError(
                f"parlay {leg.get('kind')} leg needs side 'over' or "
                f"'under', got {leg.get('side')!r}")
        return 1.0 if side == "over" else -1.0

    rows, meta = [], []
    for leg in legs:
        if not isinstance(leg, dict):
            raise ValueError(
                f"each parlay leg must be an object/dict, got "
                f"{type(leg).__name__}: {leg!r}")
        kind = str(leg.get("kind", "")).strip().lower()
        if kind == "spread":
            _, tc, sgn = _side(leg)
            line = float(leg["line"])
            rows.append((_SRC_MARGIN, 0, 0, 0, 0, sgn, 1.0, -line))
            meta.append({"kind": kind,
                         "label": f"{tc.name} {line:+g}"})
        elif kind == "moneyline":
            _, tc, sgn = _side(leg)
            rows.append((_SRC_MARGIN, 0, 0, 0, 0, sgn, 1.0, 0.0))
            meta.append({"kind": kind, "label": f"{tc.name} ML"})
        elif kind == "total":
            drn = _drn(leg)
            line = float(leg["line"])
            rows.append((_SRC_TOTAL, 0, 0, 0, 0, 1.0, drn, line))
            meta.append({"kind": kind,
                         "label": f"{leg['side'].title()} {line:g}"})
        elif kind == "prop":
            side_i, tc, _ = _side(leg)
            role, slot, col, stat_col = _resolve_stat_target(
                tc, leg["player"], leg["stat"], strict=True)
            drn = _drn(leg)
            line = float(leg["line"])
            rows.append((_SRC_PSTAT, side_i, role, slot, col, 1.0, drn,
                         line))
            meta.append({"kind": kind,
                         "label": (f"{leg['player']} {leg['side'].title()} "
                                   f"{line:g} {stat_col}")})
        else:
            raise ValueError(
                f"unknown parlay leg kind {leg.get('kind')!r} (want "
                "spread | moneyline | total | prop)")
    if not rows:
        raise ValueError("parlay needs at least one leg")
    arr = np.asarray(rows, dtype=np.float32)
    ints = tuple(arr[:, j].astype(np.int32) for j in range(5))
    return ints + (arr[:, 5], arr[:, 6], arr[:, 7]), meta


def _settle_legs(jnp, score, pstats, src, side, role, slot, col, sgn, drn,
                 thr):
    """Per-trial (B, L) win/push masks for resolved legs — THE settlement
    semantics, shared by the parlay reducer and the correlation kernel so
    they can never drift apart."""
    margin = (score[:, 0] - score[:, 1]).astype(jnp.float32)       # A view
    total = score.sum(axis=1).astype(jnp.float32)
    pv = pstats[:, side, role, slot, col]                          # (B, L)
    game = jnp.where(src[None, :] == _SRC_MARGIN,
                     margin[:, None] * sgn[None, :], total[:, None])
    v = jnp.where(src[None, :] == _SRC_PSTAT, pv, game)
    win = jnp.where(drn[None, :] > 0, v > thr[None, :], v < thr[None, :])
    push = jnp.abs(v - thr[None, :]) <= 1e-9
    return win, push


@lru_cache(maxsize=1)
def _reduce_parlay_jit():
    import jax
    import jax.numpy as jnp

    @jax.jit
    def reduce_parlay(score, pstats, src, side, role, slot, col, sgn, drn,
                      thr):
        win, push = _settle_legs(jnp, score, pstats, src, side, role, slot,
                                 col, sgn, drn, thr)
        lose = ~(win | push)
        return {
            "leg_win": win.sum(axis=0, dtype=jnp.int32),
            "leg_push": push.sum(axis=0, dtype=jnp.int32),
            "all_win": win.all(axis=1).sum(dtype=jnp.int32),
            "no_lose": (~lose.any(axis=1)).sum(dtype=jnp.int32),
            "all_push": push.all(axis=1).sum(dtype=jnp.int32),
        }

    return reduce_parlay


def parlay_odds(out, team_a_ctx, team_b_ctx, legs,
                price: Optional[int] = None, *, resolved=None) -> Dict:
    """Price a same-game parlay off the JOINT per-trial distribution.

    `out` is a GameState from MatchupRunner.run_pairs (device-resident);
    settlement runs in one jitted reduction over the trial axis and the
    scalar counts come back in one packed transfer.

    Settlement follows standard book rules per simulated game: the ticket
    loses iff any leg loses; pushed legs are voided (the parlay reduces);
    all legs pushed = full refund.  Pricing treats BOTH full voids and
    reduced wins as stake-back refunds, consistently across every metric:
    the headline fair-odds probability ``p_parlay`` is
    P(all legs win) / (P(all win) + P(lose)), and the quoted-price
    edge/EV/Kelly use the same convention.  Because a reduced win really
    pays more than the stake back, the fair price is a floor on the
    ticket's true value (exact when no leg can push, e.g. all half-point
    lines).

    ``correlation_mult`` = p_all_win / prod(marginal leg win probs): the
    same-game correlation a marginal pricer (the reference's edge_finder)
    structurally cannot see — >1 means the legs help each other.

    Prop legs settle UNCONDITIONALLY (a trial where the player never
    records a stat counts at value 0), unlike scan_props_device's
    activity-conditioned marginals (edge_finder.py:182-205): a parlay leg
    cannot condition away games where its player sat.

    `resolved` accepts a pre-computed resolve_parlay_legs result so
    callers that validate legs before simulating (api.simulate_parlay)
    don't resolve twice."""
    from .utils.transfer import fetch_tree

    arrays, meta = resolved if resolved is not None else \
        resolve_parlay_legs(team_a_ctx, team_b_ctx, legs)
    if any(m["kind"] == "prop" for m in meta) and (
            out.pstats.ndim != 5 or out.pstats.shape[1] != 2):
        raise ValueError(
            "prop parlay legs need per-player stats: run with "
            "collect_players=True")
    red = fetch_tree(_reduce_parlay_jit()(out.score, out.pstats, *arrays))
    n = float(out.score.shape[0])

    p_all_win = float(red["all_win"]) / n
    p_no_lose = float(red["no_lose"]) / n
    p_void = float(red["all_push"]) / n
    p_win_reduced = p_no_lose - p_all_win - p_void
    # refund semantics: void AND reduced-win mass returns the stake, so
    # the fair full-win price conditions on the decisive outcomes only —
    # consistent with the edge/EV/Kelly below (_priced_block)
    p_parlay = p_all_win / max(p_all_win + (1.0 - p_no_lose), 1e-12)
    leg_p = [float(w) / n for w in red["leg_win"]]
    p_independent = float(np.prod(leg_p))
    res: Dict = {
        "team": team_a_ctx.name, "opp": team_b_ctx.name, "n": int(n),
        "legs": [{**m, "p_win": round(p, 6), "p_push": round(float(q) / n, 6)}
                 for m, p, q in zip(meta, leg_p, red["leg_push"])],
        "p_all_win": round(p_all_win, 6),
        "p_lose": round(1.0 - p_no_lose, 6),
        "p_void": round(p_void, 6),
        "p_win_reduced": round(p_win_reduced, 6),
        "p_parlay": round(p_parlay, 6),
        "fair_american": prob_to_american(p_parlay),
        "p_independent": round(p_independent, 6),
        "fair_american_independent": prob_to_american(p_independent),
        "correlation_mult": (round(p_all_win / p_independent, 4)
                             if p_independent > 0 else float("nan")),
    }
    if price is not None:
        res.update(_priced_block(p_all_win, p_no_lose, p_parlay, price))
    return res


def _priced_block(p_all_win: float, p_no_lose: float, p_parlay: float,
                  price: int) -> Dict:
    """Quoted-price metrics shared by parlay_odds and cross_game_parlay —
    refund semantics throughout (full voids and reduced wins return the
    stake, same stake-back convention as ev_per_100_at_minus110)."""
    price = int(price)
    profit = 100 * (100 / (-price)) if price < 0 else price
    ev = p_all_win * profit - (1.0 - p_no_lose) * 100.0
    return {
        "price": price,
        "edge_pct": round((p_parlay - american_implied_prob(price))
                          * 100, 2),
        "ev_$100": round(ev, 2),
        "kelly": round(kelly_fraction(
            p_all_win, price,
            p_push=max(0.0, p_no_lose - p_all_win)), 4),
    }


@lru_cache(maxsize=1)
def _leg_corr_jit():
    import jax
    import jax.numpy as jnp

    @jax.jit
    def leg_corr(score, pstats, src, side, role, slot, col, sgn, drn, thr):
        win, _ = _settle_legs(jnp, score, pstats, src, side, role, slot,
                              col, sgn, drn, thr)
        w = win.astype(jnp.float32)   # win indicator (pushes = non-wins)
        B = w.shape[0]
        mu = w.mean(axis=0)
        cov = w.T @ w / B - mu[:, None] * mu[None, :]
        sd = jnp.sqrt(jnp.maximum(jnp.diagonal(cov), 0.0))
        denom = sd[:, None] * sd[None, :]
        return jnp.where(denom > 0, cov / jnp.maximum(denom, 1e-30),
                         jnp.nan)

    return leg_corr


def parlay_correlations(out, team_a_ctx, team_b_ctx, legs, *,
                        resolved=None) -> pd.DataFrame:
    """Pairwise Pearson correlations between the legs' WIN indicators over
    the joint trial sample (pushes count as non-wins).  A ticket-building
    diagnostic for parlay_odds: legs with positive correlation price above
    their independence product, negative below.  Impossible in the
    reference for the same reason as parlay_odds — edge_finder.py never
    sees two markets' outcomes on the same trial.  `resolved` accepts a
    pre-computed resolve_parlay_legs result (same as parlay_odds)."""
    from .utils.transfer import fetch_tree

    arrays, meta = resolved if resolved is not None else \
        resolve_parlay_legs(team_a_ctx, team_b_ctx, legs)
    if any(m["kind"] == "prop" for m in meta) and (
            out.pstats.ndim != 5 or out.pstats.shape[1] != 2):
        raise ValueError(
            "prop parlay legs need per-player stats: run with "
            "collect_players=True")
    corr = fetch_tree(_leg_corr_jit()(out.score, out.pstats, *arrays))
    labels = [m["label"] for m in meta]
    return pd.DataFrame(np.asarray(corr, dtype=float), index=labels,
                        columns=labels)


def tease_legs(legs, points: float):
    """Teaser transform: move every spread/total leg `points` in the
    bettor's favor (spreads gain points; Over totals drop, Under totals
    rise).  Returns NEW leg dicts for the ordinary pricing paths — a
    teaser is just a parlay at shifted lines, so `parlay_odds` (same game)
    or per-game blocks + `cross_game_parlay` (the classic multi-game
    teaser) price it with the joint-settlement semantics already tested
    there.  Push handling follows those paths: a pushed leg voids and
    reduces the ticket ("push reduces"); books that grade ties-lose price
    lower than this.  Moneyline/prop legs are not teasable and are
    refused — silently passing one through would price a different
    ticket.  No reference counterpart (edge_finder.py prices single
    marginals at the quoted line only)."""
    points = float(points)
    if points < 0:
        raise ValueError(f"teaser points must be >= 0, got {points}")
    out = []
    for leg in legs:
        if not isinstance(leg, dict):
            raise ValueError(
                f"each teaser leg must be an object/dict, got "
                f"{type(leg).__name__}: {leg!r}")
        kind = str(leg.get("kind", "")).strip().lower()
        if kind == "spread":
            out.append({**leg, "line": float(leg["line"]) + points})
        elif kind == "total":
            side = str(leg.get("side", "")).strip().lower()
            if side not in ("over", "under"):
                raise ValueError(
                    f"teaser total leg needs side 'over' or 'under', got "
                    f"{leg.get('side')!r}")
            shift = -points if side == "over" else points
            out.append({**leg, "line": float(leg["line"]) + shift})
        else:
            raise ValueError(
                f"teasers take spread/total legs only, got kind "
                f"{leg.get('kind')!r}")
    return out


def cross_game_parlay(blocks, price: Optional[int] = None) -> Dict:
    """Combine per-game parlay blocks into one cross-game ticket.

    `blocks` are parlay_odds results for DISTINCT matchups.  Distinct games
    are simulated independently (separate trial streams), so the joint
    settlement probabilities multiply exactly — no approximation: the
    ticket loses iff any block loses, is fully void iff every block is,
    and wins whole iff every block does.  Within-game correlation stays
    fully priced inside each block; `correlation_mult` is therefore the
    product of the blocks' own multipliers (vs pricing every leg
    independently, as a marginal-only pricer would)."""
    if not blocks:
        raise ValueError("cross-game parlay needs at least one block")
    seen = set()
    for blk in blocks:
        g = (_norm_team(blk["team"]), _norm_team(blk["opp"]))
        if g in seen or g[::-1] in seen:
            raise ValueError(
                f"two blocks price the same game {blk['team']} vs "
                f"{blk['opp']}: merge their legs into ONE same-game block "
                "(blocks multiply as independent, same-game legs are not)")
        seen.add(g)
    p_all_win = float(np.prod([b["p_all_win"] for b in blocks]))
    p_no_lose = float(np.prod([1.0 - b["p_lose"] for b in blocks]))
    p_void = float(np.prod([b["p_void"] for b in blocks]))
    p_independent = float(np.prod([b["p_independent"] for b in blocks]))
    # same refund semantics as parlay_odds: decisive outcomes only
    p_parlay = p_all_win / max(p_all_win + (1.0 - p_no_lose), 1e-12)
    res: Dict = {
        "games": [f"{b['team']} vs {b['opp']}" for b in blocks],
        "legs": [{**leg, "game": f"{b['team']} vs {b['opp']}"}
                 for b in blocks for leg in b["legs"]],
        "p_all_win": round(p_all_win, 6),
        "p_lose": round(1.0 - p_no_lose, 6),
        "p_void": round(p_void, 6),
        "p_win_reduced": round(max(0.0, p_no_lose - p_all_win - p_void), 6),
        "p_parlay": round(p_parlay, 6),
        "fair_american": prob_to_american(p_parlay),
        "p_independent": round(p_independent, 6),
        "fair_american_independent": prob_to_american(p_independent),
        "correlation_mult": (round(p_all_win / p_independent, 4)
                             if p_independent > 0 else float("nan")),
    }
    if price is not None:
        res.update(_priced_block(p_all_win, p_no_lose, p_parlay, price))
    return res


@lru_cache(maxsize=1)
def _round_robin_jit():
    import jax
    import jax.numpy as jnp

    @jax.jit
    def reduce_rr(score, pstats, mask, kvec, src, side, role, slot, col,
                  sgn, drn, thr):
        win, push = _settle_legs(jnp, score, pstats, src, side, role, slot,
                                 col, sgn, drn, thr)
        lose = ~(win | push)
        # Subset membership counts via one matmul each: (B, L) @ (L, S).
        # Counts are tiny integers, exact in f32, and the matmul lands on
        # the matrix units — cheaper than materializing an (S, B, L) broadcast.
        m = mask.astype(jnp.float32).T                     # (L, S)
        cw = win.astype(jnp.float32) @ m                   # member wins
        cl = lose.astype(jnp.float32) @ m                  # member losses
        cp = push.astype(jnp.float32) @ m                  # member pushes
        full = kvec[None, :] - 0.5                         # "all k members"
        tick_win = cw > full
        return {
            "all_win": tick_win.sum(axis=0, dtype=jnp.int32),
            "no_lose": (cl < 0.5).sum(axis=0, dtype=jnp.int32),
            "all_push": (cp > full).sum(axis=0, dtype=jnp.int32),
            "any_win": tick_win.any(axis=1).sum(dtype=jnp.int32),
            "every_win": tick_win.all(axis=1).sum(dtype=jnp.int32),
        }

    return reduce_rr


def _rr_sizes(by, n_legs: int):
    """Normalize a round-robin size spec (int or iterable of ints) and
    validate it against the leg count."""
    def _as_size(k):
        # bools are int subclasses, and float sizes like 2.5 must not
        # silently truncate to 2 — both are caller errors
        if isinstance(k, (bool, np.bool_)) or float(k) != int(k):
            raise ValueError(
                f"round-robin ticket size must be an integer, got {k!r}")
        return int(k)

    # strings iterate character-wise (by='23' would silently become sizes
    # {2, 3}) and np.bool_ is neither int nor bool — reject both up front
    # with the intended ValueError (ADVICE r4)
    if isinstance(by, (str, bytes, np.bool_)):
        raise ValueError(
            f"round-robin size spec must be an int or an iterable of "
            f"ints, got {by!r}")
    scalar = isinstance(by, (int, float, np.integer, np.floating))
    ks = sorted({_as_size(k) for k in ((by,) if scalar else by)})
    if not ks:
        raise ValueError("round robin needs at least one ticket size")
    for k in ks:
        if not 1 <= k <= n_legs:
            raise ValueError(
                f"round-robin ticket size {k} is invalid for {n_legs} legs")
    return ks


def round_robin(out, team_a_ctx, team_b_ctx, legs, by=2,
                price: Optional[int] = None, *, resolved=None,
                max_tickets: int = 512) -> Dict:
    """Price a same-game round robin: every `by`-leg combination of the
    legs as its own parlay ticket (`by` may be one size or several, e.g.
    (2, 3) = all doubles and trebles).  Books sell these as one card with
    a unit stake per ticket.

    All legs settle ONCE per trial through the shared `_settle_legs`
    kernel, and every ticket's joint outcome reduces in the same jitted
    launch (subset-count matmuls) with one packed transfer — a 6-leg
    by-2/3 card (35 tickets) costs the same device round trip as one
    parlay.  Each ticket carries the exact `parlay_odds` refund
    semantics: pushed members void and reduce the ticket, all-push
    refunds, `p_parlay` conditions on decisive outcomes.

    Card-level fields: `p_any_ticket_wins` (some ticket pays in full),
    `p_all_tickets_win` (every member leg won), and — when `price` is
    given, applied per ticket as the constant-juice yardstick —
    `ev_total_$100` (sum over tickets at $100 each, the card's EV).

    No reference counterpart: edge_finder.py prices single marginals at
    one quoted line (:283-336); a round robin needs every pair of
    markets settled on the same trial."""
    import itertools

    from .utils.transfer import fetch_tree

    arrays, meta = resolved if resolved is not None else \
        resolve_parlay_legs(team_a_ctx, team_b_ctx, legs)
    if any(m["kind"] == "prop" for m in meta) and (
            out.pstats.ndim != 5 or out.pstats.shape[1] != 2):
        raise ValueError(
            "prop parlay legs need per-player stats: run with "
            "collect_players=True")
    n_legs = len(meta)
    ks = _rr_sizes(by, n_legs)
    combos = [c for k in ks for c in itertools.combinations(range(n_legs), k)]
    if len(combos) > max_tickets:
        raise ValueError(
            f"round robin of sizes {ks} over {n_legs} legs writes "
            f"{len(combos)} tickets (> max_tickets={max_tickets})")
    mask = np.zeros((len(combos), n_legs), dtype=bool)
    for i, c in enumerate(combos):
        mask[i, list(c)] = True
    kvec = mask.sum(axis=1).astype(np.float32)
    red = fetch_tree(_round_robin_jit()(
        out.score, out.pstats, mask, kvec, *arrays))
    n = float(out.score.shape[0])
    labels = [m["label"] for m in meta]

    tickets = []
    for i, c in enumerate(combos):
        p_all_win = float(red["all_win"][i]) / n
        p_no_lose = float(red["no_lose"][i]) / n
        p_void = float(red["all_push"][i]) / n
        p_parlay = p_all_win / max(p_all_win + (1.0 - p_no_lose), 1e-12)
        t: Dict = {
            "legs": [labels[j] for j in c], "k": int(len(c)),
            "p_all_win": round(p_all_win, 6),
            "p_lose": round(1.0 - p_no_lose, 6),
            "p_void": round(p_void, 6),
            "p_win_reduced": round(
                max(0.0, p_no_lose - p_all_win - p_void), 6),
            "p_parlay": round(p_parlay, 6),
            "fair_american": prob_to_american(p_parlay),
        }
        if price is not None:
            t.update(_priced_block(p_all_win, p_no_lose, p_parlay, price))
        tickets.append(t)

    res: Dict = {
        "team": team_a_ctx.name, "opp": team_b_ctx.name, "n": int(n),
        "by": ks, "n_tickets": len(tickets), "leg_labels": labels,
        "p_any_ticket_wins": round(float(red["any_win"]) / n, 6),
        "p_all_tickets_win": round(float(red["every_win"]) / n, 6),
        "tickets": tickets,
    }
    if price is not None:
        res["price"] = int(price)
        res["stake_$"] = 100 * len(tickets)
        res["ev_total_$100"] = round(sum(t["ev_$100"] for t in tickets), 2)
    return res


def round_robin_blocks(blocks, by=2, price: Optional[int] = None) -> Dict:
    """Round robin over cross-game parlay blocks: every `by`-block
    combination priced as an exact `cross_game_parlay` ticket (distinct
    games are independent sims, so each ticket's probabilities are block
    products — no approximation, and within-game correlation stays priced
    inside each block).

    Card aggregates ride the same independence: the number of winning
    blocks is Poisson-binomial over the blocks' `p_all_win`
    (`season_win_pmf` — the season projector's composition fact), so
    `p_any_ticket_wins` = P(at least min(by) blocks win whole) and
    `p_all_tickets_win` = P(all do).  The classic Saturday card (N games,
    all doubles + trebles) prices in one call off N already-run sims."""
    ks = _rr_sizes(by, len(blocks))
    import itertools

    combos = [c for k in ks
              for c in itertools.combinations(range(len(blocks)), k)]
    tickets = [cross_game_parlay([blocks[j] for j in c], price=price)
               for c in combos]
    pmf = season_win_pmf([b["p_all_win"] for b in blocks])
    res: Dict = {
        "games": [f"{b['team']} vs {b['opp']}" for b in blocks],
        "by": ks, "n_tickets": len(tickets),
        "p_any_ticket_wins": round(float(pmf[min(ks):].sum()), 6),
        "p_all_tickets_win": round(float(pmf[-1]), 6),
        "tickets": tickets,
    }
    if price is not None:
        res["price"] = int(price)
        res["stake_$"] = 100 * len(tickets)
        res["ev_total_$100"] = round(
            sum(t["ev_$100"] for t in tickets), 2)
    return res


def print_round_robin_readable(res: Dict) -> None:
    where = (f"{res['team']} vs {res['opp']} (n={res['n']})"
             if "team" in res else " + ".join(res["games"]))
    sizes = "/".join(str(k) for k in res["by"])
    print(f"\n=== Round robin by {sizes}: {where} — "
          f"{res['n_tickets']} tickets ===")
    rows = sorted(res["tickets"],
                  key=lambda t: t.get("ev_$100", t["p_parlay"]),
                  reverse=True)
    for t in rows:
        legs = " + ".join(leg["label"] if isinstance(leg, dict) else leg
                          for leg in t["legs"])
        line = (f"  {legs:<52s} p {t['p_parlay']:.4f}  "
                f"fair {_odds_str(t['fair_american'])}")
        if "ev_$100" in t:
            line += f"  EV ${t['ev_$100']:+.2f}"
        print(line)
    print(f"  P(any ticket wins): {res['p_any_ticket_wins']:.4f}   "
          f"P(all tickets win): {res['p_all_tickets_win']:.4f}")
    if "ev_total_$100" in res:
        print(f"  Card at {_odds_str(res['price'])} per ticket: stake "
              f"${res['stake_$']}  total EV ${res['ev_total_$100']:+.2f}")


def print_parlay_readable(res: Dict) -> None:
    if "team" in res:
        print(f"\n=== Same-game parlay: {res['team']} vs {res['opp']} "
              f"(n={res['n']}) ===")
    else:
        print(f"\n=== Cross-game parlay: {' + '.join(res['games'])} ===")
    for leg in res["legs"]:
        tag = f" [{leg['game']}]" if "game" in leg else ""
        print(f"  {leg['label'] + tag:<40s} p_win {leg['p_win']:.4f}"
              + (f"  push {leg['p_push']:.4f}" if leg["p_push"] else ""))
    print(f"  P(all legs win):        {res['p_all_win']:.4f}")
    if res["p_win_reduced"] or res["p_void"]:
        print(f"  P(win reduced):         {res['p_win_reduced']:.4f}   "
              f"P(full void): {res['p_void']:.4f}")
    print(f"  Fair odds (joint):      {_odds_str(res['fair_american'])}"
          f"   (p={res['p_parlay']:.4f})")
    print(f"  If legs were indep.:    "
          f"{_odds_str(res['fair_american_independent'])}"
          f"   (p={res['p_independent']:.4f})")
    print(f"  Correlation multiplier: {res['correlation_mult']:.3f}x")
    if "price" in res:
        print(f"  At quoted {_odds_str(res['price'])}: edge "
              f"{res['edge_pct']:+.2f}%  EV ${res['ev_$100']:+.2f}/$100"
              f"  kelly {res['kelly']:.3f}")


def season_win_pmf(p_wins) -> np.ndarray:
    """Exact distribution of a team's season win COUNT from per-game win
    probabilities: the Poisson-binomial pmf, built by convolving each
    game's [1-p, p] kernel (distinct games are independent sims, so the
    composition is exact — the same independence fact cross_game_parlay
    rides).  Returns pmf[k] = P(exactly k wins), length len(p_wins)+1.

    p_wins should be strict win probabilities (the engine's win_rate
    excludes ties); any tie mass counts as a non-win, which is how win-
    total markets settle a no-contest.  No reference counterpart —
    edge_finder.py only ever prices one matchup's marginals."""
    pmf = np.array([1.0])
    for i, p in enumerate(np.asarray(list(p_wins), float)):
        if not 0.0 <= p <= 1.0 or not np.isfinite(p):
            raise ValueError(f"p_wins[{i}]={p!r} is not a probability")
        pmf = np.convolve(pmf, [1.0 - p, p])
    return pmf


def season_win_market(p_wins, line: Optional[float] = None,
                      team: str = "", price: int = -110) -> Dict:
    """Season win-total market off exact per-game win probabilities.

    Returns the full win distribution (pmf, mean/median wins, the
    P(wins >= k) ladder for every alternate line) plus — when `line` is
    quoted — over/under/push probabilities, fair American prices, and
    the best side's edge/EV at `price` (push-aware, integer lines push
    on exactly `line` wins).  The distribution rides the same Dist
    histogram core as every other market in this module."""
    p_wins = list(np.asarray(list(p_wins), float))
    pmf = season_win_pmf(p_wins)
    dist = Dist.from_hist(pmf, np.arange(len(pmf)))
    at_least = np.concatenate([[1.0], np.cumsum(pmf[::-1])[::-1][1:]])
    res: Dict = {
        "team": team,
        "games": len(p_wins),
        "p_wins": [round(float(p), 6) for p in p_wins],
        "mean_wins": round(dist.mean(), 4),
        "median_wins": dist.median(),
        "pmf": [round(float(p), 6) for p in pmf],
        "p_at_least": [round(float(p), 6) for p in at_least],
    }
    if line is not None:
        p_over, p_under = dist.over(line), dist.under(line)
        p_push = dist.push(line)
        res.update({
            "line": float(line),
            "p_over": round(p_over, 6),
            "p_under": round(p_under, 6),
            "push_rate": round(p_push, 6),
            "american_over": prob_to_american(p_over),
            "american_under": prob_to_american(p_under),
        })
        # push-AWARE best side (unlike the reference-parity best_side_ev,
        # which treats push mass as the other side winning): integer win
        # totals push on exactly `line` wins, refunding the stake, so a
        # side only loses when the OTHER side hits
        profit = (100.0 * 100.0 / -price) if price < 0 else float(price)
        ev_over = p_over * profit - p_under * 100.0
        ev_under = p_under * profit - p_over * 100.0
        side, p_side, ev = (("Over", p_over, ev_over)
                            if ev_over >= ev_under
                            else ("Under", p_under, ev_under))
        live = p_over + p_under
        res["best"] = {
            "side": side,
            "ev": round(ev, 2),
            # edge on the push-excluded conditional vs the price's
            # implied break-even (pushes count against neither side)
            "edge": (round(p_side / live - american_implied_prob(price), 6)
                     if live > 0 else 0.0),
            "kelly": round(kelly_fraction(p_side, price, p_push=p_push), 4),
        }
    return res


def print_season_readable(res: Dict) -> None:
    hdr = res["team"] or "team"
    print(f"\n=== Season win total: {hdr} ({res['games']} games) ===")
    print(f"  mean wins {res['mean_wins']:.2f}   "
          f"median {res['median_wins']:.0f}")
    lad = "  ".join(f"{k}+:{p:.3f}"
                    for k, p in enumerate(res["p_at_least"]) if k)
    print(f"  P(at least k wins): {lad}")
    if "line" in res:
        b = res["best"]
        print(f"  line {res['line']}: over {res['p_over']:.4f} "
              f"({_odds_str(res['american_over'])})  "
              f"under {res['p_under']:.4f} "
              f"({_odds_str(res['american_under'])})"
              + (f"  push {res['push_rate']:.4f}"
                 if res["push_rate"] else ""))
        print(f"  best side: {b['side']}  edge {b['edge'] * 100:+.2f}%  "
              f"EV ${b['ev']:+.2f}/$100  kelly {b['kelly']:.3f}")


# ---------------------------------------------------------------------------
# device-summary variants (on-device histogram -> edges without files)
# ---------------------------------------------------------------------------

def summary_margin_dist(summary) -> Dist:
    """The margin Dist of a parallel.aggregate.ScoreSummary (team == side
    0), read off its device-built integer-support histogram."""
    from .parallel.aggregate import MARGIN_OFF

    mh = np.asarray(summary.margin_hist, dtype=float)
    return Dist.from_hist(mh, np.arange(len(mh)) - MARGIN_OFF)


def summary_total_dist(summary) -> Dist:
    """The combined-points Dist of a ScoreSummary's total histogram."""
    th = np.asarray(summary.total_hist, dtype=float)
    return Dist.from_hist(th, np.arange(len(th)))


def market_odds_from_summary(summary, team: str, opp: str, *,
                             spread: Optional[float] = None,
                             total: Optional[float] = None,
                             calibration: Optional[MarketCalibration] = None,
                             ) -> Dict:
    """Same markets computed from a parallel.aggregate.ScoreSummary whose
    histograms were reduced on device (team == side 0).  Identical
    formatting path as game_market_odds — only the Dist representation
    differs (on-device histogram vs per-trial samples).  `calibration`
    applies the opt-in affine backtest correction (MarketCalibration)
    before pricing; the file-sample path can equivalently pre-shift its
    raw samples."""
    c = calibration or MarketCalibration()
    out: Dict = {}
    if spread is not None:
        out["spread"] = _spread_market(c.margin(summary_margin_dist(summary)),
                                       team, opp, spread)
    if total is not None:
        out["total"] = _total_market(c.total(summary_total_dist(summary)),
                                     team, opp, total)
    return out


def summary_moneyline(summary, team: str, opp: str,
                      calibration: Optional[MarketCalibration] = None,
                      ) -> Dict:
    """Fair moneylines off a device-reduced summary's margin histogram:
    each side is priced from P(its margin > 0), ties counting for neither
    side — the same per-perspective semantics as moneyline_from_sims (and
    the reference's _wins_from_scores, edge_finder.py:235-281).
    `calibration` applies the same margin correction the spread market
    uses, keeping the two mutually consistent."""
    margins = summary_margin_dist(summary)
    if calibration is not None:
        margins = calibration.margin(margins)
    p_team, p_opp = margins.over(0.0), margins.under(0.0)
    return {
        "team": {"name": team, "p_win": round(p_team, 6),
                 "ml_fair": prob_to_american(p_team)},
        "opp": {"name": opp, "p_win": round(p_opp, 6),
                "ml_fair": prob_to_american(p_opp)},
    }


# ---------------------------------------------------------------------------
# alternate-line ladders (no reference counterpart: edge_finder.py prices
# one quoted spread/total only, :283-336 — here the whole book ladder reads
# off the SAME Dist the main line uses, so the rows can never disagree)
# ---------------------------------------------------------------------------

def ladder_lines(center: float, width: float = 12.0,
                 step: float = 1.0) -> np.ndarray:
    """The alternate-line grid around a quoted line, inclusive of both
    ends and of the quoted line itself (so the main-market row is always
    present in a ladder built from it)."""
    if step <= 0:
        raise ValueError(f"ladder step must be positive, got {step}")
    k = int(round(float(width) / float(step)))
    return float(center) + float(step) * np.arange(-k, k + 1)


def alt_spread_table(margins: Dist, team: str, opp: str, spreads,
                     price: int = -110) -> pd.DataFrame:
    """One row per alternate spread (quoted from `team`'s perspective,
    cover iff margin > -spread as in _spread_market): cover/push
    probabilities, fair American prices for both sides, and the better
    side's edge/EV if every row were offered at `price`.  Books price alt
    lines at varying juice — the fair prices are the durable output; the
    `price` columns are the same constant-juice yardstick the reference
    applies to its single quoted line (edge_finder.py:109-119)."""
    rows = []
    for s in np.asarray(spreads, dtype=float):
        p_c, p_n, p_p = margins.over(-s), margins.under(-s), margins.push(-s)
        rec = best_side_ev(p_c, price=price)
        bet = f"{team} {s:+g}" if rec["side"] == "Over" else f"{opp} {-s:+g}"
        rows.append({
            "spread": float(s),
            "p_cover": round(p_c, 6), "p_notcover": round(p_n, 6),
            "push_rate": round(p_p, 6),
            "fair_cover": prob_to_american(p_c),
            "fair_notcover": prob_to_american(p_n),
            "bet": bet, "edge_pct": round(rec["edge"] * 100, 2),
            "ev_$100": round(rec["ev"], 2),
        })
    return pd.DataFrame(rows)


def alt_total_table(totals: Dist, lines, price: int = -110) -> pd.DataFrame:
    """One row per alternate total: over/under/push probabilities, fair
    prices, and the better side at `price` (same yardstick as
    alt_spread_table)."""
    rows = []
    for t in np.asarray(lines, dtype=float):
        p_o, p_u, p_p = totals.over(t), totals.under(t), totals.push(t)
        rec = best_side_ev(p_o, price=price)
        rows.append({
            "total": float(t),
            "p_over": round(p_o, 6), "p_under": round(p_u, 6),
            "push_rate": round(p_p, 6),
            "fair_over": prob_to_american(p_o),
            "fair_under": prob_to_american(p_u),
            "bet": f"{rec['side']} {t:g}",
            "edge_pct": round(rec["edge"] * 100, 2),
            "ev_$100": round(rec["ev"], 2),
        })
    return pd.DataFrame(rows)


def alt_prop_table(dist: Dist, lines, price: int = -110) -> pd.DataFrame:
    """One row per alternate prop line off a player's stat Dist:
    over/under/push probabilities, fair prices, and the better side at
    `price` (the same constant-juice yardstick as the game ladders)."""
    rows = []
    for ln in np.asarray(lines, dtype=float):
        p_o, p_u, p_p = dist.over(ln), dist.under(ln), dist.push(ln)
        rec = best_side_ev(p_o, price=price)
        rows.append({
            "line": float(ln),
            "p_over": round(p_o, 6), "p_under": round(p_u, 6),
            "push_rate": round(p_p, 6),
            "fair_over": prob_to_american(p_o),
            "fair_under": prob_to_american(p_u),
            "bet": f"{rec['side']} {ln:g}",
            "edge_pct": round(rec["edge"] * 100, 2),
            "ev_$100": round(rec["ev"], 2),
        })
    return pd.DataFrame(rows)


def _prop_ladder_grid(stat_col: str):
    """Default (width, step) for a prop ladder by stat family: yardage
    props move in 5s over a wide band; count stats (receptions, INTs,
    TDs) in halves over a narrow one."""
    if "yds" in stat_col or "yards" in stat_col:
        return 30.0, 5.0
    return 2.5, 0.5


def player_prop_ladder(csv_base: Optional[str], team: str, player: str,
                       stat: str, line: float, *,
                       role: Optional[str] = None, directory: str = ".",
                       players_df: Optional[pd.DataFrame] = None,
                       width: Optional[float] = None,
                       step: Optional[float] = None,
                       price: int = -110) -> pd.DataFrame:
    """Alternate-line ladder for one player prop, centered on the quoted
    line, off the SAME stat samples player_prop_odds prices — the prop
    twin of alt_lines_from_sims.  width/step default by stat family
    (yardage: ±30 by 5; count stats: ±2.5 by 0.5).  No reference
    counterpart: edge_finder.py prices one quoted prop line
    (:168-231)."""
    d, stat_col, role = _player_stat_dist(
        csv_base, team, player, stat, role=role, directory=directory,
        players_df=players_df)
    dflt_w, dflt_s = _prop_ladder_grid(stat_col)
    tbl = alt_prop_table(
        d, ladder_lines(line, dflt_w if width is None else width,
                        dflt_s if step is None else step), price=price)
    tbl.insert(0, "stat", stat_col)
    tbl.insert(0, "player", player)
    tbl.insert(0, "team", team)
    return tbl


def alt_lines_from_summary(summary, team: str, opp: str, *,
                           spread: Optional[float] = None,
                           total: Optional[float] = None,
                           width: float = 12.0, step: float = 1.0,
                           price: int = -110,
                           calibration: Optional[MarketCalibration] = None,
                           ) -> Dict[str, pd.DataFrame]:
    """Alternate spread/total ladders centered on the quoted lines, off a
    device-reduced ScoreSummary's histograms (team == side 0).  Zero extra
    simulation or device transfer — the ladders re-query the histograms
    the main markets already read.  `calibration` applies the same affine
    correction as market_odds_from_summary, so ladder rows can never
    disagree with a calibrated main line."""
    c = calibration or MarketCalibration()
    out: Dict[str, pd.DataFrame] = {}
    if spread is not None:
        out["spread"] = alt_spread_table(
            c.margin(summary_margin_dist(summary)), team, opp,
            ladder_lines(spread, width, step), price=price)
    if total is not None:
        out["total"] = alt_total_table(
            c.total(summary_total_dist(summary)),
            ladder_lines(total, width, step), price=price)
    return out


def alt_lines_from_sims(sims: pd.DataFrame, team: str, opp: str, *,
                        spread: Optional[float] = None,
                        total: Optional[float] = None,
                        width: float = 12.0, step: float = 1.0,
                        price: int = -110) -> Dict[str, pd.DataFrame]:
    """Alternate-line ladders from a saved/in-memory scores table (the
    file path's twin of alt_lines_from_summary)."""
    rows = _team_rows(sims, team, opp)
    if rows.empty:
        raise ValueError(
            f"scores data holds no rows from {team}'s perspective vs {opp}")
    out: Dict[str, pd.DataFrame] = {}
    if spread is not None:
        margins = Dist.from_values((rows["pts"] - rows["opp_pts"]).to_numpy())
        out["spread"] = alt_spread_table(
            margins, team, opp, ladder_lines(spread, width, step),
            price=price)
    if total is not None:
        totals = Dist.from_values((rows["pts"] + rows["opp_pts"]).to_numpy())
        out["total"] = alt_total_table(
            totals, ladder_lines(total, width, step), price=price)
    return out


def middle_odds(dist: Dist, low: float, high: float, *,
                price_low: int = -110, price_high: int = -110) -> Dict:
    """Price a MIDDLE: simultaneous "over `low`" and "under `high`"
    tickets on the same quantity (`low` < `high`), e.g. the favorite -3.5
    at one book and the dog +7.5 at another.  If the result lands inside
    the window both tickets win; outside it exactly one wins (so the
    worst case costs only the juice); a push at either line refunds that
    leg while the other wins.  The window probability reads off the SAME
    Dist that prices the main lines — consistency with the quoted
    markets is structural.  EV stakes $100 on each side.  No reference
    counterpart: edge_finder.py prices one line per market (:283-336), so
    it cannot ask a cross-line question."""
    low, high = float(low), float(high)
    if not low < high:
        raise ValueError(
            f"middle window is empty: need low < high, got [{low}, {high}]")
    p_push_low, p_push_high = dist.push(low), dist.push(high)
    p_mid = dist.over(low) - dist.over(high) - p_push_high
    p_over_only = dist.over(high)    # over the window: the low leg wins
    p_under_only = dist.under(low)   # under the window: the high leg wins

    def _profit(price: int) -> float:
        price = int(price)
        return 100 * (100 / (-price)) if price < 0 else float(price)

    w_lo, w_hi = _profit(price_low), _profit(price_high)
    ev = (p_mid * (w_lo + w_hi)
          + p_push_low * w_hi + p_push_high * w_lo
          + p_under_only * (w_hi - 100.0) + p_over_only * (w_lo - 100.0))
    return {
        "low": low, "high": high,
        "p_middle": round(p_mid, 6),
        "p_low_leg_only": round(p_over_only, 6),
        "p_high_leg_only": round(p_under_only, 6),
        "p_push_low": round(p_push_low, 6),
        "p_push_high": round(p_push_high, 6),
        "price_low": int(price_low), "price_high": int(price_high),
        "ev_$100_each": round(ev, 2),
    }


def spread_middle(margins: Dist, team: str, opp: str, line_team: float,
                  line_opp: float, *, price_team: int = -110,
                  price_opp: int = -110) -> Dict:
    """Middle two spread tickets quoted at different books: `team` at
    `line_team` (wins iff margin > -line_team) and `opp` at `line_opp`
    (wins iff margin < line_opp).  The classic shape is favorite -3.5 +
    dog +7.5: both cash on a 4-7 point win.  `margins` is the team-
    perspective margin Dist (the one the main spread market reads)."""
    res = middle_odds(margins, -float(line_team), float(line_opp),
                      price_low=price_team, price_high=price_opp)
    res["legs"] = [f"{team} {float(line_team):+g}",
                   f"{opp} {float(line_opp):+g}"]
    return res


def total_middle(totals: Dist, over_line: float, under_line: float, *,
                 price_over: int = -110, price_under: int = -110) -> Dict:
    """Middle an Over at `over_line` with an Under at `under_line`
    (over_line < under_line): both cash when the combined score lands
    inside the window."""
    res = middle_odds(totals, float(over_line), float(under_line),
                      price_low=price_over, price_high=price_under)
    res["legs"] = [f"Over {float(over_line):g}",
                   f"Under {float(under_line):g}"]
    return res


def middles_from_summary(summary, team: str, opp: str, *,
                         mid_spread=None, mid_total=None,
                         price: int = -110) -> Dict[str, Dict]:
    """Middles off a device-reduced ScoreSummary's histograms (team ==
    side 0).  `mid_spread` is (team_line, opp_line) — e.g. (-3.5, 7.5)
    holds team -3.5 and opp +7.5; `mid_total` is (over_line, under_line).
    Zero extra simulation: the windows re-query the histograms the main
    markets read."""
    out: Dict[str, Dict] = {}
    if mid_spread is not None:
        lt, lo = mid_spread
        out["spread"] = spread_middle(summary_margin_dist(summary), team,
                                      opp, lt, lo, price_team=price,
                                      price_opp=price)
    if mid_total is not None:
        ov, un = mid_total
        out["total"] = total_middle(summary_total_dist(summary), ov, un,
                                    price_over=price, price_under=price)
    return out


def middles_from_sims(sims: pd.DataFrame, team: str, opp: str, *,
                      mid_spread=None, mid_total=None,
                      price: int = -110) -> Dict[str, Dict]:
    """Middles from a saved/in-memory scores table (the file path's twin
    of middles_from_summary)."""
    rows = _team_rows(sims, team, opp)
    if rows.empty:
        raise ValueError(
            f"scores data holds no rows from {team}'s perspective vs {opp}")
    out: Dict[str, Dict] = {}
    if mid_spread is not None:
        lt, lo = mid_spread
        margins = Dist.from_values((rows["pts"] - rows["opp_pts"]).to_numpy())
        out["spread"] = spread_middle(margins, team, opp, lt, lo,
                                      price_team=price, price_opp=price)
    if mid_total is not None:
        ov, un = mid_total
        totals = Dist.from_values((rows["pts"] + rows["opp_pts"]).to_numpy())
        out["total"] = total_middle(totals, ov, un, price_over=price,
                                    price_under=price)
    return out


def print_middle_readable(res: Dict) -> None:
    legs = " / ".join(res.get("legs", [f"over {res['low']:g}",
                                       f"under {res['high']:g}"]))
    print(f"\n=== Middle: {legs} ===")
    print(f"  P(both win):  {res['p_middle']:.4f}   "
          f"window ({res['low']:g}, {res['high']:g})")
    print(f"  P(low leg only): {res['p_low_leg_only']:.4f}   "
          f"P(high leg only): {res['p_high_leg_only']:.4f}")
    if res["p_push_low"] or res["p_push_high"]:
        print(f"  push low/high: {res['p_push_low']:.4f} / "
              f"{res['p_push_high']:.4f}")
    print(f"  At {_odds_str(res['price_low'])} / "
          f"{_odds_str(res['price_high'])}, $100 each side: "
          f"EV ${res['ev_$100_each']:+.2f}")


def slate_market_table(games, summaries, lines: Optional[pd.DataFrame] = None,
                       price: int = -110) -> pd.DataFrame:
    """Price a whole slate's game markets in one pass: one row per matchup
    with fair moneylines and — where `lines` quotes them — spread/total
    probabilities, fair prices, and the best side's edge/EV at `price`.

    `summaries` are the per-matchup ScoreSummary objects returned by
    SlateRunner.run_summaries(return_summaries=True) or
    api.simulate_slate_summaries(return_summaries=True); every market here
    is a reduction over their device-built margin/total histograms, so a
    60-game slate prices with zero further simulation or device transfer.
    `lines` is a DataFrame with `spread` and/or `total` columns (spread
    quoted from team_a's perspective, reference convention), matched to
    matchups by a normalized `team_a` column when present, else by row
    position.

    The reference prices one matchup at a time from saved CSVs
    (edge_finder.py find_edges :586-614 over :283-336); this is that loop
    collapsed onto the slate's device summaries."""
    def _name(x):
        return getattr(x, "name", x)

    def _line_for(gi: int, ta: str):
        if lines is None:
            return None, None
        if "team_a" in lines.columns:
            sub = lines[lines["team_a"].astype(str).map(_norm_team)
                        == _norm_team(ta)]
            if sub.empty:
                return None, None
            r = sub.iloc[0]
        elif gi < len(lines):
            r = lines.iloc[gi]
        else:
            return None, None
        sp = r.get("spread")
        tt = r.get("total")
        return (float(sp) if pd.notna(sp) else None,
                float(tt) if pd.notna(tt) else None)

    rows = []
    for gi, ((a, b), s) in enumerate(zip(games, summaries)):
        ta, tb = _name(a), _name(b)
        sp, tt = _line_for(gi, ta)
        ml = summary_moneyline(s, ta, tb)
        row = {"team_a": ta, "team_b": tb, "n": int(np.asarray(s.n)),
               "p_win_a": ml["team"]["p_win"], "p_win_b": ml["opp"]["p_win"],
               "ml_fair_a": ml["team"]["ml_fair"],
               "ml_fair_b": ml["opp"]["ml_fair"]}
        mk = market_odds_from_summary(s, ta, tb, spread=sp, total=tt)
        if sp is not None:
            m = mk["spread"]
            rec = best_side_ev(m["p_cover"], price=price)
            row.update({
                "spread": sp,
                "p_cover_a": m["p_cover"],
                "fair_cover_a": m["american_cover"],
                "mean_margin_a": m["mean_margin"],
                "spread_bet": (f"{ta} {sp:+g}" if rec["side"] == "Over"
                               else f"{tb} {-sp:+g}"),
                "spread_edge_pct": round(rec["edge"] * 100, 2),
                "spread_ev_$100": round(rec["ev"], 2),
            })
        if tt is not None:
            t = mk["total"]
            rec = best_side_ev(t["p_over"], price=price)
            row.update({
                "total": tt,
                "p_over": t["p_over"],
                "fair_over": t["american_over"],
                "mean_total": t["mean_total"],
                "total_bet": f"{rec['side']} {tt:g}",
                "total_edge_pct": round(rec["edge"] * 100, 2),
                "total_ev_$100": round(rec["ev"], 2),
            })
        rows.append(row)
    return pd.DataFrame(rows)


# ---------------------------------------------------------------------------
# pretty printers (edge_finder.py:393-582)
# ---------------------------------------------------------------------------

def _odds_str(o: int) -> str:
    return f"{o:+d}"


def print_game_market_readable(res: dict) -> None:
    print("\n— Game Market —")
    be = breakeven_minus110()
    if "spread" in res:
        s = res["spread"]
        ev_cover = ev_per_100_at_minus110(s["p_cover"], s["push_rate"])
        ev_not = ev_per_100_at_minus110(s["p_notcover"], s["push_rate"])
        print(f"Spread: {s['team']} vs {s['opp']}  |  {s['team']} {s['spread']:+.1f}"
              f"  (samples {s['samples']})")
        print(f"  Cover:     {100*s['p_cover']:.1f}%  fair {_odds_str(s['american_cover'])}  "
              f"edge {(100*(s['p_cover']-be)):.2f}%  EV ${ev_cover:.2f}/$100")
        print(f"  Not cover: {100*s['p_notcover']:.1f}%  fair {_odds_str(s['american_notcover'])}  "
              f"edge {(100*(s['p_notcover']-be)):.2f}%  EV ${ev_not:.2f}/$100")
        print(f"  Push:      {100*s['push_rate']:.1f}%   | mean/median margin "
              f"{s['mean_margin']:.1f} / {s['median_margin']:.1f}")
    if "total" in res:
        t = res["total"]
        ev_over = ev_per_100_at_minus110(t["p_over"], t["push_rate"])
        ev_under = ev_per_100_at_minus110(t["p_under"], t["push_rate"])
        print(f"\nTotal: {t['team']} vs {t['opp']}  |  {t['total']:.1f}  (samples {t['samples']})")
        print(f"  Over:   {100*t['p_over']:.1f}%  fair {_odds_str(t['american_over'])}   "
              f"edge {(100*(t['p_over']-be)):.2f}%  EV ${ev_over:.2f}/$100")
        print(f"  Under:  {100*t['p_under']:.1f}% fair {_odds_str(t['american_under'])}  "
              f"edge {(100*(t['p_under']-be)):.2f}%  EV ${ev_under:.2f}/$100")
        print(f"  Push:   {100*t['push_rate']:.1f}%   | mean/median total "
              f"{t['mean_total']:.1f} / {t['median_total']:.1f}")
    if "spread" in res and "total" in res:
        _print_projected_scores(res)


def _print_projected_scores(res: dict) -> None:
    """Mean/median projected score from margin+total (edge_finder.py:421-447,
    with the sign handling generalized so a zero margin also prints)."""
    t = res["total"]
    s = res["spread"]
    for label, tv, sv in (("Mean", t["mean_total"], s["mean_margin"]),
                          ("Median", t["median_total"], s["median_margin"])):
        team_score = (tv + sv) / 2.0
        opp_score = (tv - sv) / 2.0
        print(f"\n{label} Score: {t['team']} - {team_score:.0f} vs "
              f"{t['opp']} - {opp_score:.0f}  |  (samples {t['samples']})")


def print_moneyline_readable(ml: dict) -> None:
    print("\n— Fair Moneyline (no vig) —")
    for k in ("team", "opp"):
        e = ml[k]
        print(f"  {e['name']}: {100*e['p_win']:.2f}%   fair {_odds_str(e['ml_fair'])}")


def print_prop_table(df: pd.DataFrame) -> None:
    if df is None or df.empty:
        print("\n— Player Props value (@ -110 both sides) —\n"
              "  (no props matched or no value found)")
        return
    out = df.copy()

    def group(stat: str) -> str:
        s = str(stat).lower()
        if s.startswith("pass"):
            return "Passing"
        if s.startswith("rush"):
            return "Rushing"
        if s.startswith("rec") or s in {"tgt", "receptions", "targets"}:
            return "Receiving"
        return "Other"

    out["__group__"] = out["stat"].map(group)
    out["__abs__"] = out["edge_pct"].abs()
    out = out.sort_values(["__group__", "__abs__"], ascending=[True, False])
    print("\n— Player Props value (@ -110 both sides) —")
    for gname in ("Passing", "Rushing", "Receiving", "Other"):
        g = out[out["__group__"] == gname]
        if g.empty:
            continue
        print(f"\n[{gname}]")
        for _, r in g.iterrows():
            print(f"{r['team']}: {r['player']}  |  {r['stat']} {r['best_side']} "
                  f"{r['line']:.1f}  (edge {r['edge_pct']:+.2f}%, "
                  f"EV ${r['ev_$100']:+.2f}/$100, mean {r['mean']:.1f}, "
                  f"med {r['median']:.1f}, n={int(r['samples'])})")


def print_slate_edges(df: pd.DataFrame) -> None:
    """Compact per-matchup view of slate_market_table, best edges first."""
    if df is None or df.empty:
        print("\n— Slate Market Edges —\n  (no matchups priced)")
        return
    out = df.copy()
    edge_cols = [c for c in ("spread_edge_pct", "total_edge_pct")
                 if c in out.columns]
    if edge_cols:
        out["__best__"] = out[edge_cols].abs().max(axis=1)
        out = out.sort_values("__best__", ascending=False)
    print("\n— Slate Market Edges (fair vs -110) —")
    for _, r in out.iterrows():
        print(f"\n{r['team_a']} vs {r['team_b']}  (n={int(r['n'])})")
        print(f"  ML fair: {r['team_a']} {_odds_str(int(r['ml_fair_a']))} "
              f"({100*r['p_win_a']:.1f}%)  |  {r['team_b']} "
              f"{_odds_str(int(r['ml_fair_b']))} ({100*r['p_win_b']:.1f}%)")
        if "spread" in out.columns and pd.notna(r.get("spread")):
            print(f"  Spread {r['team_a']} {r['spread']:+.1f}: cover "
                  f"{100*r['p_cover_a']:.1f}% fair "
                  f"{_odds_str(int(r['fair_cover_a']))}  ->  "
                  f"{r['spread_bet']}  edge {r['spread_edge_pct']:+.2f}%  "
                  f"EV ${r['spread_ev_$100']:+.2f}/$100")
        if "total" in out.columns and pd.notna(r.get("total")):
            print(f"  Total {r['total']:.1f}: over {100*r['p_over']:.1f}% "
                  f"fair {_odds_str(int(r['fair_over']))}  ->  "
                  f"{r['total_bet']}  edge {r['total_edge_pct']:+.2f}%  "
                  f"EV ${r['total_ev_$100']:+.2f}/$100")


def print_alt_lines(res: Dict[str, pd.DataFrame]) -> None:
    """Readable alternate-line ladders (alt_lines_from_summary/_sims)."""
    sp = res.get("spread")
    if sp is not None and not sp.empty:
        print("\n— Alternate Spreads —")
        print(f"  {'line':>7}  {'cover%':>7}  {'push%':>6}  "
              f"{'fair':>6}/{'fair-':<6}  best @ -110")
        for _, r in sp.iterrows():
            print(f"  {r['spread']:>+7.1f}  {100*r['p_cover']:>6.1f}%  "
                  f"{100*r['push_rate']:>5.1f}%  "
                  f"{_odds_str(int(r['fair_cover'])):>6}/"
                  f"{_odds_str(int(r['fair_notcover'])):<6}  "
                  f"{r['bet']}  {r['edge_pct']:+.2f}%  "
                  f"${r['ev_$100']:+.2f}/$100")
    tt = res.get("total")
    if tt is not None and not tt.empty:
        print("\n— Alternate Totals —")
        print(f"  {'line':>7}  {'over%':>7}  {'push%':>6}  "
              f"{'fair':>6}/{'fair-':<6}  best @ -110")
        for _, r in tt.iterrows():
            print(f"  {r['total']:>7.1f}  {100*r['p_over']:>6.1f}%  "
                  f"{100*r['push_rate']:>5.1f}%  "
                  f"{_odds_str(int(r['fair_over'])):>6}/"
                  f"{_odds_str(int(r['fair_under'])):<6}  "
                  f"{r['bet']}  {r['edge_pct']:+.2f}%  "
                  f"${r['ev_$100']:+.2f}/$100")


def find_edges(*, csv_base: Optional[str], team_a: str, team_b: str,
               spread: Optional[float], total: Optional[float],
               props_csv: Optional[str] = None, directory: str = ".",
               min_abs_edge_pct: float = 2.0) -> None:
    """One-call report: spread/total, fair moneylines, prop scan
    (edge_finder.py:586-614)."""
    if spread is not None or total is not None:
        gm = game_market_odds(csv_base, team_a, team_b, spread=spread,
                              total=total, directory=directory)
        print_game_market_readable(gm)
    # moneyline + props need no quoted line; a lines-less call (e.g.
    # `edges --props sheet.csv`, possibly alongside --mid-*) still reports
    ml = moneyline_from_sims(csv_base, team_a, team_b, directory=directory)
    print_moneyline_readable(ml)
    if props_csv and Path(props_csv).exists():
        props = scan_props_for_matchup(csv_base, team_a, team_b, props_csv,
                                       directory=directory,
                                       min_abs_edge_pct=min_abs_edge_pct)
        print_prop_table(props)
