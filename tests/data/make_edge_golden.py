"""Generate tests/data/edge_golden.json from the CURRENT edge.py.

Run once before any edge.py refactor; tests/test_edge_golden.py then pins
every market-function output bit-for-bit so internal rewrites (the round-3
de-copy of the file-based market path) cannot change observable behavior.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pandas as pd

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from fast_monte_carlo import edge as E  # noqa: E402


def synth_frames():
    rng = np.random.default_rng(42)
    n = 4000
    pts = rng.poisson(28, n)
    opp = rng.poisson(24, n)
    sims = pd.DataFrame({
        "team": ["Alpha"] * (n // 2) + ["Beta"] * (n // 2),
        "opp": ["Beta"] * (n // 2) + ["Alpha"] * (n // 2),
        "pts": pts, "opp_pts": opp,
    })
    rows = []
    for sim in range(400):
        rows.append({"sim": sim, "start": "A", "team": "Alpha", "opp": "Beta",
                     "player": "QB One", "role": "QB",
                     "pass_att": int(rng.integers(20, 45)),
                     "pass_comp": int(rng.integers(10, 30)),
                     "pass_yds": round(float(rng.normal(250, 60)), 1),
                     "pass_td": int(rng.integers(0, 5)),
                     "INT": int(rng.integers(0, 3)),
                     "sacks": int(rng.integers(0, 4)),
                     "rush_att": 0, "rush_yds": 0, "rush_td": 0,
                     "tgt": 0, "rec": 0, "rec_yds": 0, "rec_td": 0})
        rows.append({"sim": sim, "start": "A", "team": "Alpha", "opp": "Beta",
                     "player": "RB One", "role": "Rusher",
                     "pass_att": 0, "pass_comp": 0, "pass_yds": 0,
                     "pass_td": 0, "INT": 0, "sacks": 0,
                     "rush_att": int(rng.integers(8, 28)),
                     "rush_yds": round(float(rng.normal(85, 30)), 1),
                     "rush_td": int(rng.integers(0, 3)),
                     "tgt": 0, "rec": 0, "rec_yds": 0, "rec_td": 0})
    players = pd.DataFrame(rows)
    return sims, players


def main():
    sims, players = synth_frames()
    players = players.assign(team_low=players.team.str.lower(),
                             player_low=players.player.str.lower())
    golden = {
        "game_market": E.game_market_odds(
            None, "Alpha", "Beta", spread=-3.5, total=51.5, sims=sims),
        "game_market_int_lines": E.game_market_odds(
            None, "Alpha", "Beta", spread=-3.0, total=52.0, sims=sims),
        "moneyline": E.moneyline_from_sims(None, "Alpha", "Beta", sims=sims),
        "prop_qb": E.player_prop_odds(
            None, "Alpha", "QB One", "pass_yards", 250.5, players_df=players),
        "prop_rb": E.player_prop_odds(
            None, "Alpha", "RB One", "rush_yards", 80.0, players_df=players),
        "odds": {
            "prob_to_american": [E.prob_to_american(p) for p in
                                 (0.01, 0.25, 0.5, 0.5238, 0.75, 0.99)],
            "ev_per_100": [E.ev_per_100(0.55, -110), E.ev_per_100(0.45, 120)],
            "ev_minus110": [E.ev_per_100_at_minus110(0.55, 0.02)],
            "implied": [E.american_implied_prob(-110),
                        E.american_implied_prob(150)],
            "best_side": [E.best_side_ev(0.58), E.best_side_ev(0.40)],
        },
    }
    out = Path(__file__).parent / "edge_golden.json"
    out.write_text(json.dumps(golden, indent=1, sort_keys=True))
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
