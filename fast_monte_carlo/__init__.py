"""fast_monte_carlo — accelerator-native college-football Monte-Carlo simulator.

A ground-up JAX/XLA rebuild of cmpeavlerjr72/fast_monte_carlo: the per-play
game state machine is a masked lax.scan vectorized over trials, the XGBoost/
sklearn model heads compile to flattened node arrays (exact mode) or
per-matchup lookup tables (fast mode), trials shard over a device mesh, and
betting-market aggregation reduces on device.  See SURVEY.md for the
structural map of the reference and README.md for usage.
"""
from .config import SimConfig, DEFAULT_CONFIG, classic_config
from .api import (
    MatchupRunner, simulate_matchup, simulate_upcoming_matchup, simulate_slate,
    simulate_slate_summaries, simulate_live_game, simulate_live_curve,
    evaluate_fourth_down, simulate_parlay, project_season,
    scores_frame, players_frame,
    summary_frame, csv_base_from,
)
from .ops.game import Situation
from .data import (
    TeamContext, load_sp_flex, lookup_sp_flex, build_team_context,
    build_team_context_from_sp_flex,
)
from .models.heads import ModelHeads, load_heads
from .oracle import OracleMatchup
from .store import make_signature, save_sim_bundle, load_sim_bundle

__version__ = "0.1.0"
__all__ = [
    "SimConfig", "DEFAULT_CONFIG", "classic_config",
    "MatchupRunner", "simulate_matchup", "simulate_upcoming_matchup",
    "simulate_slate", "simulate_slate_summaries", "simulate_live_game",
    "simulate_live_curve", "evaluate_fourth_down", "simulate_parlay",
    "project_season",
    "Situation",
    "scores_frame", "players_frame", "summary_frame",
    "csv_base_from",
    "TeamContext", "load_sp_flex", "lookup_sp_flex", "build_team_context",
    "build_team_context_from_sp_flex",
    "ModelHeads", "load_heads", "OracleMatchup",
    "make_signature", "save_sim_bundle", "load_sim_bundle",
]
