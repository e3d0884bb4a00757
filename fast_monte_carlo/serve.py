"""Long-lived HTTP serving layer over the slate/matchup/prop APIs.

The reference's production loop is batch-shaped: every question spawns a
fresh process that reloads all twelve model artifacts, rebuilds contexts,
simulates, and writes CSVs for a second process to price
(`fast_monte_carlo_cfb.py:1661-1722` ``simulate_upcoming_matchup``;
`edge_finder.py:586-614` ``find_edges`` over the saved files).  On an
accelerator the economics invert: compiles and uploads are expensive once
and free thereafter, so the right production shape is ONE resident process
whose forests stay packed, whose nano tables stay device-resident, and
whose compiled launch programs stay cached.  This module is that resident
process with a JSON/HTTP front (``artifact_dir``/``sp_path`` take
``seeded:<int>`` for the seeded artifact set):

    POST /slate   {"games": [["Team 030","Team 041"], ...],
                   "n_pairs": 32768, "shard": false,
                   "lines": [{"team_a": "Team 030", "spread": -3.5,
                              "total": 55.5}]}
    POST /sim     {"team_a": "...", "team_b": "...", "n_pairs": 32768,
                   "spread": -3.5, "total": 55.5}
    POST /props   {"games": [...], "props": [{prop-sheet rows}], ...}
    POST /live    {"team_a": "...", "team_b": "...", "offense": "A",
                   "quarter": 4, "clock": "05:12", "down": 2, "dist": 7,
                   "ytg": 35, "score_a": 21, "score_b": 17,
                   "spread": -3.5, "total": 55.5}
                  (or "situations": [{...}, ...] — a win-prob curve,
                   every situation priced in ONE launch)
    POST /fourth  {"team_a": "...", "team_b": "...", "offense": "A",
                   "quarter": 4, "clock": "05:00", "dist": 2, "ytg": 30,
                   "score_a": 20, "score_b": 21}
    POST /season  {"team": "...", "opponents": ["...", ...],
                   "line": 8.5, "n_pairs": 32768}
    GET  /health  liveness + device/cache state

Everything stdlib: ``http.server.ThreadingHTTPServer`` accepts requests
concurrently while a single service lock serializes device work (one
device — concurrent launches would interleave dispatch and serialize
anyway; the lock keeps the host-side memo caches and timing honest).  Responses are plain JSON: numpy scalars are unwrapped and NaN
becomes null.
"""
from __future__ import annotations

import json
import math
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import pandas as pd


def jsonable(o):
    """Recursively convert API outputs (frames, numpy scalars, NaN) into
    JSON-encodable structures."""
    if isinstance(o, pd.DataFrame):
        return [jsonable(r) for r in o.to_dict(orient="records")]
    if isinstance(o, dict):
        return {str(k): jsonable(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [jsonable(v) for v in o]
    if isinstance(o, np.generic):
        o = o.item()
    if isinstance(o, float) and not math.isfinite(o):
        return None
    return o


class Overloaded(RuntimeError):
    """Request shed by the admission deadline (mapped to HTTP 503)."""


class _BatchItem:
    """One matchup's slot in a coalesced /sim batch."""
    __slots__ = ("evt", "out", "err", "waiters")

    def __init__(self):
        self.evt = threading.Event()
        self.out = None      # (summary_row_dict, ScoreSummary)
        self.err = None
        self.waiters = 0     # requests registered on this slot (observability)


class _SimBatch:
    """Open /sim batch for one (n_pairs, mode, shard, seed) group: requests
    arriving while the device lock is busy register their matchup here; the
    group's first arrival (the leader) seals the batch when it ACQUIRES the
    lock and answers every matchup with ONE slate launch."""
    __slots__ = ("items",)

    def __init__(self):
        self.items: dict = {}   # (team_a, team_b) -> _BatchItem


@dataclass(frozen=True)
class ServeConfig:
    """Static per-process serving configuration (the request body carries
    only per-question knobs: games, trial counts, lines, prop rows)."""
    sp_path: str
    artifact_dir: str = "seeded:0"
    year: int = 2025
    week: int = 1
    mode: str = "table"
    table_quality: str = "nano"
    focus_csv: Optional[str] = None
    shard: bool = False          # default; request "shard" overrides
    max_n_pairs: int = 2_000_000  # per-request guard
    max_games: int = 80          # per-request slate bound (weekly ~60)
    # per-request admission deadline: a request that spends longer than
    # this QUEUED behind the device lock is shed with 503 before any
    # device work launches (a launched program can't be aborted, so the
    # guard bounds queue wait, not the running sim).  None or <=0 =
    # never shed.
    deadline_s: Optional[float] = None
    # AOT executable snapshot dir (utils.aot): when set, the sim/live/
    # moments/readback-packer programs load pre-compiled executables from
    # here on first use and snapshot on first compile — a fresh process
    # answers its first /sim with zero compiles once the dir is warm.
    # The dir is a per-deployment artifact: topology/jax-version
    # mismatches fall back to compiling, but WIPE IT on library upgrades
    # (callee-body changes are invisible to the snapshot fingerprint).
    aot_dir: Optional[str] = None


class SimService:
    """The resident simulation service: owns the warm state (heads memo,
    device tables, compiled programs all hydrate on first use and stay)
    and serializes device work behind one lock."""

    def __init__(self, cfg: ServeConfig):
        import collections

        self.cfg = cfg
        if cfg.aot_dir:
            from .utils.aot import set_aot_dir
            set_aot_dir(cfg.aot_dir)
            # zero-compile intent: persist even sub-second programs
            # (eager PRNG ops, shape utilities) to the persistent
            # compilation cache as well
            import jax
            jax.config.update(
                "jax_persistent_cache_min_compile_time_secs", 0.0)
        self._lock = threading.Lock()
        self._t0 = time.time()
        self._requests = 0
        # per-endpoint completed-request latency rings (seconds, includes
        # queue wait); /health reports p50/p95 off them.  A dedicated
        # small lock guards ring append vs /health iteration — /health
        # must never 500 with 'deque mutated during iteration' under the
        # very load it exists to observe
        self._latency = collections.defaultdict(
            lambda: collections.deque(maxlen=512))
        self._lat_lock = threading.Lock()
        # /sim request coalescing (VERDICT r4 #4): open batches by group
        self._batch_lock = threading.Lock()
        self._sim_batches: dict = {}
        self._coalesced = 0   # requests answered from a shared launch
        # generic single-flight for the OTHER deterministic endpoints:
        # identical concurrent bodies share one computation
        self._inflight: dict = {}

    @contextmanager
    def _admit(self, endpoint: str, t0: float):
        """Device-lock admission with the deadline guard; records the
        endpoint's end-to-end latency on success."""
        dl = self.cfg.deadline_s
        if dl is not None and dl <= 0:
            dl = None   # 0/negative means 'no deadline', not 'shed all'
        if dl is None:
            acquired = self._lock.acquire()
        else:
            left = dl - (time.perf_counter() - t0)
            acquired = left > 0 and self._lock.acquire(timeout=left)
        if not acquired:
            raise Overloaded(
                f"queue wait exceeded deadline_s={dl}; retry later")
        try:
            self._requests += 1
            yield
        finally:
            self._lock.release()
        with self._lat_lock:
            self._latency[endpoint].append(time.perf_counter() - t0)

    def _single_flight(self, endpoint: str, body: dict, compute):
        """Share one computation across concurrent IDENTICAL requests.

        Every served endpoint is deterministic in its body (fixed seeds,
        committed artifacts), so two identical in-flight requests must
        return identical answers — the second can wait for the first's
        launch instead of queuing its own (the /live and /fourth polling
        patterns hit this constantly).  Leader computes under its own
        `_admit`; followers wait bounded by the admission deadline and
        get a shallow copy of the response (each request stamps its own
        elapsed_s).  Any leader failure propagates to all waiters.
        /sim has the richer cross-matchup batcher instead."""
        key = (endpoint, json.dumps(body, sort_keys=True, default=str))
        t0 = time.perf_counter()
        with self._batch_lock:
            item = self._inflight.get(key)
            leader = item is None
            if leader:
                item = self._inflight[key] = _BatchItem()
            item.waiters += 1
        if leader:
            try:
                item.out = compute()
            except BaseException as e:
                item.err = e
                raise
            finally:
                with self._batch_lock:
                    if self._inflight.get(key) is item:
                        del self._inflight[key]
                item.evt.set()
        else:
            self._await_batch_item(item, t0, endpoint=endpoint)
            if item.err is not None:
                raise item.err
        out = dict(item.out)
        out["elapsed_s"] = round(time.perf_counter() - t0, 3)
        return out

    # -- warmup ---------------------------------------------------------
    def warm(self, games=None, n_pairs: int = 256) -> dict:
        """Optional pre-hydration: load heads + SP table now (and, given
        `games`, run a tiny slate so table builds/uploads and the launch
        program compile before the first real request)."""
        from .data import load_sp_flex
        from .models.heads import load_heads

        with self._lock:
            load_heads(self.cfg.artifact_dir)
            load_sp_flex(self.cfg.sp_path)
        out = {"heads": "loaded", "sp": "loaded"}
        if games:
            self.slate({"games": games, "n_pairs": n_pairs})
            out["compiled"] = f"{len(games)} matchups @ {n_pairs} pairs"
        return out

    # -- endpoints ------------------------------------------------------
    def handle(self, name: str, body: dict) -> dict:
        """Route one POST: /sim goes to its cross-matchup batcher; every
        other endpoint gets identical-request single-flight (both are
        exact: all endpoints are deterministic in their body)."""
        if name == "sim":
            return self.sim(body)
        return self._single_flight(name, body,
                                   lambda: getattr(self, name)(body))

    def health(self) -> dict:
        import jax

        from .models.heads import _HEADS_MEMO
        from .ops.table_lookup import _DEVICE_TABLE_CACHE

        with self._lat_lock:
            rings = {ep: list(ring) for ep, ring in self._latency.items()}
        lat = {}
        for ep, ring in rings.items():
            if not ring:
                continue
            a = np.sort(np.asarray(ring))
            lat[ep] = {
                "n": len(a),
                "p50_ms": round(float(np.percentile(a, 50)) * 1e3, 1),
                "p95_ms": round(float(np.percentile(a, 95)) * 1e3, 1),
                "max_ms": round(float(a[-1]) * 1e3, 1),
            }
        return {
            "status": "ok",
            "platform": jax.devices()[0].platform,
            "device_count": jax.device_count(),
            "uptime_s": round(time.time() - self._t0, 1),
            "requests": self._requests,
            "coalesced": self._coalesced,
            "heads_memo": len(_HEADS_MEMO),
            "device_tables": len(_DEVICE_TABLE_CACHE),
            "latency": lat,
            "config": jsonable(self.cfg.__dict__),
        }

    def _n_pairs(self, body: dict, default: int) -> int:
        n = int(body.get("n_pairs", default))
        if not 0 < n <= self.cfg.max_n_pairs:
            raise ValueError(
                f"n_pairs must be in (0, {self.cfg.max_n_pairs}], got {n}")
        return n

    def _mode(self, body: dict) -> str:
        """Per-request mode override, bounded: only the configured mode or
        the cheap artifact-free 'analytic' — a request posting
        mode='exact' (a forest walk per play, far slower per game than a
        table gather) would hold the service lock for a long time,
        defeating the n_pairs cost guard."""
        mode = body.get("mode", self.cfg.mode)
        if mode not in (self.cfg.mode, "analytic"):
            raise ValueError(
                f"mode {mode!r} not served (this process runs "
                f"{self.cfg.mode!r}; 'analytic' also allowed)")
        return mode

    def _games(self, body: dict) -> list:
        games = [tuple(g) for g in body["games"]]
        if not 0 < len(games) <= self.cfg.max_games:
            raise ValueError(
                f"games list must have 1..{self.cfg.max_games} matchups, "
                f"got {len(games)} (each matchup builds device tables; "
                "raise ServeConfig.max_games deliberately if needed)")
        return games

    def slate(self, body: dict) -> dict:
        """Slate summaries (+ market pricing when `lines` rows are given):
        the per-matchup launch loop with one end transfer."""
        from .api import simulate_slate_summaries
        from .edge import slate_market_table

        games = self._games(body)
        lines = body.get("lines")
        t0 = time.perf_counter()
        with self._admit("slate", t0):
            df, summaries = simulate_slate_summaries(
                games, sp_path=self.cfg.sp_path, year=self.cfg.year,
                week=self.cfg.week, n_pairs=self._n_pairs(body, 32768),
                artifact_dir=self.cfg.artifact_dir,
                focus_csv=self.cfg.focus_csv, mode=self._mode(body),
                table_quality=self.cfg.table_quality,
                shard=bool(body.get("shard", self.cfg.shard)),
                seed=int(body.get("seed", 0)), return_summaries=True)
            out = {"summaries": jsonable(df)}
            if lines:
                mt = slate_market_table(games, summaries,
                                        pd.DataFrame(lines))
                out["markets"] = jsonable(mt)
        out["elapsed_s"] = round(time.perf_counter() - t0, 3)
        return out

    def sim(self, body: dict) -> dict:
        """One matchup: summary + fair moneyline, plus spread/total
        markets when quoted.

        Requests COALESCE (VERDICT r4 #4): while the device lock is busy,
        /sim arrivals for the same (n_pairs, mode, shard, seed) group
        register their matchup in an open batch; the group's first
        arrival (the leader) seals the batch when it acquires the lock
        and answers every queued matchup with ONE slate launch.
        Identical requests share one launch outright (the sim is
        deterministic in the group key, so shared answers are exactly
        what sequential calls would have returned); distinct matchups
        queue-batch into the slate path.  Market/alt pricing stays
        per-request (host-side, off the shared summary)."""
        from .edge import market_odds_from_summary, summary_moneyline

        ta, tb = body["team_a"], body["team_b"]
        t0 = time.perf_counter()
        n_pairs = self._n_pairs(body, 32768)
        mode = self._mode(body)
        shard = bool(body.get("shard", self.cfg.shard))
        seed = int(body.get("seed", 0))
        # parse per-request knobs BEFORE joining a batch: a malformed
        # body must 400 without costing a device launch
        calib = _calibration_from_body(body)
        group = (n_pairs, mode, shard, seed)
        with self._batch_lock:
            batch = self._sim_batches.get(group)
            leader = batch is None
            if leader:
                batch = _SimBatch()
                self._sim_batches[group] = batch
            item = batch.items.get((ta, tb))
            if item is None:
                item = batch.items[(ta, tb)] = _BatchItem()
            item.waiters += 1
        if leader:
            self._run_sim_batch(group, batch, n_pairs, mode, shard, seed, t0)
        else:
            self._await_batch_item(item, t0)
        if item.err is not None:
            raise item.err
        row, summary = item.out
        out = {
            "summary": row,
            "moneyline": jsonable(summary_moneyline(summary, ta, tb,
                                                    calibration=calib)),
        }
        spread, total = body.get("spread"), body.get("total")
        if spread is not None or total is not None:
            out["markets"] = jsonable(market_odds_from_summary(
                summary, ta, tb,
                spread=None if spread is None else float(spread),
                total=None if total is None else float(total),
                calibration=calib))
            alt = body.get("alt")
            if alt:
                from .edge import alt_lines_from_summary
                opts = alt if isinstance(alt, dict) else {}
                width = float(opts.get("width", 12.0))
                step = float(opts.get("step", 1.0))
                if not (step > 0 and width / step <= 100):
                    raise ValueError(
                        "alt ladder capped at 201 rows: need step > 0 "
                        "and width/step <= 100")
                out["alt"] = {
                    k: jsonable(v) for k, v in alt_lines_from_summary(
                        summary, ta, tb,
                        spread=None if spread is None else float(spread),
                        total=None if total is None else float(total),
                        width=width, step=step,
                        calibration=calib).items()}
        out["elapsed_s"] = round(time.perf_counter() - t0, 3)
        return out

    def _run_sim_batch(self, group, batch: _SimBatch, n_pairs, mode, shard,
                       seed, t0) -> None:
        """Leader path: acquire the device lock, seal the batch, run one
        slate launch for every queued matchup, distribute results.  Any
        failure (including an admission shed) fails the whole batch —
        followers re-raise the same exception."""
        from .api import simulate_slate_summaries

        def run(subset):
            df, summaries = simulate_slate_summaries(
                subset, sp_path=self.cfg.sp_path, year=self.cfg.year,
                week=self.cfg.week, n_pairs=n_pairs,
                artifact_dir=self.cfg.artifact_dir,
                focus_csv=self.cfg.focus_csv, mode=mode,
                table_quality=self.cfg.table_quality,
                shard=shard, seed=seed, return_summaries=True)
            return list(zip(jsonable(df), summaries))

        try:
            with self._admit("sim", t0):
                with self._batch_lock:
                    # seal: arrivals from here on open the NEXT batch
                    if self._sim_batches.get(group) is batch:
                        del self._sim_batches[group]
                    games = list(batch.items.keys())
                try:
                    per = dict(zip(games, run(games)))
                except Exception:
                    if len(games) == 1:
                        raise
                    # one bad matchup must not fail its batch-mates: fall
                    # back to per-matchup launches (old /sim semantics —
                    # each request sees only its own error)
                    per = {}
                    for g in games:
                        try:
                            per[g] = run([g])[0]
                        except Exception as ge:  # noqa: BLE001
                            batch.items[g].err = ge
            for g, it in batch.items.items():
                if g in per:
                    it.out = per[g]
                it.evt.set()
        except BaseException as e:
            with self._batch_lock:
                if self._sim_batches.get(group) is batch:
                    del self._sim_batches[group]
            for it in batch.items.values():
                if not it.evt.is_set():
                    it.err = e
                    it.evt.set()
            raise

    def _await_batch_item(self, item: _BatchItem, t0,
                          endpoint: str = "sim") -> None:
        """Follower path: wait for the leader's launch (bounded by the
        admission deadline) and record this request's own latency."""
        dl = self.cfg.deadline_s
        if dl is not None and dl <= 0:
            dl = None
        timeout = None if dl is None else max(0.0, dl - (time.perf_counter() - t0))
        if not item.evt.wait(timeout):
            raise Overloaded(
                f"queue wait exceeded deadline_s={dl}; retry later")
        if item.err is None:    # the ring records completed requests only
            with self._lat_lock:
                self._coalesced += 1
                self._latency[endpoint].append(time.perf_counter() - t0)

    def live(self, body: dict) -> dict:
        """In-game win probability + live market pricing: resume trials
        from the posted situation (possession/clock/down/distance/field
        position/score).  The situation is a runtime input to one cached
        compiled program — repeat live states answer at warm /sim latency.

            POST /live {"team_a": "...", "team_b": "...",
                        "offense": "A", "sec": 1312, "down": 2,
                        "dist": 7, "ytg": 35, "score_a": 21, "score_b": 17,
                        "n_games": 65536, "spread": -3.5, "total": 55.5}

        `offense` accepts "A"/"B" or 0/1; `quarter` + `clock` ("MM:SS")
        may replace `sec`.

        Batch form (win-probability curve): pass `situations` — a list of
        situation objects with the same fields — instead of inline fields;
        all of them price in ONE launch (api.simulate_live_curve) and the
        response carries one headline row per situation."""
        from .api import simulate_live_game
        from .edge import market_odds_from_summary, summary_moneyline

        ta, tb = body["team_a"], body["team_b"]
        if "situations" in body:
            return self._live_curve(ta, tb, body)
        sit = _situation_from_body(body)
        n_games = int(body.get("n_games", 65536))
        if not 0 < n_games <= 2 * self.cfg.max_n_pairs:
            raise ValueError(
                f"n_games must be in (0, {2 * self.cfg.max_n_pairs}], "
                f"got {n_games}")
        t0 = time.perf_counter()
        with self._admit("live", t0):
            row, summary = simulate_live_game(
                ta, tb, sit, sp_path=self.cfg.sp_path, year=self.cfg.year,
                week=self.cfg.week, n_games=n_games,
                artifact_dir=self.cfg.artifact_dir,
                focus_csv=self.cfg.focus_csv, mode=self._mode(body),
                table_quality=self.cfg.table_quality,
                shard=bool(body.get("shard", self.cfg.shard)),
                seed=int(body.get("seed", 0)))
            out = {
                "live": jsonable(row),
                "moneyline": jsonable(summary_moneyline(summary, ta, tb)),
            }
            spread, total = body.get("spread"), body.get("total")
            if spread is not None or total is not None:
                out["markets"] = jsonable(market_odds_from_summary(
                    summary, ta, tb,
                    spread=None if spread is None else float(spread),
                    total=None if total is None else float(total)))
        out["elapsed_s"] = round(time.perf_counter() - t0, 3)
        return out

    def _live_curve(self, ta: str, tb: str, body: dict) -> dict:
        """Batch form of /live: S situations in one launch."""
        from .api import simulate_live_curve

        raw = body["situations"]
        if not isinstance(raw, list) or not 0 < len(raw) <= 64:
            raise ValueError(
                "situations must be a JSON array of 1..64 objects")
        sits = [_situation_from_body(d) for d in raw]
        n_per = int(body.get("n_games_per", 8192))
        if not 0 < n_per * len(sits) <= 2 * self.cfg.max_n_pairs:
            raise ValueError(
                f"situations * n_games_per must be in "
                f"(0, {2 * self.cfg.max_n_pairs}], "
                f"got {len(sits)} * {n_per}")
        t0 = time.perf_counter()
        with self._admit("live_curve", t0):
            df, _ = simulate_live_curve(
                ta, tb, sits, sp_path=self.cfg.sp_path, year=self.cfg.year,
                week=self.cfg.week, n_games_per=n_per,
                artifact_dir=self.cfg.artifact_dir,
                focus_csv=self.cfg.focus_csv, mode=self._mode(body),
                table_quality=self.cfg.table_quality,
                seed=int(body.get("seed", 0)))
        return {"curve": jsonable(df),
                "elapsed_s": round(time.perf_counter() - t0, 3)}

    def fourth(self, body: dict) -> dict:
        """4th-down decision chart from a posted situation.

            POST /fourth {"team_a": "...", "team_b": "...",
                          "offense": "A", "quarter": 4, "clock": "05:00",
                          "dist": 2, "ytg": 30, "score_a": 20,
                          "score_b": 21, "n_games": 65536}

        The situation's down is 4 by construction; the response carries
        win probability per forced choice (go/fg/punt) next to the sampled
        policy, plus the best choice and its CRN-paired delta
        (api.evaluate_fourth_down)."""
        from .api import evaluate_fourth_down

        if int(body.get("down", 4)) != 4:
            raise ValueError("/fourth prices 4th downs (down must be 4)")
        sit = _situation_from_body({**body, "down": 4})
        n_games = int(body.get("n_games", 65536))
        # 4 choices run per request — bound each like a /live query
        if not 0 < n_games <= 2 * self.cfg.max_n_pairs:
            raise ValueError(
                f"n_games must be in (0, {2 * self.cfg.max_n_pairs}], "
                f"got {n_games}")
        t0 = time.perf_counter()
        with self._admit("fourth", t0):
            res = evaluate_fourth_down(
                body["team_a"], body["team_b"], sit,
                sp_path=self.cfg.sp_path, year=self.cfg.year,
                week=self.cfg.week, n_games=n_games,
                artifact_dir=self.cfg.artifact_dir,
                focus_csv=self.cfg.focus_csv, mode=self._mode(body),
                table_quality=self.cfg.table_quality,
                seed=int(body.get("seed", 0)))
        return {"fourth": jsonable(res),
                "elapsed_s": round(time.perf_counter() - t0, 3)}

    def season(self, body: dict) -> dict:
        """Season win-total projection: the schedule's per-game sims
        compose into the exact Poisson-binomial win-count distribution
        (api.project_season).

            POST /season {"team": "...",
                          "opponents": ["...", ...],   # or "games": [[a,b],..]
                          "line": 8.5, "n_pairs": 32768}

        Returns the pmf, the P(>=k) alternate-line ladder, the over/under
        market at `line`, and the per-game schedule rows."""
        from .api import project_season

        team = body["team"]
        opponents = body.get("opponents")
        games = body.get("games")
        if games is not None:
            games = self._games(body)
        if opponents is not None \
                and not 0 < len(opponents) <= self.cfg.max_games:
            raise ValueError(
                f"opponents list must have 1..{self.cfg.max_games} "
                f"entries, got {len(opponents)}")
        line = body.get("line")
        t0 = time.perf_counter()
        with self._admit("season", t0):
            res = project_season(
                team, opponents=opponents, games=games,
                line=None if line is None else float(line),
                sp_path=self.cfg.sp_path, year=self.cfg.year,
                week=self.cfg.week, n_pairs=self._n_pairs(body, 32768),
                artifact_dir=self.cfg.artifact_dir,
                focus_csv=self.cfg.focus_csv, mode=self._mode(body),
                table_quality=self.cfg.table_quality,
                shard=bool(body.get("shard", self.cfg.shard)),
                seed=int(body.get("seed", 0)))
        return {"season": jsonable(res),
                "elapsed_s": round(time.perf_counter() - t0, 3)}

    def props(self, body: dict) -> dict:
        """Slate-wide prop scan over inline prop rows (the prop-sheet CSV
        schema as JSON records)."""
        from .api import simulate_slate_props

        games = self._games(body)
        t0 = time.perf_counter()
        with self._admit("props", t0):
            df = simulate_slate_props(
                games, sp_path=self.cfg.sp_path,
                props_csv=pd.DataFrame(body["props"]),
                year=self.cfg.year, week=self.cfg.week,
                n_pairs=self._n_pairs(body, 8192),
                artifact_dir=self.cfg.artifact_dir,
                focus_csv=self.cfg.focus_csv, mode=self._mode(body),
                table_quality=self.cfg.table_quality,
                min_abs_edge_pct=float(body.get("min_abs_edge_pct", 0.0)),
                shard=bool(body.get("shard", self.cfg.shard)),
                seed=int(body.get("seed", 0)))
        return {"props": jsonable(df),
                "elapsed_s": round(time.perf_counter() - t0, 3)}


    def parlay(self, body: dict) -> dict:
        """Same-game parlay pricing off the joint per-trial distribution.

            POST /parlay {"team_a": "...", "team_b": "...",
                          "legs": [{"kind": "moneyline", "team": "..."},
                                   {"kind": "total", "side": "over",
                                    "line": 55.5}],
                          "n_pairs": 32768, "price": 450}

        Leg kinds: spread / moneyline / total / prop (see
        edge.resolve_parlay_legs).  Prop legs need the service to run with
        a focus csv so players are tracked.  `"correlations": true` adds
        the pairwise leg-correlation matrix under `parlay.leg_corr`;
        `"round_robin": 2` (or a list of sizes) adds the round-robin card
        — every size-k leg combination as its own ticket — under
        `parlay.round_robin`."""
        from .api import simulate_parlay

        legs = body["legs"]
        if not isinstance(legs, list) or not 0 < len(legs) <= 20:
            raise ValueError("legs must be a JSON array of 1..20 leg objects")
        price = body.get("price")
        rr = body.get("round_robin")

        def _is_size(k):  # bool is an int subclass: JSON `true` is NOT size 1
            return isinstance(k, int) and not isinstance(k, bool)

        if rr is not None and not (
                _is_size(rr)
                or (isinstance(rr, list) and rr
                    and all(_is_size(k) for k in rr))):
            raise ValueError("round_robin must be an integer ticket size or "
                             "a non-empty list of integers (e.g. 2 or [2, 3])")
        t0 = time.perf_counter()
        with self._admit("parlay", t0):
            res = simulate_parlay(
                body["team_a"], body["team_b"], legs,
                sp_path=self.cfg.sp_path, year=self.cfg.year,
                week=self.cfg.week, n_pairs=self._n_pairs(body, 32768),
                artifact_dir=self.cfg.artifact_dir,
                focus_csv=self.cfg.focus_csv, mode=self._mode(body),
                table_quality=self.cfg.table_quality,
                shard=bool(body.get("shard", self.cfg.shard)),
                seed=int(body.get("seed", 0)),
                price=None if price is None else int(price),
                correlations=bool(body.get("correlations", False)),
                round_robin=rr)
        return {"parlay": jsonable(res),
                "elapsed_s": round(time.perf_counter() - t0, 3)}


def _calibration_from_body(body: dict):
    """Optional opt-in affine market calibration from a request body:
    `"calibration": {"margin_shift": -2.0, "total_shift": -15.0,
    "margin_scale": 1.0, "total_scale": 1.0}` (any subset of keys;
    backtest.fit_calibration produces the values).  None when absent."""
    raw = body.get("calibration")
    if raw is None:
        return None
    from .edge import MarketCalibration

    if not isinstance(raw, dict):
        raise ValueError("calibration must be a JSON object of "
                         "margin/total shift/scale fields")
    allowed = {"margin_shift", "margin_scale", "total_shift", "total_scale"}
    bad = set(raw) - allowed
    if bad:
        raise ValueError(f"unknown calibration fields {sorted(bad)}; "
                         f"allowed: {sorted(allowed)}")
    vals = {k: float(v) for k, v in raw.items()}
    for k in ("margin_scale", "total_scale"):
        if vals.get(k, 1.0) <= 0:
            raise ValueError(f"{k} must be positive")
    return MarketCalibration(**vals)


def _situation_from_body(d: dict):
    """Parse one situation object from a request body — a thin dict
    adapter over api.situation_from_fields (the one shared parser, also
    behind the CLI's live/fourth commands)."""
    from .api import situation_from_fields

    return situation_from_fields(
        ytg=float(d["ytg"]), offense=d.get("offense", 0),
        sec=d.get("sec"), quarter=d.get("quarter"), clock=d.get("clock"),
        down=d.get("down", 1), dist=d.get("dist", 10.0),
        score_a=d.get("score_a", 0), score_b=d.get("score_b", 0))


_ROUTES = {"/slate": "slate", "/sim": "sim", "/props": "props",
           "/live": "live", "/parlay": "parlay", "/fourth": "fourth",
           "/season": "season"}


class _Handler(BaseHTTPRequestHandler):
    service: SimService  # injected by make_server

    # quiet by default; the service records request counts
    def log_message(self, fmt, *args):  # noqa: D102
        pass

    def _reply(self, code: int, payload: dict) -> None:
        data = json.dumps(payload).encode()
        try:
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
        except (BrokenPipeError, ConnectionResetError):
            pass  # client gave up; the sim result stays warm in the caches

    def do_GET(self):  # noqa: N802
        if self.path == "/health":
            self._reply(200, self.service.health())
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):  # noqa: N802
        name = _ROUTES.get(self.path)
        if name is None:
            self._reply(404, {"error": f"unknown path {self.path}"})
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
            if not isinstance(body, dict):
                raise ValueError("request body must be a JSON object")
        except (ValueError, json.JSONDecodeError) as e:
            self._reply(400, {"error": f"bad request body: {e}"})
            return
        try:
            self._reply(200, self.service.handle(name, body))
        except Overloaded as e:
            self._reply(503, {"error": str(e)})
        except (KeyError, ValueError, TypeError) as e:
            self._reply(400, {"error": f"{type(e).__name__}: {e}"})
        except Exception as e:  # noqa: BLE001 — surface, don't kill the server
            self._reply(500, {"error": f"{type(e).__name__}: {e}"})


def make_server(service: SimService, host: str = "127.0.0.1",
                port: int = 8787) -> ThreadingHTTPServer:
    """Build (but don't start) the HTTP server; port 0 picks a free port
    (`server.server_address[1]` reports it)."""
    handler = type("Handler", (_Handler,), {"service": service})
    return ThreadingHTTPServer((host, port), handler)


def serve_forever(cfg: ServeConfig, host: str = "127.0.0.1",
                  port: int = 8787, warm_games=None) -> None:
    service = SimService(cfg)
    # bind BEFORE warming: the warm slate can compile for minutes, and a
    # bad --warm CSV must not kill the process with the port never bound —
    # early clients connect and queue (or hit /health) while warm runs
    srv = make_server(service, host, port)
    print(f"fmc serving on http://{host}:{srv.server_address[1]} "
          f"(sp={cfg.sp_path}, artifacts={cfg.artifact_dir}, "
          f"mode={cfg.mode}/{cfg.table_quality})", flush=True)
    try:
        if warm_games is not None:
            try:
                print(f"warming: {service.warm(warm_games)}", flush=True)
            except Exception as e:  # noqa: BLE001 — warm is best-effort
                print(f"warm failed (serving anyway): "
                      f"{type(e).__name__}: {e}", flush=True)
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
