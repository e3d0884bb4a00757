"""Round-robin parlays (edge.round_robin / edge.round_robin_blocks).

Referee strategy: every round-robin ticket must price EXACTLY as
parlay_odds on that leg subset (parlay_odds is itself pinned against a
pure-numpy settlement oracle in test_parlay.py) — the card is one device
reduction but must be indistinguishable from pricing each ticket alone.
Card aggregates check against direct numpy recomputation.  No reference
counterpart: edge_finder.py prices single marginals only.
"""
import itertools
import json

import numpy as np
import pytest

from fast_monte_carlo.edge import (cross_game_parlay, parlay_odds,
                                       round_robin, round_robin_blocks)
from tests.test_parlay import _Ctx, _Out, _settle_reference


@pytest.fixture(scope="module")
def rr_out():
    a = _Ctx("Alpha", qb=["QB A"], rush=["RB A"], target=["WR A"])
    b = _Ctx("Beta", qb=["QB B"], rush=["RB B"], target=["WR B"])
    rng = np.random.default_rng(7)
    n = 400
    sa = rng.integers(0, 60, size=n)
    sb = rng.integers(0, 60, size=n)
    score = np.stack([sa, sb], axis=1)
    pstats = np.zeros((n, 2, 3, 1, 6), dtype=np.float32)
    pstats[:, 0, 0, 0, 2] = rng.integers(0, 400, size=n)  # QB A pass_yds
    return a, b, _Out(score, pstats), score, pstats


LEGS = [
    {"kind": "spread", "team": "Alpha", "line": -3.0},   # integer: pushes
    {"kind": "total", "side": "over", "line": 52.0},     # integer: pushes
    {"kind": "moneyline", "team": "Beta"},               # ties push
    {"kind": "prop", "team": "Alpha", "player": "QB A", "stat": "pass_yds",
     "side": "over", "line": 250.0},
]


def test_round_robin_tickets_match_parlay_odds(rr_out):
    """Each by-2 ticket carries exactly the numbers parlay_odds produces
    for that pair alone — including the refund-semantics p_parlay and the
    priced block."""
    a, b, out, *_ = rr_out
    res = round_robin(out, a, b, LEGS, by=2, price=-110)
    assert res["n_tickets"] == 6 and res["by"] == [2]
    combos = list(itertools.combinations(range(4), 2))
    for t, c in zip(res["tickets"], combos):
        want = parlay_odds(out, a, b, [LEGS[j] for j in c], price=-110)
        assert t["legs"] == [leg["label"] for leg in want["legs"]]
        for k in ("p_all_win", "p_lose", "p_void", "p_win_reduced",
                  "p_parlay", "fair_american", "edge_pct", "ev_$100",
                  "kelly"):
            assert t[k] == pytest.approx(want[k], abs=1e-9), (c, k)
    assert res["ev_total_$100"] == pytest.approx(
        sum(t["ev_$100"] for t in res["tickets"]), abs=0.02)
    assert res["stake_$"] == 600


def test_round_robin_mixed_sizes_and_aggregates(rr_out):
    """by=(2,3) emits all doubles then trebles; the card aggregates match
    numpy recomputation on the win indicators."""
    a, b, out, score, pstats = rr_out
    res = round_robin(out, a, b, LEGS, by=(3, 2))
    assert res["by"] == [2, 3]
    assert res["n_tickets"] == 6 + 4
    assert [t["k"] for t in res["tickets"]] == [2] * 6 + [3] * 4

    ref = _settle_reference(score, pstats, LEGS, a, b)
    wins = np.stack([
        # rebuild per-trial win indicators the long way
        ((score[:, 0] - score[:, 1]) > 3.0),
        (score.sum(1) > 52.0),
        ((score[:, 1] - score[:, 0]) > 0),
        (pstats[:, 0, 0, 0, 2] > 250.0),
    ], axis=1)
    nw = wins.sum(axis=1)
    # some ticket wins whole iff >= min(by) legs win; all tickets win iff
    # every leg does
    assert res["p_any_ticket_wins"] == pytest.approx((nw >= 2).mean(),
                                                     abs=1e-9)
    assert res["p_all_tickets_win"] == pytest.approx((nw == 4).mean(),
                                                     abs=1e-9)
    assert res["p_all_tickets_win"] == pytest.approx(ref["p_all_win"],
                                                     abs=1e-9)


def test_round_robin_singles_are_the_leg_marginals(rr_out):
    """by=1: each ticket is its leg priced alone (push-refund identity)."""
    a, b, out, *_ = rr_out
    res = round_robin(out, a, b, LEGS, by=1)
    full = parlay_odds(out, a, b, LEGS)
    for t, leg in zip(res["tickets"], full["legs"]):
        p_win, p_push = leg["p_win"], leg["p_push"]
        assert t["p_all_win"] == pytest.approx(p_win, abs=1e-9)
        assert t["p_void"] == pytest.approx(p_push, abs=1e-9)
        assert t["p_parlay"] == pytest.approx(
            p_win / max(p_win + (1 - p_win - p_push), 1e-12), abs=1e-6)


def test_round_robin_validation(rr_out):
    a, b, out, *_ = rr_out
    with pytest.raises(ValueError, match="invalid for 4 legs"):
        round_robin(out, a, b, LEGS, by=5)
    with pytest.raises(ValueError, match="invalid for 4 legs"):
        round_robin(out, a, b, LEGS, by=0)
    with pytest.raises(ValueError, match="at least one ticket size"):
        round_robin(out, a, b, LEGS, by=[])
    with pytest.raises(ValueError, match="max_tickets"):
        round_robin(out, a, b, LEGS, by=2, max_tickets=3)
    # bool is an int subclass: JSON `true` must not price a singles card
    with pytest.raises(ValueError, match="must be an integer"):
        round_robin(out, a, b, LEGS, by=True)
    # non-integral sizes must not silently truncate (2.5 -> 2)
    with pytest.raises(ValueError, match="must be an integer"):
        round_robin(out, a, b, LEGS, by=[2.5])
    with pytest.raises(ValueError, match="must be an integer"):
        round_robin(out, a, b, LEGS, by=[2, True])
    # strings iterate character-wise: by='23' must not become sizes {2, 3}
    with pytest.raises(ValueError, match="size spec"):
        round_robin(out, a, b, LEGS, by="23")
    # np.bool_ is neither int nor bool: must be the intended ValueError,
    # not a TypeError from the iterable branch
    with pytest.raises(ValueError, match="size spec"):
        round_robin(out, a, b, LEGS, by=np.bool_(True))
    with pytest.raises(ValueError, match="must be an integer"):
        round_robin(out, a, b, LEGS, by=[2, np.bool_(True)])


def test_round_robin_blocks_exact(rr_out):
    """Cross-game round robin: tickets equal cross_game_parlay on each
    block pair, and the Poisson-binomial card aggregates match the block
    probabilities' direct composition."""
    a, b, out, *_ = rr_out
    c = _Ctx("Gamma", qb=["QB C"])
    d = _Ctx("Delta", qb=["QB D"])
    score2 = np.array([[35, 10], [21, 24], [27, 27], [17, 13]])
    out2 = _Out(score2, np.zeros((4, 2, 3, 1, 6), np.float32))
    e = _Ctx("Eps", qb=["QB E"])
    f = _Ctx("Zeta", qb=["QB F"])
    score3 = np.array([[10, 13], [20, 3], [31, 28], [7, 24]])
    out3 = _Out(score3, np.zeros((4, 2, 3, 1, 6), np.float32))

    blocks = [
        parlay_odds(out, a, b, [{"kind": "moneyline", "team": "Alpha"}]),
        parlay_odds(out2, c, d, [{"kind": "moneyline", "team": "Gamma"}]),
        parlay_odds(out3, e, f, [{"kind": "spread", "team": "Zeta",
                                  "line": -2.5}]),
    ]
    res = round_robin_blocks(blocks, by=2, price=260)
    assert res["n_tickets"] == 3
    for t, cmb in zip(res["tickets"],
                      itertools.combinations(range(3), 2)):
        want = cross_game_parlay([blocks[j] for j in cmb], price=260)
        assert t["p_all_win"] == want["p_all_win"]
        assert t["ev_$100"] == want["ev_$100"]
    p = [b_["p_all_win"] for b_ in blocks]
    brute = 0.0   # P(at least 2 of 3 independent blocks win whole)
    for bits in itertools.product([0, 1], repeat=3):
        if sum(bits) >= 2:
            brute += np.prod([p[i] if w else 1 - p[i]
                              for i, w in enumerate(bits)])
    # block p_all_win values are 6dp-rounded; their products can carry 8dp
    assert res["p_any_ticket_wins"] == pytest.approx(brute, abs=2e-6)
    assert res["p_all_tickets_win"] == pytest.approx(np.prod(p), abs=2e-6)
    with pytest.raises(ValueError, match="invalid for 3"):
        round_robin_blocks(blocks, by=4)


def test_print_round_robin(rr_out, capsys):
    from fast_monte_carlo.edge import print_round_robin_readable

    a, b, out, *_ = rr_out
    print_round_robin_readable(round_robin(out, a, b, LEGS, by=2,
                                           price=-110))
    text = capsys.readouterr().out
    assert "Round robin by 2" in text and "6 tickets" in text
    assert "P(any ticket wins)" in text


def test_cli_parlay_rr(reference_dir, tmp_path, capsys):
    from fast_monte_carlo.cli import main

    legs = [{"kind": "moneyline", "team": "Kansas State"},
            {"kind": "total", "side": "under", "line": 60.5},
            {"kind": "spread", "team": "Kansas State", "line": -3.5}]
    p = tmp_path / "legs.json"
    p.write_text(json.dumps(legs))
    rc = main(["parlay", "Kansas State", "Iowa State",
               "--sp", str(reference_dir / "PregameSPPlus2025_1.csv"),
               "--legs", f"@{p}", "-n", "128", "--mode", "analytic",
               "--price", "-110", "--rr", "2", "--json"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Round robin by 2" in out
    payload = json.loads(out.strip().rsplit("\n", 1)[-1])
    rr = payload["round_robin"]
    assert rr["n_tickets"] == 3 and len(rr["tickets"]) == 3
    # bad size spec fails loudly before any sim
    with pytest.raises(SystemExit, match="--rr wants"):
        main(["parlay", "Kansas State", "Iowa State",
              "--sp", str(reference_dir / "PregameSPPlus2025_1.csv"),
              "--legs", f"@{p}", "-n", "128", "--mode", "analytic",
              "--rr", "two"])
    with pytest.raises(ValueError, match="invalid for 3 legs"):
        main(["parlay", "Kansas State", "Iowa State",
              "--sp", str(reference_dir / "PregameSPPlus2025_1.csv"),
              "--legs", f"@{p}", "-n", "128", "--mode", "analytic",
              "--rr", "4"])
