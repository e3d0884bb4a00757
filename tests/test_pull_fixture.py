"""CFBD pull path against a recorded-shape fixture (no egress).

The environment cannot reach collegefootballdata.com, so the pull stage
was previously untested past its key-gating.  These tests mock
urllib.request.urlopen with JSON payloads matching the CFBD response
shapes the reference consumes (/plays raw rows incl. playText/playType,
pull_cfb_raw_data.py:36-43; /coaches records with first/last name and a
`seasons` list, :60-70) and drive pull_plays/pull_coaches through the real
request/parse/merge code into the downstream processing stages."""
import io
import json

import pandas as pd
import pytest

from fast_monte_carlo.train import pipeline as P

PLAYS_FIXTURE = [
    {
        "id": "401520001101",
        "offense": "Kansas State", "defense": "Iowa State",
        "offenseScore": 7, "defenseScore": 3,
        "down": 2, "distance": 7.0, "yardsToGoal": 55.0,
        "yardsGained": 12,
        "period": 2, "clock": {"minutes": 10, "seconds": 30},
        "offenseTimeouts": 3, "defenseTimeouts": 2,
        "playType": "Pass Reception",
        "playText": "Avery Johnson pass complete to Jayce Brown for 12 yds",
        "wallclock": "2024-09-01T18:00:00.000Z",
    },
    {
        "id": "401520001102",
        "offense": "Iowa State", "defense": "Kansas State",
        "offenseScore": 3, "defenseScore": 7,
        "down": 1, "distance": 10.0, "yardsToGoal": 75.0,
        "yardsGained": 4,
        "period": 2, "clock": {"minutes": 9, "seconds": 55},
        "offenseTimeouts": 3, "defenseTimeouts": 3,
        "playType": "Rush",
        "playText": "Abu Sama run for 4 yds",
        "wallclock": "2024-09-01T18:01:00.000Z",
    },
]

COACHES_FIXTURE = [
    {
        "first_name": "Chris", "last_name": "Klieman",
        "seasons": [{"school": "Kansas State", "year": 2023, "games": 13,
                     "wins": 9, "losses": 4}],
    },
    {
        "first_name": "Interim", "last_name": "Guy",
        "seasons": [{"school": "Kansas State", "year": 2023, "games": 2,
                     "wins": 1, "losses": 1}],
    },
]


class _FakeResponse(io.BytesIO):
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


@pytest.fixture
def fake_cfbd(monkeypatch):
    """Patch urllib urlopen to serve the fixtures; records requested URLs."""
    import urllib.request

    calls = []

    def fake_urlopen(req, timeout=None):
        url = req.full_url
        calls.append(url)
        if "/plays" in url:
            payload = PLAYS_FIXTURE
        elif "/coaches" in url:
            payload = COACHES_FIXTURE
        else:
            raise AssertionError(f"unexpected URL {url}")
        return _FakeResponse(json.dumps(payload).encode())

    monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)
    monkeypatch.setenv("CFBD_API_KEY", "test-key")
    return calls


def test_pull_plays_parses_response_shape(fake_cfbd):
    df = P.pull_plays(years=(2023,))
    # 15 weeks hit the endpoint; each returns the 2-play fixture
    assert len([u for u in fake_cfbd if "/plays" in u]) == 15
    assert len(df) == 30
    assert {"offense", "defense", "playText", "playType", "down",
            "distance", "yardsToGoal", "year", "week"} <= set(df.columns)
    assert (df["year"] == 2023).all()
    # auth + FBS filter actually in the request
    assert all("classification=fbs" in u for u in fake_cfbd
               if "/plays" in u)


def test_pull_2024_limited_to_week8(fake_cfbd):
    P.pull_plays(years=(2024,))
    weeks = sorted({int(u.split("week=")[1].split("&")[0])
                    for u in fake_cfbd if "/plays" in u})
    assert weeks == list(range(1, 9))


def test_pull_coaches_and_merge_into_plays(fake_cfbd):
    plays = P.pull_plays(years=(2023,))
    coaches = P.pull_coaches(years=(2023,))
    assert "seasons" in coaches.columns
    merged = P.merge_primary_coaches(plays, coaches)
    ks = merged[merged["offense"] == "Kansas State"]
    # primary (13-game) coach wins over the 2-game interim
    assert (ks["head_coach"] == "Chris Klieman").all()


def test_pulled_rows_flow_through_processing(fake_cfbd):
    df = P.pull_plays(years=(2023,))
    parsed = df.join(pd.DataFrame(
        [P.parse_play_text(t, p) for t, p in zip(df.playText, df.playType)],
        index=df.index))
    assert (parsed.loc[parsed.playType == "Pass Reception",
                       "passer_name"] == "Avery Johnson").all()
    assert (parsed.loc[parsed.playType == "Rush",
                       "rusher_name"] == "Abu Sama").all()


def test_pull_without_key_raises(monkeypatch):
    monkeypatch.delenv("CFBD_API_KEY", raising=False)
    with pytest.raises(RuntimeError, match="CFBD_API_KEY"):
        P.pull_plays(years=(2023,))
