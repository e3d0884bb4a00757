"""Warm-serving latency distribution under concurrent clients.

Spins the resident service in-process (real ThreadingHTTPServer on a
loopback port), warms /sim and /live once, then drives N concurrent
client threads for R requests each and reports per-endpoint p50/p95/p99
from the client side plus the service's own /health latency rings
(VERDICT r3 #7).  Device work is serialized behind the service lock, so
concurrency measures queueing behavior, not parallel speedup.

Run on the GPU:  python benchmarks/serve_latency.py [--clients 4]
                 [--requests 25] [--deadline 30]
"""
import argparse
import json
import sys
import threading
import time
import urllib.request
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

SIM_BODY = {"team_a": "Kansas State", "team_b": "Iowa State",
            "n_pairs": 32768, "spread": -3.5, "total": 55.5}
LIVE_BODY = {"team_a": "Kansas State", "team_b": "Iowa State",
             "offense": "B", "quarter": 4, "clock": "07:00", "down": 2,
             "dist": 7, "ytg": 35, "score_a": 21, "score_b": 17,
             "n_games": 65536}


def _post(url, body, timeout=600):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            json.loads(r.read())
            return r.status, time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        e.read()
        return e.code, time.perf_counter() - t0


def pct(xs, q):
    import numpy as np
    return float(np.percentile(np.asarray(xs), q)) * 1e3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--requests", type=int, default=25,
                    help="requests per client per endpoint")
    ap.add_argument("--deadline", type=float, default=None,
                    help="ServeConfig.deadline_s (503 shedding)")
    ap.add_argument("--same-matchup", action="store_true",
                    help="all clients post the IDENTICAL /sim body (no "
                         "seed variation): measures request coalescing — "
                         "concurrent identical requests share one device "
                         "launch (VERDICT r4 #4)")
    ap.add_argument("--sp", default="/root/reference/PregameSPPlus2025_1.csv")
    args = ap.parse_args()

    from fast_monte_carlo.serve import ServeConfig, SimService, make_server

    cfg = ServeConfig(sp_path=args.sp, deadline_s=args.deadline)
    service = SimService(cfg)
    srv = make_server(service, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"

    for path, body in (("/sim", SIM_BODY), ("/live", LIVE_BODY)):
        t0 = time.perf_counter()
        code, dt = _post(base + path, body)
        print(f"# warm {path}: {code} in {dt:.1f}s "
              f"(compile+build on first call)", flush=True)

    results = {"/sim": [], "/live": []}
    shed = {"/sim": 0, "/live": 0}
    lock = threading.Lock()

    endpoints = ([("/sim", SIM_BODY), ("/live", LIVE_BODY)]
                 if args.same_matchup
                 else [("/sim", SIM_BODY), ("/live", LIVE_BODY)])
    # identical /live bodies exercise the generic single-flight path

    def client(k):
        for i in range(args.requests):
            for path, body in endpoints:
                body = dict(body)
                if not args.same_matchup:
                    body["seed"] = 1000 * k + i   # vary requests a little
                code, dt = _post(base + path, body)
                with lock:
                    if code == 200:
                        results[path].append(dt)
                    else:
                        shed[path] += 1

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(k,))
               for k in range(args.clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0

    print(f"\n{args.clients} clients x {args.requests} req x "
          f"{len(endpoints)} endpoint(s)"
          + (" [same-matchup]" if args.same_matchup else "")
          + f" in {wall:.1f}s")
    for path, xs in results.items():
        if not xs:
            continue
        print(f"{path}: n={len(xs)} shed={shed[path]}  "
              f"p50 {pct(xs, 50):,.0f} ms  p95 {pct(xs, 95):,.0f} ms  "
              f"p99 {pct(xs, 99):,.0f} ms  max {max(xs)*1e3:,.0f} ms")
    with urllib.request.urlopen(base + "/health", timeout=60) as r:
        h = json.loads(r.read())
    print("service-side /health latency:",
          json.dumps(h.get("latency", {}), indent=2))
    print(f"coalesced (requests answered from a shared launch): "
          f"{h.get('coalesced', 0)}")
    srv.shutdown()
    srv.server_close()


if __name__ == "__main__":
    main()
