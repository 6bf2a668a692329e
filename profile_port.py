#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port's main path, on one GPU.

    python3 profile_port.py [--out profile.json]

Runs chip_smoke.py's main-path queries (`main_queries()`: TPC-H q01, q06, the
q18 aggregation block, q03, q04, q13, q18, q21 and q22 at SF1) through
presto_tpu_torch's LocalEngine on the card: once cold (column uploads,
capacity retries), WARM times warm and timed, once warm under
torch.profiler. Prints per query the median warm wall time,
the device busy time (the union of kernel and copy intervals in the
trace) beside the traced run's wall time, and the device time of the
heaviest kernels; with --out, writes the same as JSON, with the device
time of every kernel. Fails where there is no CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

from chip_smoke import SF, card_line, main_queries

TOP = 8        # heaviest device kernels listed per query
WARM = 7       # timed warm runs per query (median reported)


def _busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals (microseconds)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def profile_query(engine, sql: str) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    engine.execute_sql(sql)                      # cold
    walls = []
    for _ in range(WARM):                        # warm, timed
        torch.cuda.synchronize()
        t = time.perf_counter()
        engine.execute_sql(sql)
        walls.append((time.perf_counter() - t) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        engine.execute_sql(sql)
        traced_ms = (time.perf_counter() - t) * 1e3
    intervals, by_name = [], {}
    for ev in prof.events():
        if ev.device_type.name != "CUDA":
            continue
        start = ev.time_range.start
        end = ev.time_range.end
        intervals.append((start, end))
        by_name[ev.name] = by_name.get(ev.name, 0.0) + (end - start)
    busy_ms = _busy_us(intervals) / 1e3
    heavy = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"wall_ms": statistics.median(walls), "wall_ms_all": walls,
            "traced_wall_ms": traced_ms,
            "device_busy_ms": busy_ms,
            "busy_share": busy_ms / traced_ms if traced_ms else None,
            "device_events": len(intervals),
            "top_kernels_ms": [(n, us / 1e3) for n, us in heavy],
            "kernels_ms": {n: us / 1e3 for n, us in by_name.items()}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the result as JSON here")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile_port: no CUDA device", file=sys.stderr)
        return 2
    from presto_tpu_torch.connectors import TpchConnector
    from presto_tpu_torch.exec.engine import LocalEngine

    card = card_line()
    engine = LocalEngine(TpchConnector(SF))
    result = {"card": card, "sf": SF, "queries": {}}
    for name, (sql, _ordered) in main_queries().items():
        r = profile_query(engine, sql)
        result["queries"][name] = r
        print(f"{name}: warm wall median {r['wall_ms']:.2f} ms (min "
              f"{min(r['wall_ms_all']):.2f}), device busy "
              f"{r['device_busy_ms']:.2f} ms of {r['traced_wall_ms']:.2f} "
              f"ms traced ({r['device_events']} device events)")
        for kname, ms in r["top_kernels_ms"]:
            print(f"    {ms:9.3f} ms  {kname[:90]}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
