#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port's main path, on one GPU.

    python3 profile_port.py [--out profile.json] [--only NAME,...]

Runs chip_smoke.py's main-path queries (`main_queries()`: TPC-H q01, q06, the
q18 aggregation block, q03, q04, q13, q18, q21 and q22 at SF1), the
breadth path's TPC-DS q47, q51, q67 and q75 at SF1 and TPC-H
running-window and rank queries at SF1 (`breadth_queries()`; a query
that returns 1.5M rows is timed to its result page on the card, without
the conversion to Python rows) and the decimal path's TPC-H q01, q03,
q06, q10 and q19 over SF1 lineitem with DECIMAL(12,2) money columns
(`decimal_queries()`, named dec_q01 ..), the nested path's UNNEST
queries n1-n4 over the SF1 orders_nested table (`nested_queries()`) and
the approx path's a1-a5 over TPC-H SF1 (`APPROX_QUERIES`) through
presto_tpu_torch's LocalEngine on the card (--only limits the run to the
named queries):
once cold (column uploads, capacity retries), WARM times warm and timed,
once warm under torch.profiler. Prints per query the median warm wall time,
the device busy time (the union of kernel and copy intervals in the
trace) beside the traced run's wall time, the dictionary transforms
computed in the warm runs (expr/compile.DICT_CACHE), the device time by
kind (sorts: cub radix sorts; gathers: torch's index kernels;
hand-written: the __global__ functions of presto_tpu_torch/csrc, by
source; other: every other kernel and copy) and of the heaviest kernels;
with --out,
writes the same as JSON, with the device time of every kernel. Fails
where there is no CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import sys
import time
from pathlib import Path

from chip_smoke import APPROX_QUERIES, SF, TPCDS_SF, breadth_queries, \
    card_line, decimal_connector, decimal_queries, main_queries, \
    nested_connector, nested_queries, run_query

TOP = 8        # heaviest device kernels listed per query
WARM = 7       # timed warm runs per query (median reported)
BREADTH = ("ds47", "ds51", "ds67", "ds75", "h_running_sum", "h_rank")


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


#: a kernel's definition: `__global__`, `void` and its name, with
#: attributes such as `__launch_bounds__(...)` or `__cluster_dims__(...)`
#: before or after `void`
_KERNEL = re.compile(r"__global__\s+(?:__\w+__\([^)]*\)\s+)*void"
                     r"\s+(?:__\w+__\([^)]*\)\s+)*(\w+)\s*\(")


def _hand_written() -> dict:
    """__global__ function name -> its csrc source (file stem)."""
    csrc = Path(__file__).resolve().parent / "presto_tpu_torch" / "csrc"
    out = {}
    for path in csrc.glob("*.cu"):
        for name in _KERNEL.findall(path.read_text()):
            out[name] = path.stem
    return out


def by_kind(kernels_ms: dict) -> dict:
    """Device milliseconds by kind: sorts, gathers, each hand-written
    source, other."""
    hand = _hand_written()
    out = {"sorts": 0.0, "gathers": 0.0, "other": 0.0}
    for name, ms in kernels_ms.items():
        fn = re.match(r"(?:void\s+)?(\w+)", name)
        src = hand.get(fn.group(1)) if fn else None
        if src is not None:
            key = f"hand:{src}"
        elif "RadixSort" in name:
            key = "sorts"
        elif "index_elementwise_kernel" in name:
            key = "gathers"
        else:
            key = "other"
        out[key] = out.get(key, 0.0) + ms
    return out


def profile_query(engine, sql: str, as_page: bool = False) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from presto_tpu_torch.expr.compile import DICT_CACHE

    run_query(engine, sql, as_page)              # cold
    computed = DICT_CACHE.computed
    walls = []
    for _ in range(WARM):                        # warm, timed
        torch.cuda.synchronize()
        t = time.perf_counter()
        run_query(engine, sql, as_page)
        walls.append((time.perf_counter() - t) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run_query(engine, sql, as_page)
        traced_ms = (time.perf_counter() - t) * 1e3
    warm_transforms = DICT_CACHE.computed - computed
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
            "warm_transforms": warm_transforms,
            "top_kernels_ms": [(n, us / 1e3) for n, us in heavy],
            "by_kind_ms": by_kind({n: us / 1e3 for n, us in by_name.items()}),
            "kernels_ms": {n: us / 1e3 for n, us in by_name.items()}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the result as JSON here")
    ap.add_argument("--only", help="comma-separated query names")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile_port: no CUDA device", file=sys.stderr)
        return 2
    from presto_tpu_torch.connectors import TpcdsConnector, TpchConnector
    from presto_tpu_torch.exec.engine import LocalEngine

    card = card_line()
    engine = LocalEngine(TpchConnector(SF))
    ds_engine = LocalEngine(TpcdsConnector(TPCDS_SF))
    result = {"card": card, "sf": SF, "tpcds_sf": TPCDS_SF, "queries": {}}
    runs = [(name, engine, sql, False)
            for name, (sql, _ordered) in main_queries().items()]
    runs += [(name, engine, sql, False)
             for name, sql in APPROX_QUERIES.items()]
    breadth = breadth_queries(ds_engine, engine)
    runs += [(name, breadth[name][0], breadth[name][1], breadth[name][3])
             for name in BREADTH]
    dec_engine = LocalEngine(decimal_connector(engine.connector))
    runs += [(f"dec_{name}", dec_engine, sql, False)
             for name, (sql, _ordered) in decimal_queries().items()]
    names = set(args.only.split(",")) if args.only else None
    if names is None or names & set(nested_queries()):
        from presto_tpu_torch.connectors.tpch import nested_orders
        nested_engine = LocalEngine(nested_connector(
            engine.connector, nested_orders(SF)))
        runs += [(name, nested_engine, sql, False)
                 for name, (sql, _flat) in nested_queries().items()]
    if names is not None:
        runs = [r for r in runs if r[0] in names]
    for name, eng, sql, as_page in runs:
        r = profile_query(eng, sql, as_page)
        result["queries"][name] = r
        print(f"{name}: warm wall median {r['wall_ms']:.2f} ms (min "
              f"{min(r['wall_ms_all']):.2f}), device busy "
              f"{r['device_busy_ms']:.2f} ms of {r['traced_wall_ms']:.2f} "
              f"ms traced ({r['device_events']} device events, "
              f"{r['warm_transforms']} dictionary transforms computed in "
              f"the warm runs); by kind "
              + ", ".join(f"{k} {v:.3f}" for k, v in r["by_kind_ms"].items()))
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
