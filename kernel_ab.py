#!/usr/bin/env python3
"""K1 direct_agg, K5 join_probe, K6 join_expand, K7 segmented_scan (and
window_bounds), K8 key_change_flags, K9 window_frame, K11 unnest_expand,
K12 hll_registers and K13 segment_select against another checkout's
kernels, in one process on one GPU.

    python3 kernel_ab.py OTHER [--out ab.json] [--only KERNEL,...]

OTHER is the root of another checkout of this repository (for example the
parent commit, unpacked with `git archive`). Its presto_tpu_torch/native.py,
ops/aggregate.py, ops/join.py, ops/scan.py, ops/keys.py, ops/window.py and
ops/unnest.py are loaded under other module names, so that their wrappers
launch OTHER's kernels, built by OTHER's native.py from OTHER's csrc/ into
OTHER's build directory. chip_smoke.py's phase-3 shapes of the kernels
(direct_agg_cases, direct_agg_sum128_case, join_probe_cases,
join_expand_cases, seg_scan_cases, key_change_cases, window_frame_cases,
unnest_expand_cases, hll_registers_cases and segment_select_cases; TPC-H
SF1 for the joins', K7's, K8's, K9's, K12's and K13's, TPC-DS SF1 for
K7's q51 inputs, the SF1
nested orders for K11's) are built once; each is held against its plain
version under both checkouts (run_direct_agg_case, run_join_probe_case,
run_join_expand_case, run_scan_case, run_key_change_case,
run_window_frame_case, run_unnest_case, run_hll_case, which also time the
plain versions and library calls), then timed with CUDA events
(chip_smoke.cuda_time_ms, chip_smoke.REPEAT calls) in turns: OTHER, this
checkout, this checkout, OTHER. Where OTHER's ops/scan.py has no
window_bounds, its bounds case is the four segmented_scan launches and two
shifts a window took before. Where OTHER's ops/aggregate.py has no
segment_select, its K13 case is the whole approx_percentile step as OTHER
takes it (parent_chain: its lex_perm of the page by group, NULL last and
key, the gather, and its segment_pick; the per-group counts, which OTHER
takes from K1 or K3, are made outside the timed call). --only limits the
run to the named kernels (direct_agg, join_probe, join_expand,
segmented_scan, key_change_flags, window_frame, unnest_expand,
hll_registers, segment_select). --trace also runs each case once per checkout under
torch.profiler and reports the device time of each kernel and copy the
call launches (microseconds, by name). Prints per case the four times and writes them, with the
card's name and power limit, as JSON to --out. Fails where there is no
CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import sys
import time
import types
from pathlib import Path

import numpy as np

import chip_smoke as CS


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod         # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def other_modules(root: Path):
    """(aggregate, join, scan, keys, window, unnest) of the checkout at
    `root`, whose wrappers load their kernels through that checkout's
    native.py."""
    import presto_tpu_torch
    pkg = root / "presto_tpu_torch"
    native = _load(pkg / "native.py", "other_native")
    agg = _load(pkg / "ops" / "aggregate.py", "other_aggregate")
    join = _load(pkg / "ops" / "join.py", "other_join")
    scan = _load(pkg / "ops" / "scan.py", "other_scan")
    keys = _load(pkg / "ops" / "keys.py", "other_keys")
    window = _load(pkg / "ops" / "window.py", "other_window")
    unnest = _load(pkg / "ops" / "unnest.py", "other_unnest")

    @contextlib.contextmanager
    def own_native():
        # the wrappers import `native` from the package when they launch
        mine = presto_tpu_torch.native
        presto_tpu_torch.native = native
        try:
            yield
        finally:
            presto_tpu_torch.native = mine

    def wrap(fn):
        def call(*args, **kwargs):
            with own_native():
                return fn(*args, **kwargs)
        return call

    A = types.SimpleNamespace(
        direct_agg=wrap(agg.direct_agg),
        _direct_agg_plain=agg._direct_agg_plain, WANT_SUM=agg.WANT_SUM,
        WANT_MINMAX=agg.WANT_MINMAX, WANT_SUM128=agg.WANT_SUM128,
        hll_registers=wrap(agg.hll_registers),
        lex_perm=keys.lex_perm, flush_subnormal=keys.flush_subnormal)
    for name in ("segment_select", "segment_pick"):
        if hasattr(agg, name):
            setattr(A, name, wrap(getattr(agg, name)))
    J = types.SimpleNamespace(join_probe=wrap(join.join_probe),
                              _join_probe_plain=join._join_probe_plain,
                              join_expand=wrap(join.join_expand))
    S = types.SimpleNamespace(segmented_scan=wrap(scan.segmented_scan))
    if hasattr(scan, "window_bounds"):
        S.window_bounds = wrap(scan.window_bounds)
    K = types.SimpleNamespace(key_change_flags=wrap(keys.key_change_flags))
    W = types.SimpleNamespace(window_frame=wrap(window.window_frame))
    U = types.SimpleNamespace(unnest_expand=wrap(unnest.unnest_expand))
    built = native.build(["direct_agg", "join", "seg_scan", "keys",
                          "window", "unnest", "hll", "percentile"])
    return A, J, S, K, W, U, built


KERNELS = ("direct_agg", "join_probe", "join_expand", "segmented_scan",
           "key_change_flags", "window_frame", "unnest_expand",
           "hll_registers", "segment_select")
LIBS = {"direct_agg": "direct_agg", "join_probe": "join",
        "join_expand": "join", "segmented_scan": "seg_scan",
        "key_change_flags": "keys", "window_frame": "window",
        "unnest_expand": "unnest", "hll_registers": "hll",
        "segment_select": "percentile"}


def parent_chain(c, m):
    """A call of K13's case c as a checkout without segment_select takes
    the step: m.lex_perm by (group, NULL last, key), the gather and
    m.segment_pick over the group starts and live counts (made here)."""
    import torch
    vals, live, mode, p = c["vals"], c["live"], c["mode"], c["p"]
    ov = m.flush_subnormal(vals) if vals.dtype == torch.float64 else vals
    if "codes" in mode:
        codes, bins = mode["codes"], mode["bins"]
        lanes = [torch.where(live, codes, bins), ov]
        cnt = torch.bincount(codes[live].to(torch.int64), minlength=bins)
        starts = torch.cumsum(cnt, 0) - cnt
    else:
        # gid as the sorted path forms it: the rows of the g-th run carry
        # g + 1, rows past the last run the last run's
        starts, ends = mode["starts"], mode["ends"]
        n = vals.shape[0]
        first = starts[ends > starts]
        marks = torch.zeros(n + 1, dtype=torch.int64, device=vals.device)
        marks.index_add_(0, first, torch.ones_like(first))
        gid = torch.cumsum(marks[:n], 0)
        lanes = [gid, (~live).to(torch.int8), ov]
        cum = torch.cat([torch.zeros(1, dtype=torch.int64,
                                     device=vals.device),
                         torch.cumsum(live.to(torch.int64), 0)])
        cnt = cum[ends] - cum[starts]
    return lambda: m.segment_pick(vals[m.lex_perm(lanes)], starts, cnt, p)


def run_parent_chain(c, repeat, m) -> dict:
    """parent_chain's result held against this checkout's plain version:
    the NULL flags and every non-NULL value, bit for bit."""
    from presto_tpu_torch.ops import aggregate as A
    got = parent_chain(c, m)()
    want = A._segment_select_plain(c["vals"], c["live"], c["p"],
                                   c["mode"].get("codes"),
                                   c["mode"].get("bins"),
                                   c["mode"].get("starts"),
                                   c["mode"].get("ends"))
    keep = ~want[1]
    if not (CS.same_bits(got[1], want[1])
            and CS.same_bits(got[0][keep], want[0][keep])):
        CS.fail(f"the parent's K13 chain ({c['case']}) differs from the "
                f"plain version")
    return {}


def _calls(kind, c, m):
    """A call of case c under module m, for timing."""
    if kind == "direct_agg":
        args = (c["cap"], c["num_rows"], c["keys"], c["domains"],
                c["inputs"], c["mask"])
        return lambda: m.direct_agg(*args)
    if kind == "join_probe":
        args = (c["ph"], c["bh_sorted"], c["order"], c["pvals"], c["bvals"],
                c["mode"])
        return lambda: m.join_probe(*args)
    if kind == "key_change_flags":
        args = (c["perm"], c["keys"], c["num_rows"], c["npart"], c["mode"])
        return lambda: m.key_change_flags(*args)
    if kind == "window_frame":
        return lambda: m.window_frame(*c["args"])
    if kind == "unnest_expand":
        return lambda: m.unnest_expand(*c["args"])
    if kind == "join_expand":
        return lambda: m.join_expand(*c["args"])
    if kind == "hll_registers":
        return lambda: m.hll_registers(c["vals"], c["live"], **c["mode"])
    if kind == "segment_select":
        if not hasattr(m, "segment_select"):
            return parent_chain(c, m)
        return lambda: m.segment_select(c["vals"], c["live"], c["p"],
                                        **c["mode"])
    if c["op"] == "bounds":
        part, peer = c["part_start"], c["peer_start"]
        if hasattr(m, "window_bounds"):
            return lambda: m.window_bounds(part, peer)
        return lambda: CS._four_scans(m, part, peer)
    args = (c["x"], c["op"], c["reverse"], c["seg"])
    return lambda: m.segmented_scan(*args)


def _device_us(fn) -> dict:
    """Device microseconds of each kernel and copy of one call of fn
    (torch.profiler), by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.events():
        if ev.device_type.name == "CUDA":
            name = ev.name[:60]
            out[name] = out.get(name, 0.0) + ev.time_range.elapsed_us()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", type=Path)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--only", default=",".join(KERNELS))
    ap.add_argument("--trace", action="store_true")
    opts = ap.parse_args()
    only = opts.only.split(",")
    if not set(only) <= set(KERNELS):
        ap.error(f"--only takes {','.join(KERNELS)}")
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    from presto_tpu_torch import native
    from presto_tpu_torch.connectors import TpcdsConnector, TpchConnector
    from presto_tpu_torch.exec.engine import LocalEngine
    from presto_tpu_torch.ops import aggregate as A
    from presto_tpu_torch.ops import join as J
    from presto_tpu_torch.ops import keys as K
    from presto_tpu_torch.ops import scan as S
    from presto_tpu_torch.ops import unnest as U
    from presto_tpu_torch.ops import window as W
    card = CS.card_line()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    built = native.build()
    oA, oJ, oS, oK, oW, oU, obuilt = other_modules(opts.other.resolve())
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    for tag, libs in (("this", built), ("other", obuilt)):
        for name in dict.fromkeys(LIBS[k] for k in only):
            for line in libs[name]["report"].splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {tag} {name}: {line.strip()}")
    conn = TpchConnector(CS.SF)
    rng = np.random.default_rng(CS.SEED)
    runs = []
    if "direct_agg" in only:
        da = CS.direct_agg_cases(rng, dev) + [
            CS.direct_agg_sum128_case(rng, dev)]
        runs.append(("direct_agg", da, CS.run_direct_agg_case, (oA, A)))
    if "join_probe" in only:
        runs.append(("join_probe", CS.join_probe_cases(conn, dev),
                     CS.run_join_probe_case, (oJ, J)))
    if "join_expand" in only:
        runs.append(("join_expand", CS.join_expand_cases(conn, dev),
                     CS.run_join_expand_case, (oJ, J)))
    if "segmented_scan" in only:
        ds_sql, _ = CS.tpcds_queries()
        q51 = CS.capture_windows(LocalEngine(TpcdsConnector(CS.TPCDS_SF)),
                                 ds_sql[51])
        runs.append(("segmented_scan", CS.seg_scan_cases(q51, conn, dev),
                     CS.run_scan_case, (oS, S)))
        del q51
    if "key_change_flags" in only:
        runs.append(("key_change_flags", CS.key_change_cases(conn, dev),
                     CS.run_key_change_case, (oK, K)))
    if "window_frame" in only:
        runs.append(("window_frame", CS.window_frame_cases(conn, dev),
                     CS.run_window_frame_case, (oW, W)))
    if "unnest_expand" in only:
        from presto_tpu_torch.connectors.tpch import nested_orders
        runs.append(("unnest_expand",
                     CS.unnest_expand_cases(nested_orders(CS.SF), dev),
                     CS.run_unnest_case, (oU, U)))
    if "hll_registers" in only:
        runs.append(("hll_registers", CS.hll_registers_cases(conn, dev),
                     CS.run_hll_case, (oA, A)))
    if "segment_select" in only:
        def run_select(c, repeat, m):
            if m is A:
                return CS.run_select_case(c, repeat)
            if hasattr(m, "segment_select"):
                return {}
            return run_parent_chain(c, repeat, m)
        runs.append(("segment_select", CS.segment_select_cases(conn, dev),
                     run_select, (oA, A)))
    rows = []
    for kind, cases, run, mods in runs:
        for c in cases:
            checked = [run(c, CS.REPEAT, m) for m in mods]
            other, this = [_calls(kind, c, m) for m in mods]
            t = [CS.cuda_time_ms(f, CS.REPEAT)
                 for f in (other, this, this, other)]
            row = {"kernel": kind, "case": c["case"],
                   "mode": checked[1].get("mode", checked[1].get("op")),
                   "other_ms": [t[0], t[3]], "this_ms": [t[1], t[2]],
                   "bound_ms": checked[1]["bound_ms"],
                   "plain_ms": checked[1]["plain_ms"],
                   "library_ms": checked[1].get("library_ms")}
            for key in ("scatter_ms", "fill_ms"):
                if key in checked[1]:
                    row[key] = checked[1][key]
            if opts.trace:
                row["other_us"], row["this_us"] = (_device_us(other),
                                                   _device_us(this))
            rows.append(row)
            print(json.dumps(row), flush=True)
    if opts.out:
        opts.out.parent.mkdir(parents=True, exist_ok=True)
        opts.out.write_text(json.dumps({"card": card, "rows": rows},
                                       indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
