#!/usr/bin/env python3
"""K1 direct_agg and K5 join_probe against another checkout's kernels, in
one process on one GPU.

    python3 kernel_ab.py OTHER [--out ab.json]

OTHER is the root of another checkout of this repository (for example the
parent commit, unpacked with `git archive`). Its presto_tpu_torch/native.py,
ops/aggregate.py and ops/join.py are loaded under other module names, so
that their wrappers launch OTHER's kernels, built by OTHER's native.py from
OTHER's csrc/ into OTHER's build directory. chip_smoke.py's phase-3 shapes
of both kernels (direct_agg_cases, direct_agg_sum128_case, join_probe_cases;
TPC-H SF1 for the join's) are built once; each is held against its plain
version and between two launches under both checkouts (run_direct_agg_case,
run_join_probe_case, which also time the plain versions and library calls),
then timed with CUDA events (chip_smoke.cuda_time_ms, chip_smoke.REPEAT
calls) in turns: OTHER, this checkout, this checkout, OTHER. Prints per case
the four times and writes them, with the card's name and power limit, as
JSON to --out. Fails where there is no CUDA device.
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
    """(aggregate, join) of the checkout at `root`, whose wrappers load
    their kernels through that checkout's native.py."""
    import presto_tpu_torch
    pkg = root / "presto_tpu_torch"
    native = _load(pkg / "native.py", "other_native")
    agg = _load(pkg / "ops" / "aggregate.py", "other_aggregate")
    join = _load(pkg / "ops" / "join.py", "other_join")

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
        def call(*args):
            with own_native():
                return fn(*args)
        return call

    A = types.SimpleNamespace(
        direct_agg=wrap(agg.direct_agg),
        _direct_agg_plain=agg._direct_agg_plain, WANT_SUM=agg.WANT_SUM,
        WANT_MINMAX=agg.WANT_MINMAX, WANT_SUM128=agg.WANT_SUM128)
    J = types.SimpleNamespace(join_probe=wrap(join.join_probe),
                              _join_probe_plain=join._join_probe_plain)
    built = native.build(["direct_agg", "join"])
    return A, J, built


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", type=Path)
    ap.add_argument("--out", type=Path)
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    from presto_tpu_torch import native
    from presto_tpu_torch.connectors import TpchConnector
    from presto_tpu_torch.ops import aggregate as A
    from presto_tpu_torch.ops import join as J
    card = CS.card_line()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    built = native.build()
    oA, oJ, obuilt = other_modules(opts.other.resolve())
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    for tag, libs in (("this", built), ("other", obuilt)):
        for name in ("direct_agg", "join"):
            for line in libs[name]["report"].splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {tag} {name}: {line.strip()}")
    conn = TpchConnector(CS.SF)
    rng = np.random.default_rng(CS.SEED)
    da = CS.direct_agg_cases(rng, dev) + [CS.direct_agg_sum128_case(rng,
                                                                    dev)]
    jp = CS.join_probe_cases(conn, dev)
    rows = []
    for kind, cases, run, mods in (
            ("direct_agg", da, CS.run_direct_agg_case, (oA, A)),
            ("join_probe", jp, CS.run_join_probe_case, (oJ, J))):
        for c in cases:
            checked = [run(c, CS.REPEAT, m) for m in mods]
            if kind == "direct_agg":
                args = (c["cap"], c["num_rows"], c["keys"], c["domains"],
                        c["inputs"], c["mask"])
                fns = [lambda m=m: m.direct_agg(*args) for m in mods]
            else:
                args = (c["ph"], c["bh_sorted"], c["order"], c["pvals"],
                        c["bvals"], c["mode"])
                fns = [lambda m=m: m.join_probe(*args) for m in mods]
            other, this = fns
            t = [CS.cuda_time_ms(f, CS.REPEAT)
                 for f in (other, this, this, other)]
            row = {"kernel": kind, "case": c["case"],
                   "mode": checked[1].get("mode"),
                   "other_ms": [t[0], t[3]], "this_ms": [t[1], t[2]],
                   "bound_ms": checked[1]["bound_ms"],
                   "plain_ms": checked[1]["plain_ms"],
                   "library_ms": checked[1]["library_ms"]}
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
