"""Seconds each phase of a `chip_smoke.py` run took, from its log: every
phase line ends with `at_s`, the seconds since the script started, so a
phase took its at_s less the previous line's.  With two logs, the phases
are lined up by name and order and printed side by side with the
difference.

    python3 scripts/chip_phase_times.py run.log [other.log] [--top N]
"""
from __future__ import annotations

import argparse
import re
from collections import Counter

LINE = re.compile(r"^\[([a-z_0-9]+)\].*\bat_s=([0-9.]+)\s*$")


def phase_times(path: str) -> list:
    """[(tag#k, seconds, at_s)] in log order; tag#k is the k-th line of
    that tag."""
    out, seen, prev = [], Counter(), 0.0
    with open(path) as f:
        for line in f:
            m = LINE.match(line.rstrip("\n"))
            if not m:
                continue
            tag, at = m.group(1), float(m.group(2))
            seen[tag] += 1
            out.append((f"{tag}#{seen[tag]}", at - prev, at))
            prev = at
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("logs", nargs="+")
    ap.add_argument("--top", type=int, default=0,
                    help="print only the N phases that took longest "
                         "(with two logs: that moved most)")
    args = ap.parse_args(argv)
    runs = [phase_times(p) for p in args.logs[:2]]
    if len(runs) == 1:
        rows = runs[0]
        if args.top:
            rows = sorted(rows, key=lambda r: -r[1])[:args.top]
        for key, sec, at in rows:
            print(f"{key:32s} {sec:8.1f} {at:8.1f}")
        print(f"{'total':32s} {runs[0][-1][2] if runs[0] else 0.0:8.1f}")
        return
    a, b = ({k: s for k, s, _ in r} for r in runs)
    keys = [k for k, _, _ in runs[1]] + [k for k in a if k not in b]
    rows = [(k, a.get(k, 0.0), b.get(k, 0.0)) for k in keys]
    if args.top:
        rows = sorted(rows, key=lambda r: -abs(r[2] - r[1]))[:args.top]
    for k, x, y in rows:
        print(f"{k:32s} {x:8.1f} {y:8.1f} {y - x:+8.1f}")
    tot = [r[-1][2] if r else 0.0 for r in runs]
    print(f"{'total':32s} {tot[0]:8.1f} {tot[1]:8.1f} {tot[1] - tot[0]:+8.1f}")


if __name__ == "__main__":
    main()
