"""Two checkouts' ``chip_smoke.py`` on one card, in turns, side by side.

    git archive <base-revision> | tar -x -C build/base   # on a git checkout
    python3 -m tpuseg_torch.tools.smoke_ab --base build/base [--out DIR]

Runs the smoke of ``--base`` (another checkout of the repository, for
example the parent commit unpacked under the ignored ``build/``) and of this
checkout in the order base, this, this, base, each in its own process from
the root of its tree, with each run's output in ``--out``. Then prints, for
every ``[12 timing]`` line of the smokes (kernels, their launch alone,
forwards, training steps), the base's and this tree's numbers and the two
means. Exits non-zero if a smoke failed. Needs the card that the smoke
needs; two calls land on different cards, so compare two versions only
inside one run of this script.
"""
from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
ORDER = ("base", "this", "this", "base")
# "<name>: kernel 0.1 ms" (kernels) or "<name>: kernels 50 img/s (20 ms)"
# (forwards, training steps): the first time in ms after the name
TIMING = re.compile(r"\[12 timing\] (?:YOLACT\+\+ )?(.*?): kernels? "
                    r"(?:[\d.]+ (?:img|it)/s )?\(?([\d.]+) ms")
ALONE = re.compile(r"the kernel launch alone ([\d.]+) ms")


def timings(log: str) -> dict:
    """{name: ms} of a smoke's [12 timing] lines; a NMS line's launch alone
    as '<name> (launch alone)'."""
    out = {}
    for line in log.splitlines():
        m = TIMING.match(line)
        if not m:
            continue
        out[m.group(1)] = float(m.group(2))
        alone = ALONE.search(line)
        if alone:
            out[m.group(1) + " (launch alone)"] = float(alone.group(1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--base", required=True, type=Path)
    ap.add_argument("--out", default=ROOT / "chiprun_out" / "smoke_ab",
                    type=Path)
    args = ap.parse_args(argv)
    trees = {"base": args.base.resolve(), "this": ROOT}
    args.out.mkdir(parents=True, exist_ok=True)
    runs, failed = [], []
    for i, name in enumerate(ORDER, 1):
        proc = subprocess.run([sys.executable, "chip_smoke.py"],
                              cwd=trees[name], capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        (args.out / f"{i}_{name}.log").write_text(log)
        print(f"run {i} ({name}, {trees[name]}): rc {proc.returncode}, "
              f"{log.strip().splitlines()[-1][:200] if log.strip() else ''}",
              flush=True)
        if proc.returncode:
            failed.append(i)
        runs.append((name, timings(proc.stdout)))
    names = list(dict.fromkeys(k for _, t in runs for k in t))
    print("ms per call: base runs 1, 4 | this runs 2, 3 | means base, this")
    for key in names:
        got = {n: [t[key] for m, t in runs if m == n and key in t]
               for n in ("base", "this")}
        mean = {n: (f"{sum(v) / len(v):.4f}" if v else "-")
                for n, v in got.items()}
        print(f"{key}: " + " | ".join(
            " ".join(f"{x:.4f}" for x in got[n]) or "-" for n in got)
            + f" | {mean['base']} {mean['this']}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
