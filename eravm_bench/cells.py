"""A cell of `BENCHMARK.json`, found by name, and the one general generator
of its inputs.

A cell names a configuration (`configs/<name>.json`: the engine's geometry
under `vm`) and a traffic mix (`traffic/<name>.json`: its programs as
assembled code words with their source text, the seeded draws that patch
words of each lane's program, the ergs each lane starts with, the
configuration keys the mix turns on under `families`, and the call's shape
under `call`).  Each of the two files may name, under `judge`, the numbers
that decide `correct` (`checks/<name>.py`); a cell compares the union.
`lane_programs` makes every lane's code words from the seed and nothing
else; a later cell adds files, not code.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np

PKG = pathlib.Path(__file__).resolve().parent
ROOT = PKG.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict           # configs/<name>.json
    traffic: dict          # traffic/<name>.json
    per_layer: list        # the per-layer metrics this cell reports

    @property
    def vm(self) -> dict:
        """The engine's geometry as the cell runs it: the configuration's
        `vm` with the mix's families turned on."""
        return {**self.config["vm"], **self.traffic.get("families", {})}

    @property
    def judge(self) -> list[str]:
        """The numbers compared (`checks/<name>.py`), as the configuration
        and the mix name them."""
        names = self.config.get("judge", []) + self.traffic.get("judge", [])
        return list(dict.fromkeys(names))

    @property
    def capture(self) -> bool:
        """Whether the memory queue is captured (and rewound each call)."""
        return self.vm.get("queue_capacity", 0) > 0

    @property
    def rolling(self) -> bool:
        return bool(self.vm.get("rolling_commitment", False))


def load_cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell `name` of `root/BENCHMARK.json`, with its files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: "
                         f"{sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads(
        (PKG / "traffic" / f"{cell['traffic']}.json").read_text())
    return Cell(name=name, chips=cell["chips"], config=config,
                traffic=traffic,
                per_layer=[m for m in bench["per_layer"]
                           if "workloads" not in m
                           or name in m["workloads"]])


def draw(rng: np.random.Generator, spec: dict, size) -> np.ndarray:
    """Whole numbers from one named draw of a mix: `lognormal_int` {mean,
    sigma, clip: [lo, hi]}, the lognormal's parameters of the log, clipped,
    then truncated."""
    if "lognormal_int" not in spec:
        raise ValueError(f"unknown draw {sorted(spec)}")
    s = spec["lognormal_int"]
    lo, hi = s["clip"]
    return np.clip(rng.lognormal(s["mean"], s["sigma"], size=size),
                   lo, hi).astype(np.int64)


def program_counts(weights: list, batch: int) -> np.ndarray:
    """Lanes a program: each program's share of the batch by its weight,
    rounded so that the counts add up to the batch (largest remainders
    first), so that every seed runs the same mix."""
    w = np.asarray(weights, dtype=np.float64)
    exact = w / w.sum() * batch
    counts = np.floor(exact).astype(np.int64)
    rest = np.argsort(-(exact - counts), kind="stable")[:batch - counts.sum()]
    counts[rest] += 1
    return counts


def lane_programs(traffic: dict, batch: int, seed: int) -> list[list[int]]:
    """Every lane's code words, from the seed alone: the programs' lanes in
    their exact shares (`program_counts`), in an order drawn from the seed;
    then each of a program's `draws` fills `words` code words from
    `first_word` on with values of its named draw, one a word."""
    rng = np.random.default_rng(seed)
    programs = traffic["programs"]
    counts = program_counts([p["weight"] for p in programs], batch)
    pick = rng.permutation(np.repeat(np.arange(len(programs)), counts))
    width = {}
    for p in programs:
        for patch in p.get("draws", []):
            width[patch["draw"]] = max(width.get(patch["draw"], 0),
                                       patch["words"])
    values = {name: draw(rng, traffic["draws"][name], (batch, n))
              for name, n in sorted(width.items())}
    words = [[int(w, 16) for w in p["words"]] for p in programs]
    out = []
    for b in range(batch):
        prog = programs[pick[b]]
        lane = list(words[pick[b]])
        for patch in prog.get("draws", []):
            first, n = patch["first_word"], patch["words"]
            lane[first:first + n] = values[patch["draw"]][b, :n].tolist()
        out.append(lane)
    return out


def judged_lanes(batch: int, seed: int, n: int) -> list[int]:
    """The lanes the reference judges: the first, the last, and the rest
    drawn from the seed."""
    rng = np.random.default_rng([seed, 1])
    rest = rng.choice(np.arange(1, batch - 1), size=max(0, min(n, batch) - 2),
                      replace=False) if batch > 2 else []
    return sorted({0, batch - 1, *map(int, rest)})
