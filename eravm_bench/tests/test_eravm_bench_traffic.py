"""The traffic mixes: each file's code words are its source text as the
port's assembler assembles it, and the generator makes every lane's program
from the seed alone."""

import json

import pytest

from eravm_bench import cells
from era_zk_evm_tpu_torch.isa.assembler import assemble_to_code_words

MIXES = sorted(p.stem for p in (cells.PKG / "traffic").glob("*.json"))


def load(name):
    return json.loads((cells.PKG / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("mix", MIXES)
def test_words_are_the_source_assembled(mix):
    for prog in load(mix)["programs"]:
        words = assemble_to_code_words("\n".join(prog["source_text"]))
        assert [int(w, 16) for w in prog["words"]] == words


def program_of(t, lane):
    """The index of the mix's program a lane runs: its words but the drawn
    ones."""
    for i, prog in enumerate(t["programs"]):
        words = [int(w, 16) for w in prog["words"]]
        drawn = {k for p in prog["draws"]
                 for k in range(p["first_word"], p["first_word"] + p["words"])}
        if len(lane) == len(words) and all(
                lane[k] == words[k] for k in range(len(words))
                if k not in drawn):
            return i
    raise AssertionError("a lane runs no program of the mix")


@pytest.mark.parametrize("mix", MIXES)
def test_lane_programs_follow_the_seed(mix):
    t = load(mix)
    a = cells.lane_programs(t, 64, 2**31 + 5)
    assert a == cells.lane_programs(t, 64, 2**31 + 5)
    assert a != cells.lane_programs(t, 64, 2**31 + 6)
    want = cells.program_counts([p["weight"] for p in t["programs"]], 64)
    # every seed runs each program on the same number of lanes
    for seed in (2**31 + 5, 3, 2**33 + 1):
        lanes = cells.lane_programs(t, 64, seed)
        picks = [program_of(t, lane) for lane in lanes]
        assert [picks.count(i) for i in range(len(t["programs"]))] \
            == want.tolist()
    for lane in a:
        prog = t["programs"][program_of(t, lane)]
        for patch in prog["draws"]:
            lo, hi = t["draws"][patch["draw"]]["lognormal_int"]["clip"]
            first, n = patch["first_word"], patch["words"]
            assert all(lo <= v <= hi for v in lane[first:first + n])


def test_program_counts_are_exact():
    assert cells.program_counts([1, 1, 1, 1, 1], 32768).tolist() == \
        [6554, 6554, 6554, 6553, 6553]
    assert cells.program_counts([3, 1], 4).tolist() == [3, 1]


def test_lognormal_draw_stays_in_its_clip():
    import numpy as np

    v = cells.draw(np.random.default_rng(1),
                   {"lognormal_int": {"mean": 5.5, "sigma": 1.0,
                                      "clip": [100, 6000]}}, (1000, 16))
    assert v.shape == (1000, 16) and v.min() >= 100 and v.max() <= 6000
    assert 220 < np.median(v) < 270           # e ** 5.5 = 244.7


def test_judged_lanes():
    lanes = cells.judged_lanes(32768, 2**31 + 5, 32)
    assert len(lanes) == 32 and lanes[0] == 0 and lanes[-1] == 32767
    assert lanes == cells.judged_lanes(32768, 2**31 + 5, 32)
    assert cells.judged_lanes(4, 1, 32) == [0, 1, 2, 3]
