"""The tools that measure K1's precompile units, the round-witness splice,
the bit-sliced probes and the uniform-index probe P6 on the card, on the
CPU: every variant of
`tools/unit_variants.py` applies to this tree's sources (exactly one match
an edit),
`tools/k1_times.py`'s SASS readers count what they claim on a listing of
known content, its splice byte count adds up on a small clock, and P6's
sector count and floor do on known indices."""

import pathlib

import pytest

from era_zk_evm_tpu_torch.tools import k1_times, unit_variants

from test_torch_secp256k1 import one_intra_op_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]

SASS = """
	Function : _Z9k1_kernelILb1ELb1ELb0EEv6K1Args
        /*0000*/                   LDG.E R2, [R4.64] ;
        /*0010*/                   STL [R1], R2 ;
.L_x_7:
        /*0020*/                   LOP3.LUT R6, R2, R3, R4, 0x96, !PT ;
        /*0030*/                   SHF.L.W.U32.HI R7, R6, 0x1, R6 ;
        /*0040*/                   @P0 LDL R8, [R1+0x8] ;
        /*0050*/                   LDS R9, [R10] ;
        /*0060*/              @!P1 BRA `(.L_x_7) ;
        /*0070*/                   CALL.REL.NOINC 0x100 ;
	Function : _Z12units_kernel9UnitsArgs
        /*0000*/                   STS [R3], R2 ;
        /*0010*/                   STG.E [R4.64], R2 ;
"""


def _variant_edits(design, name, tmp_path):
    """The csrc/ files that variant `name` of `design` edits in a copy of
    this tree's sources (a variant whose text no longer occurs raises)."""
    src = tmp_path / "src"
    (src / "era_zk_evm_tpu_torch").mkdir(parents=True)
    for path in (ROOT / "era_zk_evm_tpu_torch" / "csrc").iterdir():
        dst = src / "era_zk_evm_tpu_torch" / "csrc" / path.name
        dst.parent.mkdir(exist_ok=True)
        dst.write_bytes(path.read_bytes())
    tree, = unit_variants.make_variants(src, tmp_path / "out", design, [name])
    before = (src / unit_variants.SOURCE).read_text()
    after = (tree / unit_variants.SOURCE).read_text()
    edited = [p.name for p in (tree / "era_zk_evm_tpu_torch/csrc").iterdir()
              if p.read_text() != (src / "era_zk_evm_tpu_torch/csrc"
                                   / p.name).read_text()]
    assert (after != before) == ("cycle_kernel.cu" in edited)
    return edited


@pytest.mark.parametrize("name", sorted(unit_variants.VARIANTS["new"]))
def test_unit_variant_applies_to_this_tree(name, tmp_path):
    # a variant whose text no longer occurs would raise: the tool tracks
    # the units' source
    assert _variant_edits("new", name, tmp_path)


@pytest.mark.parametrize("name", sorted(unit_variants.VARIANTS["splice"]))
def test_splice_variant_applies_to_this_tree(name, tmp_path):
    # the splice's design choices in pq_splice.cu; k1_all_rows in K1's
    # round-witness stores alone
    want = ["cycle_kernel.cu" if name == "k1_all_rows" else "pq_splice.cu"]
    assert _variant_edits("splice", name, tmp_path) == want


@pytest.mark.parametrize("name", sorted(unit_variants.VARIANTS["bitslice"]))
def test_bitslice_variant_applies_to_this_tree(name, tmp_path):
    # the bit-sliced probes' design choices, in probe_keccak.cu alone
    assert _variant_edits("bitslice", name, tmp_path) == ["probe_keccak.cu"]


@pytest.mark.parametrize("name,want", [
    (None, (4, 8)), ("warps1", (1, 8)), ("warps2", (2, 8)),
    ("trip2", (4, 2)), ("trip24", (4, 24)), ("minblocks5", (4, 8))])
def test_bitslice_design_reads_the_tree(name, want, tmp_path):
    # the warps a block and the rounds a trip as the tree's source (a
    # variant's edit) has them; none in a tree without the constants
    tree = ROOT
    if name is not None:
        src = tmp_path / "src" / "era_zk_evm_tpu_torch" / "csrc"
        src.mkdir(parents=True)
        for path in (ROOT / "era_zk_evm_tpu_torch" / "csrc").iterdir():
            (src / path.name).write_bytes(path.read_bytes())
        tree, = unit_variants.make_variants(tmp_path / "src", tmp_path / "out",
                                            "bitslice", [name])
    assert k1_times.bitslice_design(tree) == dict(
        zip(("warps_a_block", "trip"), want))
    bare = tmp_path / "bare" / "era_zk_evm_tpu_torch" / "csrc"
    bare.mkdir(parents=True)
    (bare / "probe_keccak.cu").write_text("constexpr int kP2Warps = 4;\n")
    assert k1_times.bitslice_design(tmp_path / "bare") == {}


@pytest.mark.parametrize("name", sorted(unit_variants.VARIANTS["perm"]))
def test_perm_variant_applies_to_this_tree(name, tmp_path):
    # the permutation's unrolls, in keccak.cuh alone
    assert _variant_edits("perm", name, tmp_path) == ["keccak.cuh"]


def test_sass_readers_count_a_known_listing():
    counts = k1_times.sass_counts(SASS)
    k1 = counts["_Z9k1_kernelILb1ELb1ELb0EEv6K1Args"]
    assert (k1["instructions"], k1["global_loads"], k1["local_stores"],
            k1["local_loads"], k1["shared_loads"], k1["calls"]) \
        == (8, 1, 1, 1, 1, 1)
    units = counts["_Z12units_kernel9UnitsArgs"]
    assert (units["instructions"], units["shared_stores"],
            units["global_stores"]) == (2, 1, 1)
    # the loop .L_x_7: LOP3, SHF, LDL, LDS, BRA; two logic, one local
    assert k1_times.sass_loops(SASS, "k1_kernel") == [(5, 2)]
    assert k1_times.sass_loops(SASS, "k1_kernel", local=True) == [(5, 2, 1)]
    assert k1_times.unit_round_sass(SASS) == {"kPrecomp": None, "kEc": None}


def _round_listing(function, rounds, logic, other, hoisted=False):
    """A cuobjdump listing of `function` whose only loop holds `rounds`
    keccak rounds of `logic` LOP3 / SHF and `other` MOVs each, every round
    with its round constant's load (before the loop where `hoisted`), then
    the branch back."""
    rc = "ULDC.64 UR8, c[0x3][0x180]"
    lines = [f"\tFunction : {function}",
             "        /*0000*/                   LDG.E R2, [R4.64] ;"]
    if hoisted:
        lines += [f"        /*0008*/                   {rc} ;"] * rounds
    lines.append(".L_x_3:")
    body = (["LOP3.LUT R6, R2, R3, R4, 0x96, !PT",
             "SHF.L.W.U32.HI R7, R6, 0x1, R6"] * (logic // 2)
            + ["MOV R8, R9"] * other
            + ([] if hoisted else ["LDC.64 R10, c[0x3][R0+0x180]"])) * rounds
    body.append("@P0 BRA `(.L_x_3)")
    lines += [f"        /*{16 * (i + 1):04x}*/                   {ins} ;"
              for i, ins in enumerate(body)]
    return "\n".join(lines) + "\n"


def test_sass_round_divides_a_loop_by_its_rounds():
    # K3 with all 24 rounds in its iters loop (their constants loaded
    # before it), the sponge with one round a trip, K2 with four; a
    # 64-bit load from another bank is no round constant
    sass = (_round_listing("_Z9k3_kernelPjiii", 24, 190, 6, hoisted=True)
            + _round_listing("_Z10k3s_kernelPKjPKlPKiPii", 1, 250, 150)
            + _round_listing("_Z9k2_kernelPKiS0_S0_S0_PiS1_ii", 4, 180, 10)
            .replace("MOV R8, R9", "LDC.64 R8, c[0x0][0x210]", 1))
    counts = k1_times.keccak_round_sass(sass)
    assert counts["k3_kernel"] == ((24 * 196 + 1) / 24, 190.0, 24)
    assert counts["k3s_kernel"] == (402.0, 250.0, 1)
    assert counts["k2_kernel"] == ((4 * 191 + 1) / 4, 180.0, 4)
    assert counts["units_kernel"] is None


def test_bitslice_round_sass_divides_by_the_trip():
    # P2's loop of two rounds: per round 120 LOP3, 4 SHF, 52 SHFL, 10
    # MOVs; P5 has no loop of 100 logic instructions; without a trip (a
    # tree before the warp-a-column design) nothing is read
    body = (["LOP3.LUT R6, R2, R3, R4, 0x96, !PT"] * 120
            + ["SHF.R.U32.HI R7, RZ, 0x1, R6"] * 4
            + ["SHFL.IDX PT, R8, R9, R10, 0x1f"] * 52
            + ["MOV R8, R9"] * 10) * 2 + ["@P0 BRA `(.L_x_5)"]
    sass = ("\tFunction : _Z9p2_kernelILb0EEvPjii\n.L_x_5:\n"
            + "".join(f"        /*{16 * i:04x}*/                   {ins} ;\n"
                      for i, ins in enumerate(body))
            + "\tFunction : _Z9p2_kernelILb1EEvPjii\n"
            "        /*0000*/                   LOP3.LUT R6, R2, R3, R4, "
            "0x96, !PT ;\n")
    got = k1_times.bitslice_round_sass(sass, 2)
    assert got["P2"] == {"all": 186.5, "logic": 124.0, "LOP3": 120.0,
                         "SHF": 4.0, "SHFL": 52.0, "LDS": 0.0, "STS": 0.0}
    assert got["P5"] is None
    assert k1_times.bitslice_round_sass(sass, None) == {"P2": None,
                                                        "P5": None}


def test_load_overlap_reads_loads_in_flight():
    # P6's loop as cuobjdump lists it: four strong loads, then the sums;
    # the chain's loop: each load's address from the load before
    sass = "\n".join([
        "\tFunction : _Z9p6_kernelPKjS0_Pjiiiii",
        *(f"        /*{16 * i:04x}*/                   {t} ;" for i, t in
          enumerate(["LDG.E.STRONG.SYS R13, desc[UR4][R6.64]",
                     "LDG.E.STRONG.SYS R14, desc[UR4][R6.64]",
                     "LDG.E.STRONG.SYS R16, desc[UR4][R6.64]",
                     "LDG.E.STRONG.SYS R15, desc[UR4][R6.64]",
                     "VIADD R8, R8, 0xfffffffc",
                     "IADD3 R13, R14, R13, R0",
                     "IADD3 R0, R15, R16, R13",
                     "@P2 BRA 0x0"])),
        "\tFunction : _Z10p6c_kernelPKjS0_Pjii",
        *(f"        /*{16 * i:04x}*/                   {t} ;" for i, t in
          enumerate(["IMAD.WIDE.U32 R8, R5, 0x4, R6",
                     "LDG.E.STRONG.SYS R9, desc[UR4][R8.64]",
                     "IMAD.WIDE.U32 R10, R9, 0x4, R6",
                     "LDG.E.STRONG.SYS R5, desc[UR4][R10.64]",
                     "@P1 BRA 0x0"]))]) + "\n"
    assert k1_times.load_overlap_sass(sass, "p6_kernel") == {
        "load_opcodes": ["LDG.E.STRONG.SYS"], "loads_a_trip": 4,
        "in_flight": 4, "instructions_a_trip": 8}
    assert k1_times.load_overlap_sass(sass, "p6c_kernel")["in_flight"] == 1
    assert k1_times.load_overlap_sass(None, "p6_kernel") is None


def test_load_overlap_reads_weak_loads():
    # the weak-load design's loop: each of 16 loads' address formed by one
    # IMAD.WIDE from its opaque offset, the 16 weak LDG.E issued before the
    # first sum, then the base moved on by the trip's step
    body = []
    for j in range(16):
        body += [f"IMAD.WIDE.U32 R{40 + 2 * j}, R{20 + j}, 0x4, R2",
                 f"LDG.E R{4 + j}, desc[UR4][R{40 + 2 * j}.64]"]
    body += [f"IADD3 R0, R{4 + 2 * j}, R{5 + 2 * j}, R0" for j in range(8)]
    body += ["IADD3 R2, P0, R2, R3, RZ", "IADD3.X R3, RZ, R3, RZ, P0, !PT",
             "@P1 BRA 0x0"]
    sass = "\n".join(
        ["\tFunction : _Z9p6_kernelPKjS0_Pjiiiiij"]
        + [f"        /*{16 * i:04x}*/                   {t} ;"
           for i, t in enumerate(body)]) + "\n"
    assert k1_times.load_overlap_sass(sass, "p6_kernel") == {
        "load_opcodes": ["LDG.E"], "loads_a_trip": 16, "in_flight": 16,
        "instructions_a_trip": 43}


@pytest.mark.parametrize("name", sorted(unit_variants.VARIANTS["uniform"]))
def test_uniform_variant_applies_to_this_tree(name, tmp_path):
    # P6's design choices, in probe_uniform.cu alone
    assert _variant_edits("uniform", name, tmp_path) == ["probe_uniform.cu"]


@pytest.mark.parametrize("name,want", [
    (None, ("ld.global", 16, "true", False)),
    ("strong", ("ld.volatile.global", 16, "true", False)),
    ("relaxed_same", ("ld.relaxed.cta.global", 16, "false", False)),
    ("inflight8", ("ld.global", 8, "true", False)),
    ("same_address", ("ld.global", 16, "false", False)),
    ("staged", ("ld.global", 16, "true", True))])
def test_uniform_design_reads_the_tree(name, want, tmp_path):
    # the load design as the tree's source (a variant's edit) has it; none
    # in a tree before the weak-load design
    tree = ROOT
    if name is not None:
        src = tmp_path / "src" / "era_zk_evm_tpu_torch" / "csrc"
        src.mkdir(parents=True)
        for path in (ROOT / "era_zk_evm_tpu_torch" / "csrc").iterdir():
            (src / path.name).write_bytes(path.read_bytes())
        tree, = unit_variants.make_variants(tmp_path / "src", tmp_path / "out",
                                            "uniform", [name])
    assert k1_times.uniform_design(tree) == dict(
        zip(("load", "in_flight", "offset", "staged"), want))
    bare = tmp_path / "bare" / "era_zk_evm_tpu_torch" / "csrc"
    bare.mkdir(parents=True)
    (bare / "probe_uniform.cu").write_text("constexpr int kP6InFlight = 16;\n")
    assert k1_times.uniform_design(tmp_path / "bare") == {}


def test_p6_sectors_count_each_warp_load():
    import torch

    # 40 lanes: a warp of 32 and one of 8; W = 64, TB = 40
    uniform = torch.full((40,), 5, dtype=torch.int32)
    # batch-last, one index: a warp's 32 words are 128 contiguous bytes
    # (4 sectors, less where the row's start is not 32-byte aligned), the
    # 8 lanes' one sector or two; 8 k
    rows = [((k * 64 + 5) * 40 * 4) for k in range(8)]
    want = sum(len({(r + 4 * t) // 32 for t in range(0, 32)})
               + len({(r + 4 * t) // 32 for t in range(32, 40)})
               for r in rows)
    assert k1_times.p6_sectors(uniform, 64, 40, "batch_last") == want
    # lane-major: lanes 8 x 64 words apart, a sector a lane
    assert k1_times.p6_sectors(uniform, 64, 40, "lane_major") == 8 * 40
    # K1's lane-major words: 8 limb loads of a sector a lane; as v4, 2
    assert k1_times.p6_sectors(uniform, 64, 40, "lane_words") == 8 * 40
    assert k1_times.p6_sectors(uniform, 64, 40, "lane_words_v4") == 2 * 40
    # an index past the arena loads nothing
    dead = uniform.clone()
    dead[32:] = 64
    assert k1_times.p6_sectors(dead, 64, 40, "lane_major") == 8 * 32


def test_p6_floor_at_the_tools_shapes():
    import torch

    # TB = 32768, the tool's index, batch-last: one line a warp load, 8 x
    # 1024 warp loads a repetition, 512 repetitions through 132 L1s at 128
    # bytes a clock, 1980 MHz: 16.05 us; a sector a lane: 8 x that
    idx = torch.full((32768,), 37, dtype=torch.int32)
    line = k1_times.p6_sectors(idx, 256, 32768, "batch_last")
    assert line == 8 * 1024 * 4
    assert k1_times.p6_floor_ms(line, 512, 32768, 1980) \
        == pytest.approx(0.016047, rel=1e-3)
    scattered = k1_times.p6_sectors(idx, 256, 32768, "lane_major")
    assert scattered == 8 * line
    assert k1_times.p6_floor_ms(scattered, 512, 32768, 1980) \
        == pytest.approx(0.12838, rel=1e-3)
    # TB = 256: 0.125 us, above the compulsory bytes' 0.0052 us
    small = torch.full((256,), 37, dtype=torch.int32)
    assert k1_times.p6_floor_ms(k1_times.p6_sectors(
        small, 256, 256, "batch_last"), 512, 256, 1980) \
        == pytest.approx(1.254e-4, rel=1e-3)
    # one repetition: the compulsory bytes, 17 words a lane, set it
    assert k1_times.p6_floor_ms(line, 1, 32768, 1980) \
        == pytest.approx(4 * 17 * 32768 / 3.35e9)


def test_splice_bytes_counts_a_small_clock():
    # 3 cycles, 2 lanes, PS = 2: cycles 0 and 2 flagged, cycle 1 shares
    # cycle 2's base; lane 0 keeps 2 rows of cycle 0, lane 1 its 3 slots of
    # cycle 2 (at most PS: 2); the blocks cover rows 0 .. 3 of each lane
    import torch

    emit = torch.tensor([[1 | 1 << 16, 0], [0, 0], [0, 2 | 1 << 16]],
                        dtype=torch.int32)
    nslots = torch.tensor([[2, 0], [0, 0], [0, 3]], dtype=torch.int32)
    reads, written, scalars = 2 + 2, 4 * 2, 2 * 2 * (4 + 4 + 1)
    assert k1_times.splice_bytes(emit, nslots, 2, 10, 0) \
        == 2 * emit.numel() * 4 + (reads + written) * 13 * 4 + scalars
    # the clock past the capacity: every block at cap - PS, none kept
    assert k1_times.splice_bytes(emit, nslots, 2, 10, 5) \
        == 2 * emit.numel() * 4 + 2 * 2 * 13 * 4 + scalars
