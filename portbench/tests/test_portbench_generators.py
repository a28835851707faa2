"""The traffic generators: the same bytes from the same seed, the same sizes
for every seed, and planted strings that their patterns match."""

import re
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import manifest, textgen  # noqa: E402

prosite = manifest.load_module("syntax", "prosite")

CELLS = ("prosite17-shards",)
TINY = {"docs_per_call": 6, "min_bytes": 3000, "max_bytes": 9000, "pool": 3,
        "boundary_stride": 1024}


def _pool(name, seed, **mix):
    cell = manifest.resolve(name)
    mix = {**cell.mix, **TINY, **mix}
    gen = manifest.load_module("generators", mix["generator"])
    return cell, gen.make_pool(cell.config, mix, seed)


@pytest.mark.parametrize("name", CELLS)
def test_same_seed_same_bytes(name):
    _, a = _pool(name, 2**31 + 5)
    _, b = _pool(name, 2**31 + 5)
    _, c = _pool(name, 2**31 + 6)
    assert a == b
    assert a != c


@pytest.mark.parametrize("name", CELLS)
def test_every_seed_gets_the_same_sizes(name):
    sizes = [sorted(len(d) for d in entry)
             for seed in (0, 1, 2**31 + 9) for entry in _pool(name, seed)[1]]
    assert all(s == sizes[0] for s in sizes)
    assert len(set(len(d) for d in _pool(name, 3)[1][0])) == TINY["docs_per_call"]


def test_stratified_lengths_cover_the_range():
    rng = np.random.default_rng(0)
    got = np.sort(textgen.stratified_lengths(rng, 64, 131072, 1048576))
    assert got[0] > 131072 and got[-1] < 1048576
    assert abs(got.mean() - (131072 + 1048576) / 2) < 1


def test_prosite_instances_match_their_motif():
    cell = manifest.resolve("prosite17-shards")
    regexes = manifest.regexes(cell.config)
    rng = np.random.default_rng(7)
    for name, text in cell.config["patterns"].items():
        rx = re.compile(regexes[name].encode(), re.DOTALL)
        for _ in range(20):
            inst = prosite.instance(rng, text, cell.mix["residues"].encode())
            assert rx.fullmatch(inst), (name, inst)
            assert set(inst.rstrip(b"\n")) <= set(cell.mix["residues"].encode())


@pytest.mark.parametrize("text, regex", [
    ("N-{P}-[ST]-{P}", "N[A-OQ-Z][ST][A-OQ-Z]"),
    ("[RK](2)-x-[ST]", "[KR]{2}[A-Z][ST]"),
    ("[RK]-x(2,3)-[DE]", "[KR][A-Z]{2,3}[DE]"),
    ("[STAGCN]-[RKH]-[LIVMAFY]>", "[ACGNST][HKR][AFILMVY]\\n"),
    ("R-G-D.", "RGD"),
    ("{DERK}(6)-C", "[A-CF-JL-QS-Z]{6}C"),
])
def test_prosite_regex_texts(text, regex):
    assert prosite.to_regex(text) == regex


def test_prosite_motifs_never_span_two_sequences():
    """Negated classes and x take letters only; '>' is the sequence's end."""
    neg = re.compile(prosite.to_regex("N-{P}-[ST]-{P}").encode())
    assert neg.search(b"NAST") and not neg.search(b"NA\nST") and not neg.search(b"NAS\n")
    anyx = re.compile(prosite.to_regex("R-x-D").encode())
    assert anyx.search(b"RKD") and not anyx.search(b"R\nD")
    cterm = re.compile(prosite.to_regex("[ST]-[RK]-L>").encode())
    assert cterm.search(b"AASKL\nMM") and not cterm.search(b"AASKLM\n")
    with pytest.raises(ValueError):
        prosite.parse("<M-x-K")


def test_protein_shards_end_every_sequence_with_a_newline():
    cell, pool = _pool("prosite17-shards", 2**31 + 17)
    for docs in pool:
        for shard in docs:
            assert shard.endswith(b"\n") and b"\n\n" not in shard


def test_residue_table_follows_the_composition():
    gen = manifest.load_module("generators", "protein_shards")
    mix = manifest.resolve("prosite17-shards").mix
    table = gen.residue_table(mix)
    p = np.asarray(mix["composition"]) / sum(mix["composition"])
    got = np.array([(table == c).mean() for c in mix["residues"].encode()])
    assert np.abs(got - p).max() < 2 / 65536


def test_protein_shards_hold_sequences_joined_by_newlines():
    cell, pool = _pool("prosite17-shards", 11, min_bytes=200_000,
                       max_bytes=200_001, docs_per_call=1, pool=1)
    shard = pool[0][0]
    lengths = [len(s) for s in shard.split(b"\n")[1:-1]]
    assert 300 < np.mean(lengths) < 420
    assert set(shard) <= set(cell.mix["residues"].encode() + b"\n")


def test_boundary_plant_straddles_a_multiple_of_the_stride():
    rng = np.random.default_rng(3)
    for _ in range(50):
        buf = np.zeros(5000, np.uint8)
        assert textgen.plant_across_boundary(rng, buf, b"abcdef", 1024)
        where = np.flatnonzero(buf)
        lo, hi = int(where[0]), int(where[-1])
        assert hi - lo == 5
        assert lo // 1024 != hi // 1024
    assert not textgen.plant_across_boundary(rng, np.zeros(1000, np.uint8),
                                             b"abc", 1024)
