"""The CUDA kernels of shark_tpu_torch against their plain versions, on a
card. Marked `cuda`; without a CUDA device every test skips.

chip_smoke.py holds each kernel against its plain version at the main
paths' shapes. These tests cover the modes those paths do not reach: the
entry8 table, the extension-row geometry, the finish's global-scratch key
buffer for wide geometries, every group tier, reads on both sides of the
finish's warp cap (its warp path and its block path in one batch), k and
Bloom-size variants of the front end (with a window count that is not a
multiple of a warp, all-N reads, one read, rows that are not 16-byte
aligned, reads over 16384 bases) and of the classic and xl probes, the xl
geometries with and without a side table, xl windows in flat views that
are ragged or unaligned and windows that all need the side table, the
pair stream at W = 31, one row, no emitted row, out_len below and above
the pair count, unaligned verdicts and the sentinel collision at
B = 65536, reads shorter than k, the hashed probe on windows planted at
its stash rows (and beside them, invalid, and colliding in the kernel's
stash table), on hand-made entry16 4-slot and entry8 tables with up to
200 stash rows and repeated positions, and with a stash of padding rows
only, the sharded Bloom filter's routing kernels at n in {1, 2, 8}
shards, narrow and wide, with and without overflow (and reprobe from
another thread on another stream), the router at its edges (one window,
under one tile, one tile, a count no multiple of the tile, n in {1, 2, 8,
64, 1024}, every window owned by one shard, an all-tail cap, a cap of 8,
every window invalid, wide, words at every shard boundary for divisors
of every size) and 50 repeated calls giving the same bytes,
the owner probe on hand-made slots (an owner that received nothing,
ranks past the pay rows), the return on the owner probe's replies in
place and copied (window counts 0-3 mod 4 and under 4, no slot,
overflow, one shard, one window, owner and slot off a 16-byte boundary),
a sharded step's launches and its in-place return, the classic probe
with a pay row 0 whose second word is not 0 (the payload of every
miss), whole
pipelines on random workloads (one with a 17000-base read), and the two
experiment kernels (P1, P2) at small, mid and default sizes, P1 at a row
count that is not a power of two, P2 with every bucket matching, every
probe invalid and unaligned inputs, their refusals and their stream, the
replicated index over [cuda:0, cuda:0] on the hashed, xl and classic
layouts, and --backend native on a card machine (no launch).
Inputs are made with numpy from seeds; results must be equal, bit for
bit.

On a machine with a card (and without jax, which tests/conftest.py
imports), run:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from shark_tpu_torch.classify import hashed, step
from shark_tpu_torch.classify.step import Classifier
from shark_tpu_torch.config import SharkConfig
from shark_tpu_torch.experiments import gather_tiles, resident_match
from shark_tpu_torch.index.build import build_index
from shark_tpu_torch.ops.kmers import encode_bytes
from shark_tpu_torch.parallel import sharded_bf
from shark_tpu_torch.parallel.sharded_bf import ShardedBFClassifier
from shark_tpu_torch.pipeline import run_pipeline
from test_torch_return_layout import CASES as RETURN_CASES
from test_torch_return_layout import return_inputs

pytestmark = pytest.mark.cuda

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from shark_tpu_torch import kernels

    kernels.lib()  # builds the kernels; a failed build fails the tests
    return torch.device("cuda", 0)


def equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.cpu(), w.cpu())


def family_index(members=5, n_fam=8, singles=0, size_bits=1 << 26, seed=77,
                 flank=100, single_len=400):
    """Families of `members` genes sharing a 150 bp core between their own
    flanks, plus `singles` unrelated genes."""
    rng = np.random.default_rng(seed)
    records = []
    for fam in range(n_fam):
        core = BASES[rng.integers(0, 4, size=150)]
        for m in range(members):
            seq = np.concatenate([BASES[rng.integers(0, 4, size=flank)], core,
                                  BASES[rng.integers(0, 4, size=flank)]])
            records.append((f"F{fam}M{m}", seq.tobytes()))
    for g in range(singles):
        records.append(
            (f"S{g}", BASES[rng.integers(0, 4, size=single_len)].tobytes()))
    return records, build_index(records, 15, size_bits)


def reads_from(rng, records, n, lo, hi, length=90):
    out = []
    for _ in range(n):
        _, seq = records[rng.integers(0, len(records))]
        start = int(rng.integers(lo, min(hi, len(seq) - length)))
        out.append(seq[start:start + length])
    return out


def encode(reads, L=96):
    codes = np.full((len(reads), L), 4, np.uint8)
    for i, r in enumerate(reads):
        codes[i, :len(r)] = encode_bytes(r)
    return codes


def classify_both(cuda, index, codes, max_winners=8):
    gpu = Classifier(index, max_winners=max_winners, device=cuda)
    cpu = Classifier(index, max_winners=max_winners, device="cpu")
    equal(gpu(codes), cpu(codes))
    return cpu(codes)


class _Meta:
    def __init__(self, k, size_bits):
        self.k = k
        self.size_bits = size_bits


@pytest.mark.parametrize("size_bits", [1 << 30, 1 << 33, 3 << 33])
@pytest.mark.parametrize("k,L", [(11, 8), (15, 104), (17, 208), (31, 256),
                                 (17, 136)])
def test_front_end_kernel(cuda, k, L, size_bits):
    """L = 136 gives Ls = 120 windows, not a multiple of a warp."""
    rng = np.random.default_rng(k * L)
    codes = rng.integers(0, 5, size=(300, L)).astype(np.uint8)
    packed, vmask = step.pack_codes(torch.from_numpy(codes).to(cuda))
    meta = _Meta(k, size_bits)
    equal(step.front_end(packed, vmask, meta),
          step.front_end_plain(packed, vmask, meta))


@pytest.mark.parametrize("case", ["all_n", "shorter_than_k", "one_read",
                                  "odd_batch", "unaligned", "long",
                                  "longest"])
def test_front_end_kernel_edges(cuda, case):
    """Every window is compared, invalid ones included: reads that are all
    N, reads shorter than k (L = 16 < k = 21: the one window starts before
    position 0), a batch of one read, a batch that is not a multiple of
    the kernel's 32 reads a block, rows that are not 16-byte aligned
    (the kernel stages them byte by byte), and reads so long that a block
    takes 8 of them (L = 16376, whose blocks' rows do not start 16-byte
    aligned, and the largest L of the kernel's staged path, 16384)."""
    rng = np.random.default_rng(17)
    k, L, B = {"shorter_than_k": (21, 16, 77), "long": (31, 16376, 20),
               "longest": (17, 16384, 9)}.get(case, (17, 104, 300))
    if case == "one_read":
        B = 1
    elif case == "odd_batch":
        B = 33
    codes = rng.integers(0, 5, size=(B, L)).astype(np.uint8)
    if case == "all_n":
        codes[: B // 2] = 4
    packed, vmask = step.pack_codes(torch.from_numpy(codes).to(cuda))
    if case == "unaligned":
        packed, vmask = packed[1:], vmask[1:]
    for size_bits in (1 << 30, 1 << 33, 3 << 33):
        meta = _Meta(k, size_bits)
        got = step.front_end(packed, vmask, meta)
        equal(got, step.front_end_plain(packed, vmask, meta))
    if case == "all_n":
        assert not got[2][: B // 2].any() and (got[3][: B // 2] == 0).all()


@pytest.mark.parametrize("k", [11, 17, 31])
@pytest.mark.parametrize("L", [16392, 32768])
def test_front_end_long_reads(cuda, L, k):
    """Reads over 16384 bases take the front end's long-read kernel: every
    window and the lengths equal the plain version, at each Bloom form,
    on reads of random lengths with Ns, one all N and one of L bases."""
    from shark_tpu_torch import kernels

    rng = np.random.default_rng(L + k)
    B = 40
    codes = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    codes[rng.random((B, L)) < 0.02] = 4
    lens = rng.integers(0, L + 1, size=B)
    lens[:2] = L
    codes[np.arange(L)[None, :] >= lens[:, None]] = 4
    codes[2] = 4
    packed, vmask = step.pack_codes(torch.from_numpy(codes).to(cuda))
    for size_bits in (1 << 30, 1 << 33, 3 << 33):
        meta = _Meta(k, size_bits)
        kernels.LAUNCHES.reset()
        got = step.front_end(packed, vmask, meta)
        assert kernels.LAUNCHES.snapshot()["front"] == 1
        equal(got, step.front_end_plain(packed, vmask, meta))
    assert got[2][:2].any() and not got[2][2].any()


def test_pipeline_long_read_cuda_matches_cpu(cuda, tmp_path):
    """A sample holding one 17000-base read (its batch padded to 32768) at
    a small batch size: the card's output bytes equal --backend cpu's."""
    rng = np.random.default_rng(61)
    genes = [BASES[rng.integers(0, 4, size=1500)] for _ in range(12)]
    genes.append(BASES[rng.integers(0, 4, size=20000)])
    fa = tmp_path / "g.fa"
    fa.write_bytes(b"".join(b">g%02d\n%s\n" % (i, g.tobytes())
                            for i, g in enumerate(genes)))
    recs = []
    for i in range(61):
        if i == 23:
            r = genes[-1][1500:18500].copy()
        else:
            g = genes[int(rng.integers(0, len(genes)))]
            s = int(rng.integers(0, len(g) - 90))
            r = g[s:s + 90].copy()
        r[rng.random(r.size) < 0.01] = ord("N")
        recs.append(b"@r%03d\n%s\n+\n%s\n" % (i, r.tobytes(), b"I" * r.size))
    fq = tmp_path / "s.fq"
    fq.write_bytes(b"".join(recs))
    outs = {}
    for backend in ("", "cpu"):
        tag = backend or "gpu"
        cfg = SharkConfig(
            fasta_path=str(fa), sample1_path=str(fq),
            out1_path=str(tmp_path / f"{tag}.fq"),
            ssv_path=str(tmp_path / f"{tag}.ssv"), k=17, c=0.5,
            batch_size=8, backend=backend, bf_gb=1)
        run_pipeline(cfg)
        outs[tag] = [(tmp_path / f"{tag}{x}").read_bytes()
                     for x in (".ssv", ".fq")]
    assert b"r023 g12" in outs["cpu"][0]
    assert outs["gpu"] == outs["cpu"]


@pytest.mark.parametrize("allow16", [True, False], ids=["entry16", "entry8"])
def test_probe_kernel(cuda, allow16):
    # a small filter: collisions merge rows and buckets spill to the stash
    records, index = family_index(members=4, n_fam=6, singles=40,
                                  size_bits=1 << 24, flank=200, single_len=800)
    table, stash, hmeta = hashed.build_hashed_index(index, allow16=allow16)
    assert hmeta.entry16 == allow16
    assert (stash[:, 1] != 0xFFFFFFFF).any()
    dix, hmeta = hashed.hashed_device_index(
        table, stash, *step.build_rows3(index), hmeta, cuda)
    rng = np.random.default_rng(5)
    codes = encode(reads_from(rng, records, 500, 0, 400))
    meta = step.StaticMeta.for_index(index, 96)
    hi, lo, valid, _ = step.front_end(
        *step.pack_codes(torch.from_numpy(codes).to(cuda)), meta)
    args = (hi, lo, valid, dix.table, dix.stash, hmeta)
    equal(hashed.probe_hashed(*args), hashed.probe_hashed_plain(*args))


def stash_slot(lo, hi, lg):
    """csrc/probe.cu's stash_slot in numpy: the slot of positions (lo, hi)
    in the kernel's stash table of 2^lg slots."""
    u = np.uint32
    with np.errstate(over="ignore"):
        h = (lo.astype(u) * u(0x9E3779B1)) ^ (
            (hi.astype(u) + u(0x7F4A7C15)) * u(0x85EBCA77))
        h ^= h >> u(16)
        h = h * u(0x7FEB352D)
        h ^= h >> u(15)
    return h >> u(32 - lg)


def stash_table_lg(n_real):
    """log2 of the kernel's stash table size for n_real rows."""
    lg = 6
    while (1 << lg) < 4 * n_real:
        lg += 1
    return lg


def planted_windows(rng, stash, n_pos):
    """1-D (lo, hi, valid) numpy windows: every real stash row's position;
    the same lo with another hi; positions whose stash-table slot equals a
    row's; the stash positions again on invalid windows; (0xFFFFFFFF,
    0xFFFFFFFF), which every padding row matches, valid and invalid; and
    random positions below 2^n_pos."""
    n = hashed.stash_rows_before_pad(stash)
    real = stash[:n]
    rand = rng.integers(0, 1 << n_pos, size=1 << 18, dtype=np.int64)
    rlo = (rand & 0xFFFFFFFF).astype(np.uint32)
    rhi = (rand >> 32).astype(np.uint32)
    lg = stash_table_lg(n)
    coll = np.isin(stash_slot(rlo, rhi, lg),
                   stash_slot(real[:, 0], real[:, 1], lg))
    assert n == 0 or coll.sum() > 100
    ones = np.array([0xFFFFFFFF] * 2, np.uint32)
    lo = np.concatenate([real[:, 0], real[:, 0], rlo[coll][:4096],
                         real[:, 0], ones, rlo[:8192]])
    hi = np.concatenate([real[:, 1], real[:, 1] ^ 1, rhi[coll][:4096],
                         real[:, 1], ones, rhi[:8192]])
    valid = np.ones(lo.size, bool)
    first = 2 * n + int(min(coll.sum(), 4096))
    valid[first:first + n + 1] = False  # the stash positions, one all-ones
    valid[-8192:] = rng.random(8192) < 0.9
    return lo, hi, valid


def check_probe(cuda, wins, table, stash, hmeta):
    """K2 on numpy or card windows against its plain version, with the
    stash row count passed and taken from the stash; returns the plain
    (tagv, payv) as int32."""
    def dev(a):
        return (a if isinstance(a, torch.Tensor)
                else torch.from_numpy(np.ascontiguousarray(a))).to(cuda)
    args = (*(dev(a) for a in wins), dev(table), dev(stash), hmeta)
    want = hashed.probe_hashed_plain(*args)
    equal(hashed.probe_hashed(*args), want)
    equal(hashed.probe_hashed(*args, hashed.stash_rows_before_pad(stash)),
          want)
    return [w.view(torch.int32) for w in want]


@pytest.mark.parametrize("allow16", [True, False], ids=["entry16", "entry8"])
def test_probe_kernel_planted_stash_windows(cuda, allow16):
    """K2 on an index whose buckets spill: front-end windows, then planted
    windows at every real stash row (also with another hi, on invalid
    windows and at slots that collide in the kernel's stash table)."""
    records, index = family_index(members=4, n_fam=6, singles=40,
                                  size_bits=1 << 24, flank=200, single_len=800)
    table, stash, hmeta = hashed.build_hashed_index(index, allow16=allow16)
    n = hashed.stash_rows_before_pad(stash)
    assert n > 0
    rng = np.random.default_rng(31)
    codes = encode(reads_from(rng, records, 500, 0, 400))
    meta = step.StaticMeta.for_index(index, 96)
    hi, lo, valid, _ = step.front_end(
        *step.pack_codes(torch.from_numpy(codes).to(cuda)), meta)
    check_probe(cuda, (hi, lo, valid), table, stash, hmeta)
    plo, phi, pvalid = planted_windows(rng, stash, 24)
    tag, pay = check_probe(cuda, (phi, plo, pvalid), table, stash, hmeta)
    assert (tag[:n] != 0).all()  # every stash row is found
    assert (tag[2 * n:][~torch.from_numpy(pvalid[2 * n:]).to(cuda)]
            == 0).all()


def synthetic_stash(rng, n_real, n_pad, dup=0):
    """n_real random stash rows (positions below 2^36, tags 1-3, random
    payloads), the first `dup` of them repeated with other tags and
    payloads, then n_pad padding rows."""
    pos = rng.choice(1 << 36, size=n_real, replace=False)
    rows = np.stack([pos & 0xFFFFFFFF, pos >> 32, rng.integers(1, 4, n_real),
                     rng.integers(0, 1 << 32, n_real)], 1).astype(np.uint32)
    again = rows[:dup].copy()
    again[:, 2:] = np.stack([rng.integers(1, 4, dup),
                             rng.integers(0, 1 << 32, dup)], 1)
    return np.concatenate([rows, again,
                           np.full((n_pad, 4), 0xFFFFFFFF, np.uint32)])


def table_windows(rng, words, lgB, rest_of, n):
    """n windows at occupied slots of a hand-made table (rest_of(word) is
    the slot's rest; every one of them matches) and n random ones."""
    b, s = np.nonzero(rest_of(words) >= 0)
    pick = rng.integers(0, b.size, n)
    pos = (rest_of(words)[b[pick], s[pick]].astype(np.int64) << lgB) \
        | b[pick]
    pos = np.concatenate([pos, rng.integers(0, 1 << 36, n)])
    return ((pos >> 32).astype(np.uint32), (pos & 0xFFFFFFFF).astype(
        np.uint32), rng.random(2 * n) < 0.95)


@pytest.mark.parametrize("layout", ["entry16x4", "entry8_big_stash",
                                    "padding_stash"])
def test_probe_kernel_layouts(cuda, layout):
    """K2 on hand-made tables: entry16 with 4 slots a bucket (adjacent
    degree-2 words), entry8 with 200 real stash rows and 3 repeated
    positions (the kernel may rely on no property of the stash), and a
    real entry16 index with a stash of padding rows only."""
    rng = np.random.default_rng(33)
    if layout == "padding_stash":
        _, index = family_index(size_bits=1 << 24)
        table, _, hmeta = hashed.build_hashed_index(index)
        stash = np.full((32, 4), 0xFFFFFFFF, np.uint32)
        plo, phi, pvalid = planted_windows(rng, stash, 24)
        check_probe(cuda, (phi, plo, pvalid), table, stash, hmeta)
        return
    if layout == "entry16x4":
        lgB = 12
        meta16 = (rng.integers(1, 4, (1 << lgB, 4)) << 14) \
            | rng.integers(0, 1 << 14, (1 << lgB, 4))
        meta16[rng.random(meta16.shape) < 0.3] = 0  # empty slots
        two = rng.random(1 << lgB) < 0.3  # a degree-2 entry in slots 1, 2
        meta16[two, 2] = meta16[two, 1]
        table = ((meta16 << 16) | rng.integers(0, 1 << 16, meta16.shape)
                 ).astype(np.uint32)
        hmeta = hashed.HashedMeta(lgB=lgB, has_rows=False, entry16=True,
                                  slots=4)
        stash = synthetic_stash(rng, 10, 22)

        def rest_of(w):
            return np.where(w >> 30 != 0, (w >> 16) & 0x3FFF, -1)
    else:
        lgB = 10
        w0 = ((rng.integers(1, 4, (1 << lgB, 8)) << 30)
              | rng.integers(0, 1 << 26, (1 << lgB, 8)))
        w0[rng.random(w0.shape) < 0.3] = 0
        table = np.stack([w0, rng.integers(0, 1 << 32, w0.shape)],
                         1).astype(np.uint32)
        hmeta = hashed.HashedMeta(lgB=lgB, has_rows=False, entry16=False)
        stash = synthetic_stash(rng, 200, 53, dup=3)

        def rest_of(t):
            w = t[:, 0, :] if t.ndim == 3 else t
            return np.where(w >> 30 != 0, w & 0x3FFFFFFF, -1)
    hi, lo, valid = table_windows(rng, table.astype(np.int64), lgB, rest_of,
                                  4096)
    tag, _ = check_probe(cuda, (hi, lo, valid), table, stash, hmeta)
    assert (tag[:4096][torch.from_numpy(valid[:4096]).to(cuda)] != 0).all()
    plo, phi, pvalid = planted_windows(rng, stash, 36)
    check_probe(cuda, (phi, plo, pvalid), table, stash, hmeta)


@pytest.mark.parametrize("tier", ["no_impure", "within_cap", "past_cap2"])
def test_finish_tiers(cuda, tier):
    records, index = family_index()
    rng = np.random.default_rng(3)
    core = reads_from(rng, records, 300, 100, 160)
    flank = reads_from(rng, records, 150, 0, 10)
    straddle = reads_from(rng, records, 200, 30, 90)
    reads = {
        "no_impure": core + flank,
        "within_cap": core + flank + straddle[:40],
        "past_cap2": straddle,
    }[tier]
    packed = classify_both(cuda, index, encode(reads))[0]
    grp = int(((packed >> step.PACK_GRP_SHIFT) & 1).sum())
    assert (grp == 0) == (tier == "past_cap2")


@pytest.mark.parametrize("straddlers,count", [
    (40, "own"), (40, "past_cap2"), (200, "own"), (200, "none")])
def test_finish_takes_a_batch_group_count(cuda, straddlers, count):
    """K3's group pass alone (finish_group_count) counts what the plain
    pass counts, added to a count already there; and the finish given a
    whole batch's count and cap (its own; past the cap where its own
    count is within it; none where its own is past it) equals the plain
    finish given the same."""
    records, index = family_index()
    rng = np.random.default_rng(3)
    reads = (reads_from(rng, records, 300, 100, 160)
             + reads_from(rng, records, straddlers, 30, 90))
    clf = Classifier(index, max_winners=8, device=cuda)
    codes = encode(reads)
    tags = clf.tags(*step.pack_codes(torch.from_numpy(codes)))
    tagv, payv, length, L = tags
    meta, thresh = clf._geometry(L)
    n_fix = torch.full((1,), 7, dtype=torch.int32, device=cuda)
    step.finish_group_count(tagv, payv, n_fix, meta=meta, has_rows=True)
    cpu_fix = torch.full((1,), 7, dtype=torch.int32)
    step.finish_group_count(tagv.cpu(), payv.cpu(), cpu_fix, meta=meta,
                            has_rows=True)
    assert int(n_fix) == int(cpu_fix) > 7
    batch = {"own": int(n_fix) - 7, "none": 0, "past_cap2": 10_000}[count]
    cap = step.fix_caps(len(reads))[1]
    over = dict(n_fix=torch.full((1,), batch, dtype=torch.int32), fix_cap2=cap)
    args = dict(rows3=clf.dix.rows3, ext_mat=clf.dix.ext_mat, meta=meta,
                max_winners=8, L=L, has_rows=True)
    got = step.finish_from_tags(tagv, payv, length, thresh.to(cuda),
                                n_fix=over["n_fix"].to(cuda), fix_cap2=cap,
                                **args)
    cpu = {k: (v.cpu() if isinstance(v, torch.Tensor) else v)
           for k, v in args.items()}
    want = step.finish_from_tags_plain(tagv.cpu(), payv.cpu(), length.cpu(),
                                       thresh.cpu(), **over, **cpu)
    equal(got, want)
    grp = int(((want[0] >> step.PACK_GRP_SHIFT) & 1).sum())
    assert (grp == 0) == (batch > cap)
    if count == "own":
        equal(got, clf.finish(tags))


def test_finish_impure_last_read(cuda):
    records, index = family_index()
    rng = np.random.default_rng(9)
    reads = reads_from(rng, records, 120, 100, 160)
    reads.append(records[0][1][110:155] + records[39][1][110:155])
    packed = classify_both(cuda, index, encode(reads))[0]
    assert not (packed[-1] >> step.PACK_GRP_SHIFT) & 1


@pytest.mark.parametrize("scratch", [False, True], ids=["shared", "scratch"])
def test_finish_extension_rows(cuda, monkeypatch, scratch):
    """A 40-member family with the capped D=8 + extension geometry; with
    `scratch` the keys go through the global scratch buffer that wide
    geometries use."""
    if scratch:
        monkeypatch.setattr(step, "_FINISH_SMEM_MAX", 0)
    records, index = family_index(members=40, n_fam=1, singles=40,
                                  size_bits=1 << 20)
    index.__dict__["_row_geometry3"] = (8, 64)
    rng = np.random.default_rng(7)
    reads = reads_from(rng, records, 300, 0, 500)
    # straddlers: a few extension windows each (the EXT_CAP2 path)
    reads += [records[m][1][30:120] for m in range(40)]
    packed = classify_both(cuda, index, encode(reads, L=128),
                           max_winners=24)[0]
    assert ((packed >> step.PACK_OVF_SHIFT) & 1).any()


# Synthetic finish batches: reads of chosen kinds, so that their key counts
# sit on chosen sides of the finish's warp cap (step.FINISH_WARP_CAP = 256)
# at L = 160, k = 15 (146 windows) on family_index() (8 families of 5
# genes: deg-5 rows, one group id per family). Per read kind:
#   direct        tags 0/1/2, about 146 keys             (warp path)
#   direct_heavy  tag 2 in every window, 292 keys        (block path)
#   pure_few      30 rows of one family                  (warp path)
#   pure_many     146 rows of one family: 146 keys under the group verdict
#                 (warp path), 730 without it            (block path)
#   impure_few    20 rows of two families + 10 direct    (warp path)
#   impure_many   146 rows of two families, 730 keys     (block path)
# A batch of 256 reads has FIX_CAP2 = 64: at most 64 impure reads keep the
# group verdicts of the pure ones.
FINISH_MIXES = {
    "below": dict(direct=96, pure_many=96, impure_few=64),
    "above": dict(direct_heavy=64, impure_many=128, pure_many=64),
    "no_impure": dict(direct=64, direct_heavy=64, pure_many=64, pure_few=64),
    "within_cap": dict(direct=64, direct_heavy=32, pure_many=64,
                       impure_few=32, impure_many=32, pure_few=32),
    "past_cap2": dict(direct=40, direct_heavy=40, impure_few=48,
                      impure_many=48, pure_many=40, pure_few=40),
}


def finish_batch(index, mix, L=160, seed=0):
    """numpy (tagv u32[B, Ls], payv u32[B, Ls], length i32[B], thresh
    i32[L + 1]) of FINISH_MIXES[mix], its read kinds in random order."""
    rng = np.random.default_rng(seed)
    Ls = L - (index.k - 1)
    kinds = [kind for kind, n in FINISH_MIXES[mix].items() for _ in range(n)]
    kinds = [kinds[i] for i in rng.permutation(len(kinds))]
    pay3 = step.rows3_payload(index)
    gid = step.group_info(index)[0]
    families = [np.flatnonzero(gid == g) for g in np.unique(gid)]
    B = len(kinds)
    tagv = np.zeros((B, Ls), np.uint32)
    payv = np.zeros((B, Ls), np.uint32)
    for b, kind in enumerate(kinds):
        genes = rng.integers(0, index.n_genes, size=(2, Ls)).astype(np.uint32)
        direct = genes[0] | (genes[1] << 16)
        if kind == "direct":
            tagv[b] = rng.choice(3, size=Ls, p=[0.3, 0.4, 0.3])
        elif kind == "direct_heavy":
            tagv[b] = step.TAG_D2
        payv[b] = np.where(tagv[b] == step.TAG_D1, genes[0], direct)
        if kind.startswith(("pure", "impure")):
            fams = rng.choice(len(families), size=1 + kind.startswith("impure"),
                              replace=False)
            rows = np.concatenate([families[f] for f in fams])
            n_rows = {"pure_few": 30, "impure_few": 20}.get(kind, Ls)
            at = rng.choice(Ls, size=n_rows, replace=False)
            picks = rng.choice(rows, size=n_rows)
            if kind.startswith("impure"):  # both families in every read
                picks[:2] = [families[fams[0]][0], families[fams[1]][0]]
            tagv[b, at] = step.TAG_ROW
            payv[b, at] = pay3[picks]
            if kind == "impure_few":
                free = np.setdiff1d(np.arange(Ls), at)[:10]
                tagv[b, free] = step.TAG_D2
                payv[b, free] = direct[free]
    length = rng.integers(0, L + 1, size=B).astype(np.int32)
    return tagv, payv, length, step.emit_threshold_table(0.6, L)


@pytest.mark.parametrize("mix", list(FINISH_MIXES) + ["scratch"])
def test_finish_warp_and_block_paths(cuda, monkeypatch, mix):
    """The finish kernel against its plain version on batches whose reads
    sit below the warp cap, above it, and on both sides at each group tier
    (scratch: the within_cap batch with the block path's keys in global
    scratch). The count of reads the kernel sent to its block path equals
    finish_heavy_reads_plain's."""
    if mix == "scratch":
        monkeypatch.setattr(step, "_FINISH_SMEM_MAX", 0)
    _, index = family_index()
    L = 160
    arrays = finish_batch(index, "within_cap" if mix == "scratch" else mix, L)
    rows3, ext_mat = step.build_rows3(index)
    assert ext_mat is None
    kw = dict(ext_mat=None, meta=step.StaticMeta.for_index(index, L),
              max_winners=8, L=L, has_rows=True)
    cpu = [torch.from_numpy(a) for a in arrays]
    dev = [x.to(cuda) for x in cpu]
    got = step.finish_from_tags(*dev, rows3=torch.from_numpy(rows3).to(cuda),
                                **kw)
    n_block = step.finish_heavy_count()
    want = step.finish_from_tags(*cpu, rows3=torch.from_numpy(rows3), **kw)
    equal(got, want)
    heavy = step.finish_heavy_reads_plain(
        cpu[0], cpu[1], rows3=torch.from_numpy(rows3), ext_mat=None,
        meta=kw["meta"], L=L, has_rows=True)
    assert n_block == int(heavy.sum())
    B = heavy.numel()
    assert n_block == {"below": 0, "above": B}.get(mix, n_block)
    if mix not in ("below", "above"):
        assert 0 < n_block < B
    grp = int(((want[0] >> step.PACK_GRP_SHIFT) & 1).sum())
    assert (grp > 0) == (mix in ("below", "no_impure", "within_cap",
                                 "scratch"))


@pytest.mark.parametrize("B,W,cap", [(4096, 16, 1 << 14), (300, 8, 256)])
def test_extract_pairs_kernel(cuda, B, W, cap):
    rng = np.random.default_rng(B)
    nw = rng.integers(0, W + 3, size=B)
    nw[rng.random(B) < 0.05] = 31
    winners = np.full((B, W), -1, np.int32)
    for r in range(B):
        m = min(int(nw[r]), W)
        winners[r, :m] = np.sort(rng.choice(60000, size=m, replace=False))
    packed = (np.maximum(winners[:, 0], 0) | (np.minimum(nw, 31) << 16)
              | ((rng.random(B) < 0.8).astype(np.int64) << 21)
              | ((rng.random(B) < 0.05).astype(np.int64) << 22)
              | ((rng.random(B) < 0.05).astype(np.int64) << 23)
              ).astype(np.int32)
    p = torch.from_numpy(packed).to(cuda)
    w = torch.from_numpy(winners).to(cuda)
    equal([step.extract_pairs(p, w, cap)], [step.extract_pairs_plain(p, w, cap)])


def test_extract_pairs_sentinel_collision(cuda):
    B, W = 65536, 8
    packed = torch.zeros(B, dtype=torch.int32, device=cuda)
    winners = torch.full((B, W), -1, dtype=torch.int32, device=cuda)
    winners[B - 1, :2] = torch.tensor([65534, 65535], dtype=torch.int32)
    packed[B - 1] = 65534 | (2 << 16) | (1 << 21)
    got = step.extract_pairs(packed, winners, 1 << 14)
    equal([got], [step.extract_pairs_plain(packed, winners, 1 << 14)])
    assert int(got[1]) == step.PAIR_SENTINEL


def pairs_batch(B, W, emit, seed):
    """numpy (packed i32[B], winners i32[B, W]) as the finish writes them:
    nw in [0, W + 2] (and 31, saturated, for 5%), ascending genes below
    65536, emitted with probability `emit`, 5% overflowed, 5% group
    verdicts."""
    rng = np.random.default_rng(seed)
    nw = rng.integers(0, W + 3, size=B)
    nw[rng.random(B) < 0.05] = 31
    m = np.minimum(nw, W)
    genes = np.sort(rng.integers(0, 65536, size=(B, W)), axis=1)
    winners = np.where(np.arange(W)[None, :] < m[:, None], genes, -1
                       ).astype(np.int32)
    packed = (np.maximum(winners[:, 0], 0) | (np.minimum(nw, 31) << 16)
              | ((rng.random(B) < emit).astype(np.int64) << 21)
              | ((rng.random(B) < 0.05).astype(np.int64) << 22)
              | ((rng.random(B) < 0.05).astype(np.int64) << 23)
              ).astype(np.int32)
    return packed, winners


@pytest.mark.parametrize("case", [
    "full_batch", "full_batch_below", "w31", "one_row", "one_row_below",
    "no_emit", "odd_batch", "unaligned", "collision"])
def test_extract_pairs_kernel_shapes(cuda, case):
    """K4 at the bench batch (B = 65536, W = 16) with out_len above and
    below the pair count, at W = 31, one row, a batch where no row emits,
    a batch that is no multiple of the kernel's tile or of 4, verdicts
    that are not 16-byte aligned, and the (65535, 65535) pair that encodes
    to the sentinel at B = 65536, W = 16."""
    B, W = {"w31": (3000, 31), "one_row": (1, 16), "one_row_below": (1, 16),
            "odd_batch": (4099, 16)}.get(case, (65536, 16))
    emit = 0.0 if case == "no_emit" else 0.8
    packed, winners = pairs_batch(B + (case == "unaligned"), W, emit, B + W)
    if case == "collision":
        packed[-1] = 65534 | (2 << 16) | (1 << 21)
        winners[-1, :2] = [65534, 65535]
    elif B == 1:  # the one row emits three pairs
        winners[0] = -1
        winners[0, :3] = [5, 9, 700]
        packed[0] = 5 | (3 << 16) | (1 << 21)
    p = torch.from_numpy(packed).to(cuda)
    w = torch.from_numpy(winners).to(cuda)
    if case == "unaligned":
        p, w = p[1:], w[1:]
    total = int(step.extract_pairs_plain(p, w, B * W).ne(
        step.PAIR_SENTINEL).sum())
    cap = {"full_batch_below": total // 3, "one_row_below": 1}.get(
        case, total + 1000)
    got = step.extract_pairs(p, w, cap)
    equal([got], [step.extract_pairs_plain(p, w, cap)])
    assert (total == 0) == (case == "no_emit")
    if case == "collision":  # the last real pair, then the colliding one
        assert int(got[total - 1]) == (65535 << 16) | 65534
        assert int(got[total]) == step.PAIR_SENTINEL


@pytest.mark.parametrize("seed", range(4))
def test_pipeline_cuda_matches_cpu(cuda, tmp_path, seed):
    """Random panels (paired or not, Ns, quality masking) through the
    native engine and the Python path: the card's output bytes equal the
    CPU's."""
    rng = np.random.default_rng(500 + seed)
    genes = [BASES[rng.integers(0, 4, size=int(rng.integers(200, 900)))]
             for _ in range(int(rng.integers(3, 30)))]
    fa = tmp_path / "g.fa"
    fa.write_bytes(b"".join(b">g%d\n%s\n" % (i, g.tobytes())
                            for i, g in enumerate(genes)))
    paired = bool(seed % 2)
    mates = []
    for mate in range(2 if paired else 1):
        recs = []
        for i in range(700):
            g = genes[int(rng.integers(0, len(genes)))]
            n = int(rng.integers(40, 120))
            s = int(rng.integers(0, max(1, len(g) - n)))
            r = g[s:s + n].copy()
            r[rng.random(r.size) < 0.02] = ord("N")
            q = rng.integers(35, 73, size=r.size).astype(np.uint8)
            recs.append(b"@r%d\n%s\n+\n%s\n" % (i, r.tobytes(), q.tobytes()))
        path = tmp_path / f"s_{mate}.fq"
        path.write_bytes(b"".join(recs))
        mates.append(str(path))
    outs = {}
    for backend in ("", "cpu"):
        for native in (True, False):
            tag = f"{backend or 'gpu'}_{native}"
            cfg = SharkConfig(
                fasta_path=str(fa), sample1_path=mates[0],
                sample2_path=mates[1] if paired else "",
                out1_path=str(tmp_path / f"{tag}.1.fq"),
                out2_path=str(tmp_path / f"{tag}.2.fq") if paired else "",
                ssv_path=str(tmp_path / f"{tag}.ssv"), k=15, c=0.3,
                min_quality=10 * (seed // 2), batch_size=128,
                use_native=native, backend=backend, bf_gb=1,
            )
            run_pipeline(cfg)
            outs[tag] = [(tmp_path / f"{tag}{x}").read_bytes()
                         for x in (".ssv", ".1.fq")]
    want = outs["cpu_True"]
    assert want[0]
    for tag, got in outs.items():
        assert got == want, tag


# ---------------------------------------------------------------------------
# K5 (classic) and K6 (xl) against their plain versions
# ---------------------------------------------------------------------------

XL_GEOMETRIES = {"natural": {}, "spill": {"lgB": 15}, "no_side": {"lgB": 20}}
_INDEXES = {}


def txome_like_index(k, size_bits):
    """A small transcriptome in miniature: 8 genes sharing a 300 bp core
    (degree-8 rows) and 56 single genes, 1200 bp each. Built once per
    (k, size_bits) and kept, since the largest Bloom form takes GBs."""
    key = (k, size_bits)
    if key not in _INDEXES:
        _INDEXES.clear()
        rng = np.random.default_rng(k)
        genes = BASES[rng.integers(0, 4, size=(64, 1200))]
        genes[:8, 450:750] = BASES[rng.integers(0, 4, size=300)]
        records = [(f"G{i}", g.tobytes()) for i, g in enumerate(genes)]
        _INDEXES[key] = genes, build_index(records, k, size_bits)
    return _INDEXES[key]


def windows(cuda, genes, B, k, size_bits, seed):
    """Front-end windows of B reads (100 bp at L = 104, 2% errors with Ns,
    one in ten random) on the card."""
    from shark_tpu_torch.ops.kmers import BYTE_TO_CODE

    rng = np.random.default_rng(seed)
    gidx = rng.integers(0, genes.shape[0], size=B)
    starts = rng.integers(0, genes.shape[1] - 100, size=B)
    reads = genes[gidx[:, None], starts[:, None] + np.arange(100)]
    reads[rng.random(B) < 0.1] = BASES[rng.integers(0, 4, size=100)]
    err = rng.random(reads.shape) < 0.02
    reads[err] = np.frombuffer(b"ACGTN", np.uint8)[
        rng.integers(0, 5, size=int(err.sum()))]
    codes = np.full((B, 104), 4, np.uint8)
    codes[:, :100] = BYTE_TO_CODE[reads]
    packed, vmask = step.pack_codes(torch.from_numpy(codes).to(cuda))
    hi, lo, valid, _ = step.front_end(packed, vmask, _Meta(k, size_bits))
    return hi, lo, valid


def xl_tables(cuda, index, **geometry):
    table, side, side_stash, hmeta = hashed.build_hashed_xl(index, **geometry)
    return hashed.hashed_device_index(
        table, hashed.empty_stash(), *step.build_rows3(index), hmeta, cuda,
        side=side, side_stash=side_stash)


def check_xl(dix, hmeta, wins):
    args = (*wins, dix.table, dix.side, dix.side_stash, hmeta)
    equal(hashed.probe_xl(*args), hashed.probe_xl_plain(*args))


@pytest.mark.parametrize("k", [11, 17])
@pytest.mark.parametrize("geometry", list(XL_GEOMETRIES))
def test_probe_xl_kernel_geometries(cuda, geometry, k):
    size_bits = 1 << 26
    genes, index = txome_like_index(k, size_bits)
    dix, hmeta = xl_tables(cuda, index, **XL_GEOMETRIES[geometry])
    if geometry != "natural":
        assert hmeta.has_side == (geometry == "spill")
    for B in (8192, 65536):
        check_xl(dix, hmeta, windows(cuda, genes, B, k, size_bits, B + k))


def side_windows(hi, lo, valid, dix, hmeta, n):
    """n windows every one of which needs the side table (valid, in a
    flagged bucket, no match there), cycled from those of (hi, lo,
    valid), the side stash's own positions first."""
    no_side = dataclasses.replace(hmeta, has_side=False)
    tag, _ = hashed.probe_xl_plain(hi, lo, valid, dix.table, dix.side,
                                   dix.side_stash, no_side)
    bucket = lo.to(torch.int64) & ((1 << hmeta.lgB) - 1)
    flagged = ((dix.table.view(torch.int32)[bucket, 0]
                >> hashed.XL_FLAG_BIT) & 1) == 1
    need = (valid & flagged & (tag == 0)).reshape(-1)
    st = dix.side_stash.to(torch.int64)
    live = st[:, 1] != 0xFFFFFFFF
    assert live.any() and need.any()
    picks = [torch.cat([st[live, c], w.to(torch.int64).reshape(-1)[need]])
             for c, w in ((1, hi), (0, lo))]
    at = torch.arange(n, device=lo.device) % picks[0].numel()
    return (picks[0][at].to(torch.uint32), picks[1][at].to(torch.uint32),
            torch.ones(n, dtype=torch.bool, device=lo.device))


@pytest.mark.parametrize("view", ["ragged", "unaligned"])
@pytest.mark.parametrize("geometry", ["natural", "spill", "full_side",
                                      "no_side"])
def test_probe_xl_kernel_views(cuda, geometry, view):
    """Flat views of the windows whose count is no multiple of 4 (ragged:
    16-byte aligned, so a kernel that takes windows in groups ends on a
    short one) or that start one window in (unaligned) equal the plain
    version, in each geometry: natural, spill (5% of the windows need the
    side table), full_side (every window does, the side stash's positions
    among them) and no_side (has_side false)."""
    k, size_bits = 17, 1 << 26
    genes, index = txome_like_index(k, size_bits)
    geo = {"full_side": XL_GEOMETRIES["spill"]}.get(
        geometry, XL_GEOMETRIES.get(geometry))
    dix, hmeta = xl_tables(cuda, index, **geo)
    assert hmeta.has_side == (geometry != "no_side")
    hi, lo, valid = windows(cuda, genes, 8192, k, size_bits, 31)
    if geometry == "full_side":
        hi, lo, valid = side_windows(hi, lo, valid, dix, hmeta, 8192 * 88)
    flat = [t.reshape(-1) for t in (hi, lo, valid)]
    n = flat[0].numel()
    wins = [t[: n - 3] if view == "ragged" else t[1:] for t in flat]
    assert wins[0].numel() % 4
    check_xl(dix, hmeta, wins)


@pytest.mark.parametrize("size_bits", [1 << 30, 1 << 33, 3 << 33])
@pytest.mark.parametrize("k", [11, 17])
def test_probe_kernels_bloom_forms(cuda, k, size_bits):
    """The three forms of _mod_size (a power of two up to 2^32, a larger
    power of two, a multiple of 2^32): classic and xl (natural geometry)
    at B = 8192 and 65536."""
    genes, index = txome_like_index(k, size_bits)
    bf_rank, pay, _, _ = step.build_device_index(index)
    bf_rank = torch.from_numpy(bf_rank).to(cuda)
    pay = torch.from_numpy(pay).to(cuda)
    dix, hmeta = xl_tables(cuda, index)
    for B in (8192, 65536):
        wins = windows(cuda, genes, B, k, size_bits, B * k)
        equal(step.probe_tags(*wins, bf_rank, pay),
              step.probe_tags_plain(*wins, bf_rank, pay))
        check_xl(dix, hmeta, wins)


@pytest.mark.parametrize("probe", ["xl", "classic"])
def test_classifier_probe_layouts(cuda, probe):
    """K1 -> K6 or K5 -> K3 through the Classifier: the card's verdicts
    equal the CPU's."""
    genes, index = txome_like_index(17, 1 << 26)
    gpu = Classifier(index, max_winners=8, device=cuda, probe=probe)
    cpu = Classifier(index, max_winners=8, device="cpu", probe=probe)
    assert gpu.probe == cpu.probe == probe
    rng = np.random.default_rng(8)
    reads = [g[s:s + 100].tobytes() for g, s in zip(
        genes[rng.integers(0, 64, size=700)],
        rng.integers(0, 1100, size=700))]
    codes = encode(reads, L=104)
    equal(gpu(codes), cpu(codes))


# ---------------------------------------------------------------------------
# K7a-c (sharded routing) against their plain versions
# ---------------------------------------------------------------------------


def _transposed(buf):
    return buf.view(torch.int32).transpose(0, 1).contiguous().view(torch.uint32)


def check_shard_kernels(hi, lo, valid, n, wps, wide, cap, dix=None):
    """K7a on [n, b, Ls] windows against its plain version, then (with the
    shard tables `dix`) K7b on what the owners receive and K7c on what
    comes back. Returns K7a's outputs."""
    shp = (n, hi.shape[0] // n, hi.shape[1])
    win = [t.reshape(shp) for t in (hi, lo, valid)]
    route = dict(n=n, wps=wps, wide=wide, cap=cap)
    k7a = sharded_bf.shard_route(*win, **route)
    equal(k7a, sharded_bf.shard_route_plain(*win, **route))
    if dix is not None:
        recv = _transposed(k7a[0])
        reply = sharded_bf.shard_probe(recv, dix.bf_rank, dix.pay)
        equal([reply], [sharded_bf.shard_probe_plain(recv, dix.bf_rank,
                                                     dix.pay)])
        back = _transposed(reply)
        want = sharded_bf.shard_return_plain(back, k7a[2], k7a[1])
        equal(sharded_bf.shard_return(back, k7a[2], k7a[1]), want)
        # the replies in place, as the classifier passes them on one card
        equal(sharded_bf.shard_return(reply.transpose(0, 1), k7a[2],
                                      k7a[1]), want)
    return k7a


@pytest.mark.parametrize("overflow", [False, True], ids=["fits", "overflow"])
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("n", [1, 2, 8])
def test_shard_kernels(cuda, n, wide, overflow):
    size_bits = 1 << 26
    genes, index = txome_like_index(17, size_bits)
    clf = ShardedBFClassifier(index, devices=[cuda] * n, force_wide=wide,
                              slack=0.05 if overflow else None)
    for B in (8192, 65536):
        wins = windows(cuda, genes, B, 17, size_bits, B + n)
        k7a = check_shard_kernels(*wins, n, clf.wps, clf.wide,
                                  clf._probe_cap(B // n, 104), clf.dix[cuda])
        assert bool((k7a[3] > 0).all()) == overflow


@pytest.mark.parametrize("n", [1, 2, 8])
def test_shard_probe_kernel_slots(cuda, n):
    """K7b on hand-made received slots: a slot count per owner that is no
    multiple of the slots a thread or a block takes, empty slots among
    routed ones, an owner that received nothing (every owner, in a second
    call), and a pay table cut short, so that some hits have a rank past
    its rows and reply (0, 0)."""
    genes, index = txome_like_index(17, 1 << 26)
    t = ShardedBFClassifier(index, devices=[cuda] * n).dix[cuda]
    bf_rank = t.bf_rank.cpu().numpy()
    wps = bf_rank.shape[1]
    rng = np.random.default_rng(40 + n)
    cap = 1001
    recv = np.full((n, n, cap, 2), 0xFFFFFFFF, np.uint32)
    for h in range(n):
        if h == 1:
            continue  # owner 1 receives nothing
        k = n * cap
        set_words = np.flatnonzero(bf_rank[h, :, 0])
        words = np.where(rng.random(k) < 0.7, rng.choice(set_words, k),
                         rng.integers(0, wps, k))
        slots = np.stack([words, rng.integers(0, 32, k)], 1)
        slots[rng.random(k) < 0.2] = 0xFFFFFFFF  # empty slots
        recv[h] = slots.reshape(n, cap, 2)
    recv = torch.from_numpy(recv).to(cuda)
    full = sharded_bf.shard_probe_plain(recv, t.bf_rank, t.pay).view(
        torch.int32)
    assert bool((full != 0).any())
    for rows_max in (t.pay.shape[1], t.pay.shape[1] // 3):
        pay = t.pay[:, :rows_max].contiguous()
        got = sharded_bf.shard_probe(recv, t.bf_rank, pay)
        equal([got], [sharded_bf.shard_probe_plain(recv, t.bf_rank, pay)])
        got = got.view(torch.int32)
        if n > 1:
            assert not bool((got[1] != 0).any())
    assert bool(((full != 0) & (got == 0)).any())  # ranks past rows_max
    empty = torch.full(recv.shape, -1, dtype=torch.int32,
                       device=cuda).view(torch.uint32)
    got = sharded_bf.shard_probe(empty, t.bf_rank, t.pay)
    assert not bool((got.view(torch.int32) != 0).any())


def test_shard_route_wide_geometry(cuda):
    """K7a alone at a > 2^36-bit filter on synthetic addresses, each shard
    boundary's +-1 word included: kernel == plain, and its owners equal a
    numpy uint64 oracle."""
    n = 8
    size_bits = (1 << 37) + (5 << 33)
    wps = size_bits // 32 // n
    rng = np.random.default_rng(17)
    addr = (rng.integers(0, 1 << 62, size=8 * 4096, dtype=np.int64)
            .astype(np.uint64) % np.uint64(size_bits))
    edges = [(s * wps + d) * 32 + 7 for s in range(1, n) for d in (-1, 0, 1)]
    addr[:len(edges)] = edges
    hi = torch.from_numpy((addr >> np.uint64(32)).astype(np.uint32)).to(cuda)
    lo = torch.from_numpy((addr & np.uint64(0xFFFFFFFF)).astype(np.uint32)).to(cuda)
    valid = torch.from_numpy(rng.random(addr.size) < 0.9).to(cuda)
    _, slot, owner, _ = check_shard_kernels(
        hi.view(-1, 64), lo.view(-1, 64), valid.view(-1, 64), n, wps, True,
        cap=4096 + 512)
    want = ((addr >> np.uint64(5)) // np.uint64(wps)).astype(np.int32)
    v = valid.cpu().numpy()
    np.testing.assert_array_equal(owner.cpu().numpy().reshape(-1)[v], want[v])
    assert (owner.cpu().numpy().reshape(-1)[~v] == -1).all()


@pytest.mark.parametrize("slack", [None, 0.05])
def test_sharded_classifier_matches_cpu(cuda, slack):
    """Eight shards on the card against eight on the CPU, all five
    outputs; and the verdicts of the card's sharded classifier equal the
    classic Classifier's when nothing overflows."""
    genes, index = txome_like_index(17, 1 << 26)
    rng = np.random.default_rng(18)
    reads = [g[s:s + 100].tobytes() for g, s in zip(
        genes[rng.integers(0, 64, size=1024)],
        rng.integers(0, 1100, size=1024))]
    codes = encode(reads, L=104)
    gpu = ShardedBFClassifier(index, max_winners=8, devices=[cuda] * 8,
                              slack=slack)
    got = gpu(codes)
    equal(got, ShardedBFClassifier(index, max_winners=8,
                                   devices=["cpu"] * 8, slack=slack)(codes))
    if slack is None:
        assert int(got[4].sum()) == 0
        equal(got[:4], Classifier(index, max_winners=8, device=cuda,
                                  probe="classic")(codes))
    else:
        assert int(got[4].sum()) > 0


def _misaligned(t):
    """t's values in a view whose data starts 4 bytes past a 16-byte
    boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    flat[1:] = t.reshape(-1)
    return flat[1:].view(t.shape)


@pytest.mark.parametrize("case", list(RETURN_CASES))
def test_shard_return_layouts(cuda, case):
    """K7c on the owner probe's replies in place (transposed, a view) and
    on their contiguous copy, at window counts per source 0-3 mod 4 and
    under 4 (the kernel's scalar head and tail, and a payload plane off
    its 16-byte boundary), with no slot, with overflow, one shard and one
    window, and with owner and slot off their 16-byte boundary: equal to
    the plain version."""
    _, _, _, reply, owner, slot = return_inputs(case, seed=len(case) + 1)
    reply, owner, slot = reply.to(cuda), owner.to(cuda), slot.to(cuda)
    view = reply.transpose(0, 1)
    want = sharded_bf.shard_return_plain(view, owner, slot)
    for back in (view, view.contiguous()):
        equal(sharded_bf.shard_return(back, owner, slot), want)
    equal(sharded_bf.shard_return(view, _misaligned(owner),
                                  _misaligned(slot)), want)


def test_sharded_step_returns_in_place(cuda, monkeypatch):
    """One step of 8 shards on the card launches each routing kernel
    once, and the return reads the owner probe's replies in place (the
    same memory, transposed); the outputs equal 8 CPU shards'."""
    from shark_tpu_torch import kernels

    genes, index = txome_like_index(17, 1 << 26)
    rng = np.random.default_rng(21)
    reads = [g[s:s + 100].tobytes() for g, s in zip(
        genes[rng.integers(0, 64, size=2048)],
        rng.integers(0, 1100, size=2048))]
    codes = encode(reads, L=104)
    clf = ShardedBFClassifier(index, max_winners=8, devices=[cuda] * 8)
    seen = {}
    probe, ret = sharded_bf.shard_probe, sharded_bf.shard_return

    def shard_probe(recv, bf_rank, pay):
        seen["reply"] = probe(recv, bf_rank, pay)
        return seen["reply"]

    def shard_return(back, owner, slot):
        seen["back"] = back
        return ret(back, owner, slot)
    monkeypatch.setattr(sharded_bf, "shard_probe", shard_probe)
    monkeypatch.setattr(sharded_bf, "shard_return", shard_return)
    clf(codes)
    torch.cuda.synchronize()
    kernels.LAUNCHES.reset()
    got = clf(codes)
    torch.cuda.synchronize()
    counts = kernels.LAUNCHES.snapshot()
    assert [counts[k] for k in ("shard_route", "shard_probe",
                                "shard_return")] == [1, 1, 1]
    back, reply = seen["back"], seen["reply"]
    assert back.data_ptr() == reply.data_ptr() and not back.is_contiguous()
    assert back.stride() == reply.transpose(0, 1).stride()
    equal(got, ShardedBFClassifier(index, max_winners=8,
                                   devices=["cpu"] * 8)(codes))


def test_reprobe_on_another_thread_and_stream(cuda):
    """reprobe runs on the pipeline's drain thread: from a thread whose
    current stream is a side stream, it launches there and returns a
    result that the thread reads complete."""
    import threading

    genes, index = txome_like_index(17, 1 << 26)
    rng = np.random.default_rng(19)
    reads = [g[s:s + 100].tobytes() for g, s in zip(
        genes[rng.integers(0, 64, size=4096)],
        rng.integers(0, 1100, size=4096))]
    codes = encode(reads, L=104)
    want = ShardedBFClassifier(index, devices=["cpu"] * 8)(codes)
    clf = ShardedBFClassifier(index, devices=[cuda] * 8, slack=0.05)
    out = {}

    def drain():
        side = torch.cuda.Stream(cuda)
        with torch.cuda.stream(side):
            result = clf.reprobe(codes)
            out["got"] = [x.to("cpu", non_blocking=True) for x in result]
            side.synchronize()

    th = threading.Thread(target=drain)
    th.start()
    th.join()
    assert clf.cap_mult > 1
    equal(out["got"], want)


# ---------------------------------------------------------------------------
# K7a at its edges, and K5 with a pay row 0 whose second word is not 0
# ---------------------------------------------------------------------------

WIDE_BITS = (1 << 37) + (5 << 33)
# name: (sources, reads a source, windows a read, shards, cap, windows);
# the kernel's tile is 4096 windows
ROUTE_EDGES = {
    "one_window": (2, 1, 1, 8, 8, "random"),
    "under_one_tile": (1, 3, 88, 2, 200, "random"),
    "one_tile": (2, 64, 64, 8, 600, "random"),
    "ragged_tiles": (3, 613, 88, 8, 7000, "random"),
    "one_owner": (8, 8192, 88, 8, 500_000, "one_owner"),
    "all_tail": (2, 300, 88, 8, 2 * 300 * 88, "random"),
    "cap8": (4, 2000, 88, 8, 8, "random"),
    "all_invalid": (2, 200, 88, 8, 3000, "invalid"),
    "wide": (8, 1024, 88, 8, 12000, "wide"),
}


def route_windows(cuda, S, b, Ls, n, kind, seed):
    """Windows of S sources on the card whose Bloom words fall in n
    shards of wps words (a > 2^36-bit filter for "wide"; every word in
    the last shard for "one_owner"), 10% invalid (all for "invalid"):
    (hi, lo, valid [S, b, Ls], wps)."""
    rng = np.random.default_rng(seed)
    wps = WIDE_BITS // 32 // n if kind == "wide" else (1 << 20) + 3
    words = rng.integers(0, n * wps, size=(S, b, Ls), dtype=np.int64)
    if kind == "one_owner":
        words = (n - 1) * wps + words % wps
    addr = words.astype(np.uint64) * np.uint64(32) + rng.integers(
        0, 32, size=words.shape).astype(np.uint64)
    valid = rng.random(words.shape) < 0.9
    if kind == "invalid":
        valid[:] = False
    hi = (addr >> np.uint64(32)).astype(np.uint32)
    lo = (addr & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return (*(torch.from_numpy(a).to(cuda) for a in (hi, lo, valid)), wps)


def check_route(hi, lo, valid, **route):
    got = sharded_bf.shard_route(hi, lo, valid, **route)
    equal(got, sharded_bf.shard_route_plain(hi, lo, valid, **route))
    return got


@pytest.mark.parametrize("case", list(ROUTE_EDGES))
def test_shard_route_edges(cuda, case):
    """K7a == its plain version: one window, fewer windows than a tile,
    exactly one tile, a window count that is no multiple of the tile,
    every window owned by one shard (each tile's look-back walks back over
    all 176 tiles of its source, and the owner overflows), a cap past
    every total (the whole buffer is tail), a cap of 8 with heavy
    overflow, every window invalid, and the wide split."""
    S, b, Ls, n, cap, kind = ROUTE_EDGES[case]
    hi, lo, valid, wps = route_windows(cuda, S, b, Ls, n, kind, len(case))
    send, slot, owner, overflow = check_route(
        hi, lo, valid, n=n, wps=wps, wide=kind == "wide", cap=cap)
    routed = int((slot >= 0).sum())
    tail = int((send.view(torch.int32)[..., 0] == -1).sum())
    assert routed + tail == S * n * cap
    if case in ("one_owner", "cap8"):
        assert bool((overflow > 0).all())
    if case == "all_tail":
        assert int(overflow.sum()) == 0 and tail > routed
    if case == "all_invalid":
        assert routed == 0 and int(overflow.sum()) == 0
        assert bool((owner == -1).all())


@pytest.mark.parametrize("n", [1, 2, 8, 64, 1024])
def test_shard_route_shard_counts(cuda, n):
    """K7a == its plain version at 1 to 1024 owners, 44 tiles a source,
    at a cap near the mean count of a (source, owner) row (some rows
    overflow, the rest have tails)."""
    S, b, Ls = 2, 2048, 88
    hi, lo, valid, wps = route_windows(cuda, S, b, Ls, n, "random", n)
    check_route(hi, lo, valid, n=n, wps=wps, wide=False,
                cap=max(8, b * Ls // n))


@pytest.mark.parametrize("n,wps", [(8, 1), (8, 7), (8, (1 << 20) + 3),
                                   (8, 1 << 25), (8, (1 << 28) - 1),
                                   (1, (1 << 31) - 1), (3, 715827882)])
def test_shard_route_narrow_boundaries(cuda, n, wps):
    """K7a == its plain version on words at every shard boundary +-1 and
    at random, for divisors wps of every size the narrow (31-bit) word
    takes, and owners equal word // wps: the kernel divides by multiplying
    and shifting."""
    rng = np.random.default_rng(wps % 1000)
    edges = [s * wps + d for s in range(1, n + 1) for d in (-2, -1, 0, 1)]
    words = np.concatenate([
        np.asarray([w for w in edges if 0 <= w < n * wps], np.int64),
        rng.integers(0, n * wps, size=40000, dtype=np.int64),
        [0, n * wps - 1]])
    words = words[:words.size // 88 * 88]
    addr = words.astype(np.uint64) * np.uint64(32) + np.uint64(5)
    hi = torch.from_numpy((addr >> np.uint64(32)).astype(np.uint32)).to(cuda)
    lo = torch.from_numpy((addr & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    shp = (1, words.size // 88, 88)
    valid = torch.ones(shp, dtype=torch.bool, device=cuda)
    _, _, owner, _ = check_route(hi.view(shp), lo.to(cuda).view(shp), valid,
                                 n=n, wps=wps, wide=False, cap=words.size)
    np.testing.assert_array_equal(owner.cpu().numpy().reshape(-1),
                                  words // wps)


def test_shard_route_repeated_calls(cuda):
    """50 calls of K7a on the record shape (8 sources of 8192 reads x 88
    windows, 176 tiles each) give the same bytes: the tiles' order is
    their tickets', which changes from call to call, and the result must
    not."""
    hi, lo, valid, wps = route_windows(cuda, 8, 8192, 88, 8, "random", 50)
    route = dict(n=8, wps=wps, wide=False, cap=95_000)
    first = check_route(hi, lo, valid, **route)
    for _ in range(50):
        again = sharded_bf.shard_route(hi, lo, valid, **route)
        for a, f in zip(again, first):
            assert torch.equal(a, f)


@pytest.mark.parametrize("B", [3, 1000])
def test_classic_kernel_marked_pay_row0(cuda, B):
    """K5 == its plain version with pay row 0's second word not 0, so
    that every miss and every invalid window carries shark_tpu's payload
    (pay[0, 1] & 0xFFFF) << 16, on B * 88 windows (no multiple of the
    block) with hits of every tag."""
    genes, index = txome_like_index(17, 1 << 26)
    bf_rank, pay, _, _ = step.build_device_index(index)
    pay[0, 1] = 0x1234ABCD
    bf_rank, pay = (torch.from_numpy(a).to(cuda) for a in (bf_rank, pay))
    hi, lo, valid = windows(cuda, genes, B, 17, 1 << 26, 60 + B)
    tag, payv = step.probe_tags(hi, lo, valid, bf_rank, pay)
    equal((tag, payv), step.probe_tags_plain(hi, lo, valid, bf_rank, pay))
    tag, payv = tag.view(torch.int32), payv.view(torch.int32)
    miss = tag == 0
    assert bool((~valid).any()) and bool((miss & valid).any())
    assert bool((payv[miss] == 0xABCD0000 - (1 << 32)).all())
    if B == 1000:
        for t in (1, 2, 3):
            assert bool((tag == t).any()), f"no tag-{t} windows"


# ---------------------------------------------------------------------------
# P1 (tile gather) and P2 (resident-table bucket match) against their
# plain versions
# ---------------------------------------------------------------------------


def _on(cuda, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in arrays]


def _tile_rows(table, idx):
    return table.view(torch.int32)[idx.to(torch.int64)].view(torch.uint32)


@pytest.mark.parametrize("n_log2,rows_log2", [(10, 12), (16, 22), (20, 27)],
                         ids=["small", "mid", "default"])
def test_gather_tiles_kernel(cuda, n_log2, rows_log2):
    table, tiles, idx = _on(cuda, *gather_tiles.make_inputs(
        n_log2, rows_log2, seed=n_log2))
    got = gather_tiles.gather_tiles(tiles, idx)
    equal([got], [gather_tiles.gather_tiles_plain(tiles, idx)])
    equal([gather_tiles.rows_of_tiles(got, idx)], [_tile_rows(table, idx)])


def test_gather_tiles_kernel_odd_rows(cuda):
    """3001 tiles and 3 x 1024 probes, the first and last row included."""
    rng = np.random.default_rng(3)
    rows = 64 * 3001
    table = rng.integers(0, 1 << 32, size=(rows, 2), dtype=np.uint64
                         ).astype(np.uint32)
    idx = rng.integers(0, rows, size=3 * gather_tiles.CHUNK).astype(np.int32)
    idx[:2] = [0, rows - 1]
    table, idx = _on(cuda, table, idx)
    tiles = table.view(-1, 128)
    got = gather_tiles.gather_tiles(tiles, idx)
    equal([got], [gather_tiles.gather_tiles_plain(tiles, idx)])
    equal([gather_tiles.rows_of_tiles(got, idx)], [_tile_rows(table, idx)])


def _planted_match_inputs(n, lgB, seed):
    """resident_match's harness inputs with probe 0's bucket matching in
    all 8 slots (pays near 2^16: p1 << 16 wraps) and probe 1's in 3, after
    5 tag-0 slots that carry its key."""
    table, bucket, rest, valid = resident_match.build_inputs(n, lgB, seed)
    s = np.arange(8, dtype=np.uint64)
    valid[:2] = True
    table[bucket[0]] = ((1 + s % 3) << 30 | np.uint64(rest[0]) << 16
                        | (0xFFF0 + s)).astype(np.uint32)
    table[bucket[1]] = (np.where(s < 5, 0, 2 << 30).astype(np.uint64)
                        | np.uint64(rest[1]) << 16 | (100 + s)).astype(
                            np.uint32)
    return table, bucket, rest, valid


@pytest.mark.parametrize("lgB,n", [(10, resident_match.CHUNK),
                                   (14, resident_match.CHUNK * 40),
                                   (19, resident_match.N_BATCH)],
                         ids=["small", "mid", "default"])
def test_resident_match_kernel(cuda, lgB, n):
    host = _planted_match_inputs(n, lgB, seed=lgB)
    args = _on(cuda, *resident_match.probe_inputs(*host))
    got = resident_match.resident_match(*args)
    equal([got], [resident_match.resident_match_plain(*args)])
    equal([got], [resident_match.match_gather(*_on(cuda, *host))])
    got32 = got.view(torch.int32)
    assert int(got32[0, 0]) == 3 and int(got32[1, 1]) == 105 | (213 << 16)


@pytest.mark.parametrize("case", ["every_bucket_matches", "all_invalid",
                                  "unaligned"])
def test_resident_match_kernel_extremes(cuda, case):
    """P2 where every probe's bucket matches in all 8 slots (tags 1-3,
    pays summed past 16 bits), where every want is the invalid sentinel,
    and with rows and want off their 16-byte boundary: equal to the plain
    version and to the gather+match."""
    lgB, n = 12, resident_match.CHUNK * 8
    table, bucket, rest, valid = resident_match.build_inputs(n, lgB, seed=5)
    if case == "every_bucket_matches":
        rng = np.random.default_rng(6)
        key = np.uint64(0x2A5)
        tag = rng.integers(1, 4, size=table.shape).astype(np.uint64)
        pay = rng.integers(0, 1 << 16, size=table.shape).astype(np.uint64)
        table[:] = (tag << np.uint64(30) | key << np.uint64(16) | pay).astype(
            np.uint32)
        rest[:] = key
        valid[:] = True
    elif case == "all_invalid":
        valid[:] = False
    args = _on(cuda, *resident_match.probe_inputs(table, bucket, rest, valid))
    if case == "unaligned":
        args[0], args[1] = _misaligned(args[0]), _misaligned(args[1])
    got = resident_match.resident_match(*args)
    equal([got], [resident_match.resident_match_plain(*args)])
    equal([got], [resident_match.match_gather(*_on(cuda, table, bucket, rest,
                                                   valid))])
    got32 = got.view(torch.int32)
    if case == "every_bucket_matches":
        assert bool((got32[:, 0] != 0).all())
    if case == "all_invalid":
        assert not bool((got32 != 0).any())


def test_experiment_wrappers_refuse(cuda):
    tiles = torch.zeros((64, 128), dtype=torch.uint32, device=cuda)
    idx = torch.zeros(gather_tiles.CHUNK, dtype=torch.int32, device=cuda)
    rows = torch.zeros(resident_match.CHUNK, dtype=torch.int32, device=cuda)
    want = torch.zeros(resident_match.CHUNK, dtype=torch.uint32, device=cuda)
    t128 = torch.zeros((16, 128), dtype=torch.uint32, device=cuda)
    for call, err in (
        (lambda: gather_tiles.gather_tiles(tiles.view(torch.int32), idx),
         TypeError),
        (lambda: gather_tiles.gather_tiles(tiles, idx.long()), TypeError),
        (lambda: gather_tiles.gather_tiles(tiles.cpu(), idx), ValueError),
        (lambda: gather_tiles.gather_tiles(tiles, idx[:-8]), ValueError),
        (lambda: resident_match.resident_match(rows.long(), want, t128),
         TypeError),
        (lambda: resident_match.resident_match(rows, want.view(torch.int32),
                                               t128), TypeError),
        (lambda: resident_match.resident_match(rows, want, t128.cpu()),
         ValueError),
        (lambda: resident_match.resident_match(rows[:-8], want[:-8], t128),
         ValueError),
    ):
        with pytest.raises(err):
            call()


def test_experiment_kernels_launch_on_the_current_stream(cuda):
    """Each kernel runs on the caller's current stream: its inputs are
    written on a side stream after a long sleep there, so a kernel
    launched anywhere else would read the stale ones."""
    table, tiles, idx = _on(cuda, *gather_tiles.make_inputs(12, 16, seed=4))
    host = _planted_match_inputs(resident_match.CHUNK * 4, 14, seed=4)
    rows, want, t128 = _on(cuda, *resident_match.probe_inputs(*host))
    stale_idx = torch.zeros_like(idx)
    stale_want = torch.full_like(want, resident_match.INVALID)
    torch.cuda.synchronize()
    side = torch.cuda.Stream(cuda)
    with torch.cuda.stream(side):
        torch.cuda._sleep(1 << 27)
        stale_idx.copy_(idx)
        stale_want.copy_(want)
        tiles_got = gather_tiles.gather_tiles(tiles, stale_idx)
        match_got = resident_match.resident_match(rows, stale_want, t128)
    side.synchronize()
    equal([tiles_got], [gather_tiles.gather_tiles_plain(tiles, idx)])
    equal([match_got], [resident_match.resident_match_plain(rows, want,
                                                            t128)])


# ---------------------------------------------------------------------------
# The replicated index on the card, and --backend native beside it
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("probe", ["hashed", "xl", "classic"])
def test_data_parallel_on_one_card_matches_one_classifier(cuda, probe):
    """DataParallelClassifier over [cuda:0, cuda:0] (one copy of the
    tables, each half of the batch launched in turn): one Classifier's
    verdicts over the whole batch, on the byte and the packed wire, the
    same association pairs, and each kernel launched once a half (K3's
    group pass too, where the index has group ids). On the hashed batch
    here the first half alone would take GROUP verdicts and the whole
    batch takes none: the halves' counts are summed on the card."""
    from shark_tpu_torch import kernels, pipeline
    from shark_tpu_torch.classify.step import PACK_GRP_SHIFT
    from shark_tpu_torch.parallel.data_parallel import DataParallelClassifier

    if probe == "hashed":
        records, index = family_index(singles=20)
        rng = np.random.default_rng(3)
        reads = (reads_from(rng, records[:40], 600, 100, 160)
                 + reads_from(rng, records, 424, 0, 400))
    else:
        genes, index = txome_like_index(17, 1 << 26)
        rng = np.random.default_rng(8)
        reads = [g[s:s + 90].tobytes() for g, s in zip(
            genes[rng.integers(0, 64, size=1024)],
            rng.integers(0, 1100, size=1024))]
    codes = encode(reads)
    one = Classifier(index, max_winners=8, device=cuda, probe=probe)
    dp = DataParallelClassifier(index, max_winners=8, devices=[cuda, cuda],
                                probe=probe)
    assert dp.probe == one.probe == probe
    assert dp._replicas[0] is dp._replicas[1]
    want = one(codes)
    if probe == "hashed":
        def n_group(r):
            return int(((r[0] >> PACK_GRP_SHIFT) & 1).sum())

        assert n_group(want) == 0 and n_group(one(codes[:512])) > 0
    kernels.LAUNCHES.reset()
    got = dp(codes)
    launched = kernels.LAUNCHES.snapshot()
    assert all(t.device == cuda for t in got)
    equal(got, want)
    path = {"hashed": "probe", "xl": "probe_xl", "classic": "classic"}[probe]
    assert launched["front"] == launched[path] == 2
    assert launched["finish"] == (4 if dp._grouped(96) else 2)
    packed, vmask = step.pack_codes(torch.from_numpy(codes))
    equal(dp.call_packed(packed.numpy(), vmask.numpy()), want)
    cfg = SharkConfig(c=0.6)
    pairs = [pipeline._winner_pairs(cfg, index, r, len(reads), codes, 8,
                                    groups=one.groups)
             for r in (want, got)]
    assert len(pairs[0][0]) > 0
    for a, b in zip(*pairs):
        np.testing.assert_array_equal(a, b)


def test_backend_native_launches_nothing_on_a_card_machine(cuda, tmp_path):
    """--backend native on a machine with a card: the same bytes as the
    card's run, no kernel launch, and no CUDA memory taken."""
    from shark_tpu_torch import cli, kernels

    records, _ = family_index(singles=10)
    fa = tmp_path / "g.fa"
    fa.write_bytes(b"".join(b">%s\n%s\n" % (n.encode(), s)
                            for n, s in records))
    rng = np.random.default_rng(12)
    fq = tmp_path / "r.fq"
    fq.write_bytes(b"".join(b"@r%d\n%s\n+\n%s\n" % (i, r, b"I" * len(r))
                            for i, r in enumerate(
                                reads_from(rng, records, 900, 0, 400))))
    outs = {}
    for backend in ("", "native"):
        kernels.LAUNCHES.reset()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        tag = backend or "gpu"
        argv = ["-r", str(fa), "-1", str(fq), "-k", "15", "-o",
                str(tmp_path / f"{tag}.fq"), "--ssv",
                str(tmp_path / f"{tag}.ssv"), "--batch-size", "256"]
        assert cli.main(argv + (["--backend", backend] if backend else [])) == 0
        outs[tag] = [(tmp_path / f"{tag}{x}").read_bytes()
                     for x in (".ssv", ".fq")]
        if backend == "native":
            assert kernels.LAUNCHES.snapshot() == {
                n: 0 for n in kernels.KERNELS}
            assert torch.cuda.memory_allocated() == before
        else:
            assert kernels.LAUNCHES.snapshot()["front"] > 0
    assert outs["gpu"][0] and outs["native"] == outs["gpu"]
