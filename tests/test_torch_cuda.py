"""The CUDA kernels of shark_tpu_torch against their plain versions, on a
card. Marked `cuda`; without a CUDA device every test skips.

chip_smoke.py holds each kernel against its plain version at the main
paths' shapes. These tests cover the modes those paths do not reach: the
entry8 table, the extension-row geometry, the finish's global-scratch key
buffer for wide geometries, every group tier, k and Bloom-size variants
of the front end and of the classic and xl probes, the xl geometries
with and without a side table, reads shorter than k, the sharded Bloom
filter's routing kernels at n in {1, 2, 8} shards, narrow and wide, with
and without overflow (and reprobe from another thread on another
stream), whole pipelines on random workloads, and the two experiment
kernels (P1, P2) at small, mid and default sizes, P1 at a row count that
is not a power of two, their refusals and their stream. Inputs are made with numpy from seeds; results must be equal,
bit for bit.

On a machine with a card (and without jax, which tests/conftest.py
imports), run:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

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
@pytest.mark.parametrize("k,L", [(11, 8), (15, 104), (17, 208), (31, 256)])
def test_front_end_kernel(cuda, k, L, size_bits):
    rng = np.random.default_rng(k * L)
    codes = rng.integers(0, 5, size=(300, L)).astype(np.uint8)
    packed, vmask = step.pack_codes(torch.from_numpy(codes).to(cuda))
    meta = _Meta(k, size_bits)
    equal(step.front_end(packed, vmask, meta),
          step.front_end_plain(packed, vmask, meta))


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
        equal(sharded_bf.shard_return(back, k7a[2], k7a[1]),
              sharded_bf.shard_return_plain(back, k7a[2], k7a[1]))
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
