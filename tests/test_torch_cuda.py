"""The CUDA kernels of shark_tpu_torch against their plain versions, on a
card. Marked `cuda`; without a CUDA device every test skips.

chip_smoke.py holds each kernel against its plain version at the main
path's shapes. These tests cover the modes that path does not reach: the
entry8 table, the extension-row geometry, the finish's global-scratch key
buffer for wide geometries, every group tier, k and Bloom-size variants
of the front end, reads shorter than k, and whole pipelines on random
workloads. Inputs are made with numpy from seeds; results must be equal,
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
from shark_tpu_torch.index.build import build_index
from shark_tpu_torch.ops.kmers import encode_bytes
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
