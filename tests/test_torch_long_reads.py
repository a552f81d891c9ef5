"""Reads longer than 16384 bases through shark_tpu_torch, against shark_tpu.

The port's front end takes a second CUDA kernel for reads over 16384
bases (csrc/front.cu); on the CPU both lengths run the plain version, which
must equal shark_tpu's unpack_codes + bloom_positions at L = 16392 and
32768. A `--backend cpu` CLI run on a sample holding one read over 16384
bases (its batch padded to 32768) must write shark_tpu's bytes. The
kernel itself is held against the plain version by tests/test_torch_cuda.py
and chip_smoke.py on the card."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from shark_tpu.classify import step as jstep  # noqa: E402
from shark_tpu_torch.classify import step as tstep  # noqa: E402
from test_torch_front import _Meta, planar_pack, random_codes  # noqa: E402
from test_torch_threads import one_torch_thread  # noqa: E402,F401

BASES = np.frombuffer(b"ACGT", np.uint8)


@pytest.mark.parametrize("k", [11, 17, 31])
@pytest.mark.parametrize("L", [16392, 32768])
def test_long_front_end_matches_shark_tpu(L, k):
    rng = np.random.default_rng(L + k)
    codes = random_codes(rng, 3, L)
    codes[0, L - 40:] = 4  # the longest read ends in padding
    codes[1] = rng.integers(0, 4, size=L)  # one read of L bases, no N
    packed, vmask = planar_pack(codes)
    meta = _Meta(k, 3 << 33)
    codes_j = jstep.unpack_codes(jnp.asarray(packed), jnp.asarray(vmask))
    want = [np.asarray(x) for x in jstep.bloom_positions(codes_j, meta)]
    want.append(np.asarray((codes_j < 4).sum(axis=1)))
    got = tstep.front_end(torch.from_numpy(packed), torch.from_numpy(vmask),
                          meta)
    assert got[0].shape == (3, L - (k - 1))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert want[2][1].all()


def long_read_sample(tmp_path, rng):
    """Twelve 1500 bp genes and one of 20000, 60 reads of 90 bp and one of
    17000 bases (with Ns) from the long gene."""
    genes = [BASES[rng.integers(0, 4, size=1500)] for _ in range(12)]
    genes.append(BASES[rng.integers(0, 4, size=20000)])
    fa = tmp_path / "genes.fa"
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
    fq = tmp_path / "reads.fq"
    fq.write_bytes(b"".join(recs))
    return str(fa), str(fq)


def test_cli_long_read_matches_shark_tpu(tmp_path, monkeypatch):
    """`--backend cpu` through the port's CLI entry point writes the ssv
    and FASTQ bytes of shark_tpu's CLI with the same flags; the 17000-base
    read emits. Both packages' -b unit is shrunk to 2^20 bits."""
    from shark_tpu import cli as jcli
    from shark_tpu import config as jconfig
    from shark_tpu_torch import cli as tcli
    from shark_tpu_torch import config as tconfig

    monkeypatch.setattr(jconfig, "BF_UNIT_BITS", 1 << 20)
    monkeypatch.setattr(tconfig, "BF_UNIT_BITS", 1 << 20)
    fa, fq = long_read_sample(tmp_path, np.random.default_rng(61))
    outs = {}
    for tag, cli in (("jax", jcli), ("torch", tcli)):
        argv = ["-r", fa, "-1", fq, "-o", str(tmp_path / f"{tag}.fq"),
                "--ssv", str(tmp_path / f"{tag}.ssv"), "-k", "17", "-c",
                "0.5", "-b", "1", "--backend", "cpu", "--batch-size", "16",
                "--compile-cache", ""]
        assert cli.main(argv) == 0
        outs[tag] = [(tmp_path / f"{tag}{x}").read_bytes()
                     for x in (".ssv", ".fq")]
    assert b"r023 g12" in outs["jax"][0], "the long read did not emit"
    assert outs["torch"] == outs["jax"]
