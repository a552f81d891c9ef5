"""Run configuration.

Mirrors the reference CLI surface and defaults (reference:
argument_parser.hpp:49-63, 84-174): -r/-1 required; -2 enables paired mode;
k in [1, 31]; c in [0, 1]; bf size given in "GB" units where 1 unit equals
2**33 bits of Bloom bit-vector (argument_parser.hpp:130-133).

The fields are those of shark_tpu's SharkConfig, so a config can be built
from either package's CLI. Options whose code path is not in the PyTorch
port yet are rejected by validate() with NotImplementedError, never
ignored: the multi-device modes, --backend native and --profile-dir, and
the xl/classic probe layouts.
"""

from __future__ import annotations

from dataclasses import dataclass

# One "-b" unit = 2**33 bits (1 GiB of bit-vector), reference
# argument_parser.hpp:133.
BF_UNIT_BITS = 1 << 33

NOT_PORTED = "is not in the port yet"


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error every deferred option raises: what was asked for and the
    ROADMAP.md open item that will port it."""
    return NotImplementedError(
        f"{what} {NOT_PORTED} (ROADMAP.md open item: {item})"
    )


@dataclass
class SharkConfig:
    fasta_path: str = ""
    sample1_path: str = ""
    sample2_path: str = ""
    out1_path: str = ""
    out2_path: str = ""
    k: int = 17
    c: float = 0.6
    bf_gb: int = 1  # Bloom filter size in units of 2**33 bits
    min_quality: int = 0
    single: bool = False
    verbose: bool = False
    threads: int = 1  # accepted for CLI parity; host I/O worker count

    # Device-execution knobs (no reference analogue).
    batch_size: int = 8192  # reads per device batch
    # 0 = auto: the native path pre-scans the sample (parse-only pass) for
    # the exact max fused length; the Python path pads per batch.
    max_read_len: int = 0
    max_winners: int = 16  # per-read winner-compaction width on device
    # "" = the CUDA card (cuda:0; raises when there is none); "cpu" runs
    # every kernel's plain PyTorch version on the host
    backend: str = ""
    devices: int = 1  # data-parallel device count (only 1 is ported)
    sharded_bf: bool = False  # not ported
    save_index: str = ""  # optional path to serialize the built index
    load_index: str = ""  # optional path to load a prebuilt index
    ssv_path: str = ""  # write ssv here instead of stdout (native path)
    use_native: bool = True  # use the C++ host I/O engine when available
    profile_dir: str = ""  # not ported
    # Probe-path selection: "auto" and "hashed" use the hashed one-gather
    # bucket table; an index that cannot build it (where shark_tpu would
    # fall back to xl or classic) raises, as do "xl" and "classic".
    probe: str = "auto"
    # Batches per device->host verdict fetch (1 = per-batch fetches).
    fetch_group: int = 1
    # Checkpoint/resume (native path; no reference analogue): writes a
    # <ssv>.progress sidecar per drained batch and restarts an interrupted
    # run from the last checkpoint, byte-identically.
    resume: bool = False
    fail_after_batches: int = 0  # test hook: inject a crash mid-sample
    # Kept for CLI parity with shark_tpu (its persistent XLA compile
    # cache). It has no effect here: PyTorch runs eagerly, and the CUDA
    # kernels are built once into build/shark_tpu_torch/.
    compile_cache: str = "~/.cache/shark_tpu/xla"

    @property
    def paired(self) -> bool:
        return bool(self.sample2_path)

    @property
    def bf_bits(self) -> int:
        return self.bf_gb * BF_UNIT_BITS

    def validate(self) -> None:
        if not (1 <= self.k <= 31):
            raise ValueError("k must be in the range [1, 31]")
        if not (0.0 <= self.c <= 1.0):
            raise ValueError("c must be in the range [0, 1]")
        if self.min_quality < 0:
            raise ValueError("q must be a positive value")
        if self.threads <= 0:
            raise ValueError("at least 1 thread is required")
        if self.bf_gb < 1:
            raise ValueError("bf size must be >= 1 GB unit")
        if self.probe not in ("auto", "hashed", "xl", "classic"):
            raise ValueError(
                "probe must be one of: auto, hashed, xl, classic"
            )
        if not (1 <= self.fetch_group <= 6):
            # the native prefetch ring (kRing = 20) must cover
            # group * (lookahead_depth + 2) pinned batches; shk_next also
            # guards against wrap at runtime, but fail fast here
            raise ValueError("fetch_group must be in [1, 6]")
        if self.backend == "native":
            raise not_ported("--backend native", "--backend native")
        if self.backend not in ("", "cpu"):
            raise ValueError("backend must be '' (the CUDA card) or 'cpu'")
        if self.profile_dir:
            raise not_ported("--profile-dir", "--profile-dir")
        if self.probe in ("xl", "classic"):
            raise not_ported(
                f"--probe {self.probe}",
                "xl probe" if self.probe == "xl" else "classic probe",
            )
        if self.sharded_bf:
            raise not_ported("--sharded-bf", "sharded Bloom filter")
        if self.devices > 1:
            raise not_ported("--devices > 1", "multi-GPU")

    def finalize_outputs(self) -> None:
        """Apply the reference's output-path defaults
        (argument_parser.hpp:168-173)."""
        if self.out1_path == "":
            self.out1_path = "sharked_sample.1"
        if self.out2_path == "" and self.sample2_path != "":
            self.out2_path = "sharked_sample.2"
