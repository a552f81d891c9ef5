"""shark_tpu_torch: the PyTorch/CUDA port of shark_tpu.

Mapping-free gene separation for RNA-Seq reads on an NVIDIA H100: index a
set of gene sequences as a k-mer Bloom filter with a k-mer -> gene-ID
association table, then stream FASTQ samples through the index and report,
per read, the gene(s) it most plausibly originates from — the same
command line, index format and output bytes as shark_tpu, which stays in
the repository as the reference.

The host layer (index build, FASTA/FASTQ I/O, the C++ engine, the oracle)
is shark_tpu's, copied so that importing this package never imports jax
or shark_tpu. The device work of the main path is four hand-written CUDA
kernels (csrc/): the front end, the hashed probe, the finish and the
winner-pair stream, each beside its plain PyTorch version.
"""

from shark_tpu_torch.config import SharkConfig
from shark_tpu_torch.index.structure import SharkIndex
from shark_tpu_torch.pipeline import load_or_build_index, run_pipeline

__version__ = "0.1.0"

__all__ = [
    "SharkConfig",
    "SharkIndex",
    "load_or_build_index",
    "run_pipeline",
    "__version__",
]
