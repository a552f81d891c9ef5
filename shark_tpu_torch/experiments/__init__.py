"""The port's counterparts of the repository's two Pallas experiments.

bench/pallas_probe.py (the per-probe tile gather) and
bench/pallas_vmem_match.py (the bucket match against a resident table)
are the only pl.pallas_call kernels in the repository. Each has a module
here with its kernel's wrapper (csrc/gather_tiles.cu,
csrc/resident_match.cu), the plain PyTorch version beside it, the inputs
of its harness, and an entry point that runs the harness on the card:

    python -m shark_tpu_torch.experiments.gather_tiles [n_log2] [rows_log2]
    python -m shark_tpu_torch.experiments.resident_match

(--cpu runs the plain versions at a small size and stops after the
check). No classify path launches these kernels. The rest of bench/ is
not ported.
"""
