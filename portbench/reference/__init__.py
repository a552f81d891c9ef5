"""The benchmark's plain reference of shark: its own FASTA/FASTQ parse,
XXH64, Bloom addressing, index and classification, in plain PyTorch.
It imports nothing of the program under test."""
