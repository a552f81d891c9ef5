"""index.build_s: the FASTA to the program's index on the host
(shark_tpu_torch.pipeline.load_or_build_index: the C++ engine's build of
the Bloom filter, its ranks and the gene lists), timed by the harness in
set-up. Part of index_s."""


def read(ctx):
    return ctx.setup["index_build_s"]
