"""index.tables_s: the index to a classifier ready on the card (the probe
layout's tables built on the host and copied over: classify/hashed.py,
step.py build_device_index), timed by the harness in set-up, synchronised.
Part of index_s."""


def read(ctx):
    return ctx.setup["index_tables_s"]
