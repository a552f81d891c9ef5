"""Feeding shark_tpu's host-side structures to the port.

There are no weights: the parameters of a run are the index and its probe
tables. These two functions take them as the numpy arrays shark_tpu holds,
so a test can give both packages identical inputs. The saved-index formats
(.npz and directory) are the same in both packages, so an index saved by
either loads in the other through SharkIndex.load.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from shark_tpu_torch.classify.hashed import (  # noqa: F401 (re-export)
    hashed_device_index,
)
from shark_tpu_torch.index.structure import SharkIndex


def index_from_arrays(arrays: Dict[str, object]) -> SharkIndex:
    """A SharkIndex from a shark_tpu SharkIndex's fields (k, size_bits,
    bf_words, word_rank, offsets, gene_ids, gene_names), e.g.
    vars(shark_tpu_index). The arrays are shared, not copied."""
    names = arrays["gene_names"]
    return SharkIndex(
        k=int(arrays["k"]),
        size_bits=int(arrays["size_bits"]),
        bf_words=np.asarray(arrays["bf_words"], dtype=np.uint32),
        word_rank=np.asarray(arrays["word_rank"], dtype=np.uint32),
        offsets=np.asarray(arrays["offsets"], dtype=np.int32),
        gene_ids=np.asarray(arrays["gene_ids"], dtype=np.uint16),
        gene_names=[str(n) for n in names],
    )


__all__ = ["hashed_device_index", "index_from_arrays"]
