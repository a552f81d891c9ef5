"""Multi-host deployment helpers: the port's counterpart of
shark_tpu/parallel/distributed.py.

- **Runtime**: one process per host, joined into one torch.distributed
  process group (gloo, over TCP to the coordinator; host 0 listens there).
  The classify path needs no collective: each host runs its own cards
  (the replicated index, or the sharded Bloom filter, within the host)
  on its own input files. The group makes the hosts start together and
  lets each one know the run's shape.
- **Input sharding**: by FILE. Each host streams its assigned (pairs of)
  FASTQ files and writes one output part per file pair, named by the
  pair's GLOBAL index (`out.ssv.part3`, ...). Concatenating the parts in
  global index order reproduces the output one host would write
  processing the files in order, however pairs were assigned to hosts.

Typical launch (per host), via `run_files`:

    initialize(coordinator, n_hosts, host_id)
    run_files(cfg, all_pairs, host_id, n_hosts)   # writes this host's parts
    # after all hosts finish (shared filesystem / artifact copy):
    merge_parts(cfg.ssv_path, len(all_pairs))     # on the merging host

For one file pair per host the CLI's --host-id suffixing
(shark_tpu_torch/cli.py) is the same thing: part index == host index.

host_suffixed, assign_files, run_files, merge_parts and merge_outputs are
the port's own copies of shark_tpu's.
"""

from __future__ import annotations

from dataclasses import replace
from datetime import timedelta
from typing import List, Sequence, Tuple

FilePair = Tuple[str, str]

# How long a host waits for the others to join (and, at the end, to
# finish); a host that never comes fails the run instead of hanging it.
JOIN_TIMEOUT_S = 300


def host_suffixed(path: str, part: int | str) -> str:
    """Insert a per-host/per-part suffix BEFORE a trailing '.gz' so the
    gzip-by-extension detection in both output engines still fires
    ('x.fq.gz' -> 'x.fq.0.gz', 'x.fq' -> 'x.fq.0')."""
    if path.endswith(".gz"):
        return f"{path[:-3]}.{part}.gz"
    return f"{path}.{part}"


def initialize(
    coordinator_address: str, num_processes: int, process_id: int
) -> None:
    """Join the multi-host process group (idempotent per process).
    `coordinator_address` is host:port of host 0, which listens there."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    dist.init_process_group(
        "gloo",
        init_method=f"tcp://{coordinator_address}",
        rank=process_id,
        world_size=num_processes,
        timeout=timedelta(seconds=JOIN_TIMEOUT_S),
    )


def shutdown(wait: bool = True) -> None:
    """Leave the process group. `wait` first waits for every host to get
    here (a host that failed has closed its connections, so the others
    fail fast instead of waiting out the timeout); host 0 holds the
    rendezvous, so it must not leave while another host still needs it."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return
    try:
        if wait:
            dist.barrier()
    finally:
        dist.destroy_process_group()


def assign_files(
    pairs: Sequence[FilePair], num_hosts: int
) -> List[List[Tuple[int, FilePair]]]:
    """Deterministic round-robin assignment of (global index, file pair) to
    hosts.

    Round-robin (not contiguous blocks) so heterogeneous file sizes spread
    evenly; assignment depends only on (pairs order, num_hosts), so every
    host computes the same global view without communication. The global
    index travels with the pair because merge order is INDEX order, not
    host order (host order would interleave f0,f3,... before f1)."""
    out: List[List[Tuple[int, FilePair]]] = [[] for _ in range(num_hosts)]
    for i, p in enumerate(pairs):
        out[i % num_hosts].append((i, p))
    return out


def run_files(cfg, pairs: Sequence[FilePair], host_id: int, num_hosts: int):
    """Run the pipeline over this host's assigned file pairs, one output
    part per pair named by its global index. Returns the list of
    (global index, stats) produced."""
    from shark_tpu_torch.pipeline import run_pipeline

    cfg.finalize_outputs()
    results = []
    for gi, (fq1, fq2) in assign_files(pairs, num_hosts)[host_id]:
        part_cfg = replace(
            cfg,
            sample1_path=fq1,
            sample2_path=fq2 or "",
            ssv_path=host_suffixed(cfg.ssv_path, f"part{gi}")
            if cfg.ssv_path
            else "",
            out1_path=host_suffixed(cfg.out1_path, f"part{gi}"),
            out2_path=host_suffixed(cfg.out2_path, f"part{gi}")
            if cfg.out2_path
            else "",
        )
        results.append((gi, run_pipeline(part_cfg)))
    return results


def merge_parts(dest: str, n_parts: int, remove: bool = False) -> None:
    """Concatenate per-file-pair output parts in GLOBAL INDEX order,
    reproducing the deterministic single-host output. Run on one host
    after every part exists (shared filesystem, or copy parts first)."""
    merge_outputs(
        [host_suffixed(dest, f"part{i}") for i in range(n_parts)],
        dest,
        remove=remove,
    )


def merge_outputs(
    part_paths: Sequence[str], dest: str, remove: bool = False
) -> None:
    """Concatenate output parts in the given order."""
    import os

    with open(dest, "wb") as out:
        for p in part_paths:
            with open(p, "rb") as f:
                while True:
                    chunk = f.read(1 << 20)
                    if not chunk:
                        break
                    out.write(chunk)
    if remove:
        for p in part_paths:
            os.remove(p)
