"""Device lists: the port's counterpart of shark_tpu/parallel/mesh.py.

shark_tpu lays its devices out as a one-axis jax Mesh. The port drives
every device from one process, so its "mesh" is a plain list of
torch.device, one entry per shard or replica.
"""

from __future__ import annotations

from typing import List

import torch


def make_devices(n_devices: int = 0, device=None) -> List[torch.device]:
    """The first `n_devices` devices of `device`'s type (make_mesh's
    rule: 0 means all of them; more than there are raises ValueError).
    `device`: None is the CUDA card, cuda:0..N-1 (raises RuntimeError
    without one); "cpu" is the host, which counts as one device."""
    from shark_tpu_torch.classify.step import resolve_device

    kind = resolve_device(device).type
    if kind == "cuda":
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    elif kind == "cpu":
        devs = [torch.device("cpu")]
    else:
        raise ValueError(f"unsupported device type {kind!r}")
    if n_devices < 0:
        raise ValueError(f"requested {n_devices} devices")
    if n_devices == 0:
        n_devices = len(devs)
    if n_devices > len(devs):
        raise ValueError(f"requested {n_devices} devices, have {len(devs)}")
    return devs[:n_devices]


def norm_device(d) -> torch.device:
    """torch.device(d), with a bare "cuda" named by its index, so that a
    device list's repeats compare equal."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d
