"""Replicated-index data parallelism: the port's counterpart of
shark_tpu/parallel/data_parallel.py.

The reference's only parallelism is N worker threads pulling read batches
from a mutex-guarded queue against one shared in-memory index
(main.cpp:219-223). Here, as in shark_tpu, the index lives replicated on
every device and each batch is split along its read axis among them:
the probe path needs no communication, so the work scales with the
devices. shark_tpu lets XLA partition one jit over its mesh; the port
drives its device list from one process instead: part i of the batch runs
the classify kernels on device i, and the parts' results are joined, in
order, on the first device.
"""

from __future__ import annotations

import contextlib
import copy
from typing import List, Sequence

import torch

from shark_tpu_torch.classify.step import Classifier, fix_caps, planar
from shark_tpu_torch.index.structure import SharkIndex
from shark_tpu_torch.parallel.mesh import make_devices, norm_device
from shark_tpu_torch.utils.timers import span


def _on(device: torch.device, x):
    """A table tuple (or tensor) with every tensor copied to `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_on(device, v) for v in x))
    return x


class DataParallelClassifier:
    """Classifier over a device list: the index replicated on each device,
    each batch split along B into len(devices) equal contiguous parts.

    The probe tables are built once on the host, through Classifier (so
    the layout selection, threshold tables and kernels can never diverge
    from the one-device path, and every device takes the same layout), and
    copied to each distinct device. A device may repeat, as in
    ShardedBFClassifier: its entries share one copy of the tables, and
    [cuda:0, cuda:0] is how one card runs this path. `devices`: a list of
    devices (None = every card, cuda:0..N-1, make_devices' rule). Results
    are Classifier's tuple over the whole batch, on devices[0].

    The finish's choice of GROUP verdicts is batch-wide (at most FIX_CAP2
    impure row-hitting reads in the batch), so it is the whole batch's
    here too, as in shark_tpu's one jit over its mesh: K3's group pass
    counts each part's reads into one count per device, the counts are
    summed on devices[0] and the sum copied back, and each part's finish
    compares it with the whole batch's FIX_CAP2. The result is one
    Classifier's on the whole batch, bit for bit."""

    def __init__(
        self,
        index: SharkIndex,
        max_winners: int = 16,
        c: float = 0.6,
        devices: Sequence = None,
        probe=None,
        probe_opts=None,
    ):
        if devices is None:
            devices = make_devices(0)
        self.devices: List[torch.device] = [norm_device(d) for d in devices]
        if not self.devices:
            raise ValueError("DataParallelClassifier needs at least 1 device")
        self.n_devices = len(self.devices)
        base = Classifier(
            index, max_winners=max_winners, c=c, device=self.devices[0],
            probe=probe, probe_opts=probe_opts,
        )
        replicas = {self.devices[0]: base}
        for d in self.devices[1:]:
            if d not in replicas:
                r = copy.copy(base)
                r.device = d
                r.dix = _on(d, base.dix)
                r._meta, r._thresh = {}, {}
                replicas[d] = r
        self._replicas = [replicas[d] for d in self.devices]
        self.index = index
        self.max_winners = max_winners
        self.c = c
        self.device = self.devices[0]
        self.probe = base.probe
        self.groups = base.groups

    def _check_b(self, B: int) -> None:
        if B % self.n_devices != 0:
            raise ValueError(
                f"batch size {B} not divisible by {self.n_devices} devices"
            )

    def _grouped(self, L: int) -> bool:
        """Whether the finish makes a group choice at read length L."""
        base = self._replicas[0]
        return bool(base._has_rows and base._geometry(L)[0].rows_bits)

    def _split(self, *batch):
        """K1 and the probe on each part, on its device; the parts' group
        counts summed into the whole batch's; K3 on each part with the
        batch's group choice; the results joined on devices[0]. Each part
        launches on its device's current stream; a copy between devices
        is ordered after the work queued on both (PyTorch's rule). The
        parts' copies to their cards are the pass's spans "h2d", the rest
        one span "launch"."""
        B = batch[0].shape[0]
        self._check_b(B)
        n = B // self.n_devices
        if self.n_devices == 1:
            return self._replicas[0].call_packed(*batch)
        ups = []
        for i, r in enumerate(self._replicas):
            with _on_card(r.device):
                ups.append(r.upload(*(torch.as_tensor(x)[i * n:(i + 1) * n]
                                      for x in batch)))
        with span("launch"):
            parts = []
            for r, u in zip(self._replicas, ups):
                with _on_card(r.device):
                    parts.append(r.tags_on_device(*u))
            n_fix, fix_cap2 = {}, None
            if self._grouped(parts[0][3]):
                for r, t in zip(self._replicas, parts):
                    with _on_card(r.device):
                        if r.device not in n_fix:
                            n_fix[r.device] = torch.zeros(
                                1, dtype=torch.int32, device=r.device)
                        r.group_count(t, n_fix[r.device])
                total = None
                for c in n_fix.values():
                    c = c.to(self.device)
                    total = c if total is None else total + c
                n_fix = {d: total.to(d) for d in n_fix}
                fix_cap2 = fix_caps(B)[1]
            outs = []
            for r, t in zip(self._replicas, parts):
                with _on_card(r.device):
                    outs.append(r.finish(t, n_fix=n_fix.get(r.device),
                                         fix_cap2=fix_cap2))
            return tuple(
                torch.cat([o[j].to(self.device) for o in outs])
                for j in range(len(outs[0]))
            )

    def __call__(self, codes):
        """codes: uint8 [B, L] -> Classifier's (packed, winners, best_cov,
        length) over the whole batch, on devices[0]."""
        return self.call_packed(*planar(codes, self.device))

    def call_packed(self, packed, vmask):
        """packed u8[B, L/4] + validity u8[B, L/8] -> result tuple."""
        return self._split(packed, vmask)


def _on_card(device: torch.device):
    """The device context a launch on `device` needs (its CUDA device made
    current; nothing on the host)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
