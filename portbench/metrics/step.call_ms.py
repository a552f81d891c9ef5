"""step.call_ms: one resident batch of the cell's own B and L, the
sample's first, through Classifier.call_packed and the blocking fetch of
its packed verdicts to the host, with no engine, drain or emit. A host
time, not a device time: it holds the launches, the kernels and the wait
for the copy back. Timed after the window, by the host's clock over
groups of calls that each last 0.25 s or more; the median of the groups'
means."""

import statistics
import time

GROUPS = 7
GROUP_S = 0.25


def measure(ctx):
    import torch
    from shark_tpu_torch.io.native import NativeStream

    cfg, clf = ctx.cfg, ctx.clf
    if not hasattr(clf, "call_packed") or ctx.read_len % 8:
        return
    ns = NativeStream(cfg.sample1_path, cfg.sample2_path, cfg.batch_size,
                      ctx.read_len, cfg.min_quality, packed=True)
    try:
        packed, vmask, _, _ = ns.next_batch()
    finally:
        ns.close()
    pk = torch.from_numpy(packed).to(ctx.device)
    vm = torch.from_numpy(vmask).to(ctx.device)

    def call():
        clf.call_packed(pk, vm)[0].cpu()

    call()
    t = time.perf_counter()
    call()
    reps = max(1, int(GROUP_S / max(time.perf_counter() - t, 1e-6)) + 1)
    means = []
    for _ in range(GROUPS):
        t = time.perf_counter()
        for _ in range(reps):
            call()
        means.append(1e3 * (time.perf_counter() - t) / reps)
    ctx.measured["step.call_ms"] = statistics.median(means)


def read(ctx):
    return ctx.measured.get("step.call_ms")
