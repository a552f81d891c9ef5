"""step.call_ms.tail: step.call_ms (its own file says what it reads) in the
cells that report sample_ms_p95 and not reads_per_s, so that it moves an
end-to-end metric they report."""

import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "portbench_metric_step_call_ms",
    os.path.join(os.path.dirname(os.path.abspath(__file__)),
                 "step.call_ms.py"))
_base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_base)
read = _base.read
if hasattr(_base, "measure"):
    measure = _base.measure
