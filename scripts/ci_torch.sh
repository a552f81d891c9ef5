#!/usr/bin/env bash
# CI-style gate of shark_tpu_torch: the native engine's build gate, the
# port's CPU tests and golden CLI equality through --backend cpu; with
# --cuda also the kernel library's build gate, the card suite, the golden
# run on the card and a 20-seed differential soak on the card.
# Usage: scripts/ci_torch.sh [--cuda]
set -euo pipefail
cd "$(dirname "$0")/.."

cuda=0
if [[ "${1:-}" == "--cuda" ]]; then
  cuda=1
elif [[ -n "${1:-}" ]]; then
  echo "usage: scripts/ci_torch.sh [--cuda]" >&2
  exit 2
fi
EXAMPLE=/root/reference/example

echo "== native engine gate =="
# Fail LOUDLY when g++ exists but the engine does not build: every native
# test would skip and the CLI would quietly take the Python path.
python3 - <<'EOF'
import shutil, sys
if shutil.which("g++") is None:
    print("no g++ on PATH; Python fallback (correctness-only) mode")
else:
    from shark_tpu_torch.io import native
    try:
        native.rebuild()
    except RuntimeError as e:
        print(f"FATAL: g++ present but the native engine failed to build: {e}",
              file=sys.stderr)
        sys.exit(1)
    if not native.available():
        print("FATAL: the native engine built but does not load",
              file=sys.stderr)
        sys.exit(1)
    print("native engine: OK")
EOF

if [[ $cuda == 1 ]]; then
  echo "== kernel library gate =="
  # Fail LOUDLY when nvcc exists but the kernels do not build, and when
  # there is no card to run them on.
  python3 - <<'EOF'
import sys
import torch
from shark_tpu_torch import kernels
if not torch.cuda.is_available():
    print("FATAL: --cuda given but there is no CUDA device", file=sys.stderr)
    sys.exit(1)
try:
    nvcc = kernels.nvcc_path()
except RuntimeError as e:
    print(f"FATAL: {e}", file=sys.stderr)
    sys.exit(1)
try:
    secs, _ = kernels.build(force=True)
    kernels.lib()
except RuntimeError as e:
    print(f"FATAL: nvcc present ({nvcc}) but the kernels failed to "
          f"build:\n{e}", file=sys.stderr)
    sys.exit(1)
print(f"kernel library: OK ({secs:.1f} s, {torch.cuda.get_device_name(0)})")
EOF
fi

echo "== the port's CPU tests =="
if python3 -c "import jax" 2>/dev/null; then
  python3 -m pytest tests/test_torch_*.py -q -m "not slow and not cuda"
else
  # tests/conftest.py imports jax, and so does shark_tpu: without jax the
  # port's tests run under --noconftest, and the files and cases that
  # compare with shark_tpu skip
  echo "no jax here: the port's tests that compare with shark_tpu skip"
  python3 -m pytest --noconftest tests/test_torch_*.py -q \
    -m "not slow and not cuda"
fi

golden() {  # golden CLI equality; $1 = extra flags, $2 = label
  local out
  out=$(mktemp -d)
  # shellcheck disable=SC2086
  python3 -m shark_tpu_torch $1 \
    -r "$EXAMPLE/ENSG00000277117.fa" \
    -1 "$EXAMPLE/sample_1.fq" -2 "$EXAMPLE/sample_2.fq" \
    -o "$out/out1.fq" -p "$out/out2.fq" > "$out/out.ssv"
  diff "$out/out.ssv" "$EXAMPLE/ENSG00000277117.truth.ssv"
  diff "$out/out1.fq" "$EXAMPLE/sharked.sample_1.truth.fq"
  diff "$out/out2.fq" "$EXAMPLE/sharked.sample_2.truth.fq"
  rm -rf "$out"
  echo "golden ($2): OK"
}

echo "== golden CLI equality (--backend cpu) =="
if [[ -d $EXAMPLE ]]; then
  golden "--backend cpu" "--backend cpu"
else
  echo "SKIPPED: the reference example ($EXAMPLE) is not here"
fi

if [[ $cuda == 1 ]]; then
  echo "== card suite =="
  # the card machine has no jax, which tests/conftest.py imports
  timeout 900 python3 -m pytest --noconftest -m cuda -q \
    -o faulthandler_timeout=120 tests/test_torch_cuda.py

  echo "== golden on the card =="
  if [[ -d $EXAMPLE ]]; then
    golden "" "the card"
  else
    echo "SKIPPED: the reference example ($EXAMPLE) is not here"
  fi

  echo "== differential soak on the card (20 seeds) =="
  timeout 1200 python3 scripts/fuzz_soak_torch.py 20
fi
echo "CI gate passed"
