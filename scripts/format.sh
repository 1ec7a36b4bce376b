#!/usr/bin/env bash
# Formatting entry point (the analog of the reference's scripts/format.sh,
# which runs nightly rustfmt).  Uses black/ruff when installed; otherwise
# runs the stdlib-only style gate so the check is runnable on any box.
set -euo pipefail
cd "$(dirname "$0")/.."

if command -v ruff >/dev/null 2>&1; then
    exec ruff format lzw_jax tests benchmarks scripts examples
elif python -c 'import black' >/dev/null 2>&1; then
    exec python -m black lzw_jax tests benchmarks scripts examples
else
    exec python scripts/stylecheck.py lzw_jax tests benchmarks scripts examples
fi
